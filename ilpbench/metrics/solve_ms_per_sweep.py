"""The window's milliseconds over the sweeps its whole solves ran (solve)."""


def read(run):
    if run["mode"] != "solve" or not run["sweeps"]:
        return None
    return 1e3 * run["window_s"] / run["sweeps"]
