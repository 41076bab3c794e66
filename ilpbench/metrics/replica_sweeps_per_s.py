"""Sum over the ranks of R x sweeps completed inside the window, over the
window's seconds (optimize), on the cells where the host sets the pace."""


def read(run):
    if run["mode"] != "optimize":
        return None
    return run["replicas"] * run["sweeps"] / run["window_s"]
