"""100 x (1 - device busy / wall) over the traced chunks, busy averaged
over the ranks."""


def read(run):
    t = run["trace"]
    if run["mode"] != "optimize" or not t or not t["launches"] or t["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
