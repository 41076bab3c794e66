"""Device operations per sweep in the traced sweeps of a solve."""


def read(run):
    t = run["trace"]
    if run["mode"] != "solve" or not t or not t["launches"] or not t["steps"]:
        return None
    return t["launches"] / t["steps"]
