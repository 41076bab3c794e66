"""Device operations per step in the traced chunks (rank 0)."""


def read(run):
    t = run["trace"]
    if run["mode"] != "optimize" or not t or not t["launches"] or not t["steps"]:
        return None
    return t["launches"] / t["steps"]
