"""100 x (objective of the best feasible solution at the window's end - the
reference's Lagrangian lower bound) / |bound| (optimize; nothing when the
run found no feasible solution)."""


def read(run):
    if run["mode"] != "optimize" or run["objective"] is None or run["lb"] is None:
        return None
    return 100.0 * (run["objective"] - run["lb"]) / abs(run["lb"])
