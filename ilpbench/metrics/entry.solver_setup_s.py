"""From the ``optimize`` / ``solve`` call to the budget clock's start
(optimize: the first progress callback's time less its elapsed seconds) or
to the first sweep (solve: the first timed solve)."""


def read(run):
    return run["solver_setup_s"]
