"""Host ms per traced sweep blocked on the sweep's one read from the
device (the program's span `solve.read`, mean)."""
from ilpbench.program_spans import ms_per


def read(run):
    if run["mode"] != "solve" or not run["trace"]:
        return None
    return ms_per("solve.read", "solve.read", "calls")
