"""Host ms per traced sweep spent in the general sweep's enqueue (the
program's span `solve.sweep`, mean)."""
from ilpbench.program_spans import ms_per


def read(run):
    if run["mode"] != "solve" or not run["trace"]:
        return None
    return ms_per("solve.sweep", "solve.sweep", "calls")
