"""Host ms per traced chunk in the fleet's per-chunk all-gather of the
host loop's stats, where rank 0 waits for the slowest rank (the program's
span `optimize.fleet`, mean)."""
from ilpbench.program_spans import ms_per


def read(run):
    if run["mode"] != "optimize" or not run["trace"]:
        return None
    return ms_per("optimize.fleet", "optimize.fleet", "calls")
