"""Host ms per step spent enqueueing the traced chunk's evolution steps
(the program's span `optimize.enqueue` over the steps of `optimize.chunk`),
rank 0."""
from ilpbench.program_spans import ms_per


def read(run):
    if run["mode"] != "optimize" or not run["trace"]:
        return None
    return ms_per("optimize.enqueue", "optimize.chunk", "n")
