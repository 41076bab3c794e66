"""Host ms per step blocked on the traced chunk's one fetch from the
device (the program's span `optimize.fetch` over the steps of
`optimize.chunk`), rank 0."""
from ilpbench.program_spans import ms_per


def read(run):
    if run["mode"] != "optimize" or not run["trace"]:
        return None
    return ms_per("optimize.fetch", "optimize.chunk", "n")
