"""Bytes rank 0 passes to the collectives per traced chunk (the program's
count `parallel.bytes` over the calls of `optimize.chunk`)."""
from ilpbench.program_spans import traced


def read(run):
    if run["mode"] != "optimize" or not run["trace"]:
        return None
    b, c = traced("parallel.bytes"), traced("optimize.chunk")
    if b is None or c is None or not c["calls"]:
        return None
    return b["n"] / c["calls"]
