"""Share of the traced chunk's evolution steps replayed from the step's
CUDA graphs (the program's count `optimize.graphed_steps` over the steps of
`optimize.chunk`), rank 0. None where the program keeps no such count."""
from ilpbench.program_spans import traced


def read(run):
    if run["mode"] != "optimize" or not run["trace"]:
        return None
    g, c = traced("optimize.graphed_steps"), traced("optimize.chunk")
    if g is None or c is None or not c["n"]:
        return None
    return g["n"] / c["n"]
