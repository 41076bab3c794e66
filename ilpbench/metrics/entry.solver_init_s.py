"""Seconds per call of the program's span `entry.solver_init`: the
`optimize` or `solve` call up to the start of its budget's clock, rank 0."""
from ilpbench.program_spans import mean_s


def read(run):
    return mean_s("entry.solver_init")
