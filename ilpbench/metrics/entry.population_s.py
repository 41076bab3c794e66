"""Seconds per call of the program's span `entry.population`: the
starting point(s) (optimize: the initial population; solve: the initial x),
rank 0."""
from ilpbench.program_spans import mean_s


def read(run):
    return mean_s("entry.population")
