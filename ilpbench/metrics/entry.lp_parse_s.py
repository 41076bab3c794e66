"""Seconds per call of the program's span `entry.parse` (`make_problem`:
LP text to the raw problem), rank 0."""
from ilpbench.program_spans import mean_s


def read(run):
    return mean_s("entry.parse")
