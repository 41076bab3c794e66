"""Seconds per call of the program's span `entry.compile`
(`compile_problem`: the row tables to the device), rank 0."""
from ilpbench.program_spans import mean_s


def read(run):
    return mean_s("entry.compile")
