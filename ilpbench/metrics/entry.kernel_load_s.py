"""Seconds per call of the program's span `entry.kernel_load`: the CUDA
kernel's build (cold) or load (warm) before the budget's clock starts, rank
0; nothing where no kernel is loaded (solve on 0/1 rows, the CPU)."""
from ilpbench.program_spans import mean_s


def read(run):
    return mean_s("entry.kernel_load")
