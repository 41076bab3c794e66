"""From the process's start to the window's opening, on rank 0's clock."""


def read(run):
    return run["setup_s"]
