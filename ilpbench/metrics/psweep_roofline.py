"""100 x the least time of kernel A's sweeps in the traced chunks
(``roofline.py`` at each traced sweep's own schedule and order, against
the card's published peaks), summed, over the device time of the same
sweeps' kernels (rank 0). Nothing when the traced kernels and the traced
sweeps do not pair up one to one."""
from ilpbench.trace import device_us


def read(run):
    t, bound = run["trace"], run["bound"]
    if run["mode"] != "optimize" or not t or not bound:
        return None
    us, count = device_us(t, "psweep_kernel")
    if not count or count != bound["sweeps"]:
        return None
    return 100.0 * bound["ms"] / (us / 1e3)
