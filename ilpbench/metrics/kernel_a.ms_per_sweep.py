"""Device ms of the fused sweep kernel (kernel A) per sweep, in the traced
chunks (rank 0)."""
from ilpbench.trace import device_us


def read(run):
    t = run["trace"]
    if run["mode"] != "optimize" or not t or not t["steps"]:
        return None
    us, count = device_us(t, "psweep_kernel")
    return us / 1e3 / t["steps"] if count else None
