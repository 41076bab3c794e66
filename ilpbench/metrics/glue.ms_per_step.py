"""Device ms per step outside kernel A and the collectives, in the traced
chunks (rank 0)."""
from ilpbench.trace import device_us


def read(run):
    t = run["trace"]
    if run["mode"] != "optimize" or not t or not t["launches"] or not t["steps"]:
        return None
    total = sum(t["device_us"].values())
    kernel, _ = device_us(t, "psweep_kernel", "nccl")
    return (total - kernel) / 1e3 / t["steps"]
