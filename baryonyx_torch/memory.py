"""Device-memory estimate for the optimize state.

Sizes the replica batch before any state is allocated (reference: the
host-struct byte accounting of lib/src/memory.hpp:42-86, here applied to
the padded device layout).
"""

from __future__ import annotations


def replica_state_bytes(cp, R: int, itemsize: int = 4) -> int:
    """Solver state for R replicas: x, P, pi, S, plus the bool viol mask
    (see solver/optimize.py ReplicaState)."""
    return (cp.n + cp.m * cp.Kr + cp.m + cp.n) * R * itemsize + cp.m * R


def estimated_peak_bytes(
    cp, R: int, itemsize: int = 4, B: int = 8, general_sweep: bool = False
) -> int:
    """Execution-peak estimate for the optimize state: the carried
    ReplicaState plus the sweep's dominant transients (the [m, Kr, R]
    column-sum contributions and the sweep's keys scratch), each live
    beside a second copy of the state. On Z instances add the Z sweep's
    per-block transients at block size B (ops/zsweep.py): the DP kernel's
    scratch (the f table and the ceil(Kr/32) mask words; only its
    device_table variant allocates it, so this is an upper bound), the
    enumeration
    scores and their masked copy [B, Amax, R], and the [B, Kr, R] reduced
    costs and chosen sets. With ``general_sweep`` (ops/sweep.py:sweep
    instead of the fused kernel) add its per-block transients: about a
    dozen [B, Kr, R] tensors alive at once (the gathered sums, costs,
    keys, their sorted copy or order statistics, the new P, the S update
    and the int64 x encoding) and the [n + 1, R] scatter buffers (the
    extended S and the int64 priorities)."""
    transient = 2 * (cp.m * cp.Kr + cp.n * cp.Kc) * R * itemsize
    if cp.has_z:
        nw = (cp.Kr + 31) // 32
        transient += (
            B * cp.Wdp * (1 + nw) + 2 * B * cp.Amax + 2 * B * cp.Kr
        ) * R * itemsize
    if general_sweep:
        transient += 12 * B * cp.Kr * R * max(itemsize, 8)
        transient += (cp.n + 1) * R * (itemsize + 8)
    return replica_state_bytes(cp, R, itemsize) * 2 + transient
