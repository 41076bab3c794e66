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


def estimated_peak_bytes(cp, R: int, itemsize: int = 4) -> int:
    """Execution-peak estimate for the optimize state: the carried
    ReplicaState plus the sweep's dominant transients (the [m, Kr, R]
    column-sum contributions and the sweep's keys scratch), each live
    beside a second copy of the state."""
    transient = 2 * (cp.m * cp.Kr + cp.n * cp.Kc) * R * itemsize
    return replica_state_bytes(cp, R, itemsize) * 2 + transient
