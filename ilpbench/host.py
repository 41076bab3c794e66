"""The host around a run: each rank keeps to cores of its own, and times a
fixed piece of pure-Python work right after its window (``probe_ms``), a
reading of the host's single-thread speed then, so that a run that reads
slow can be told apart from a slow host."""

from __future__ import annotations

import os
import time
from typing import Dict, List, Sequence

CORES_PER_RANK = 2  # the torch threads of a rank, each on a core of its own
PROBE_N = 300_000


def cores_for(rank: int, world: int, cores: Sequence[int]) -> List[int]:
    """The cores rank ``rank`` of ``world`` keeps to: a fixed slice of
    ``cores`` counted from the end (core 0 takes most interrupts)."""
    cores = sorted(cores)
    k = max(1, min(CORES_PER_RANK, len(cores) // world))
    end = len(cores) - rank * k
    return cores[max(0, end - k):end] or cores[-1:]


def pin(rank: int, world: int, cores: Sequence[int]) -> List[int]:
    """Keep this process, and the threads it starts from now on, to its
    cores."""
    mine = cores_for(rank, world, cores)
    if hasattr(os, "sched_setaffinity"):
        os.sched_setaffinity(0, mine)
    return mine


def all_cores() -> List[int]:
    return sorted(os.sched_getaffinity(0)) if hasattr(os, "sched_getaffinity") else [0]


def report() -> Dict[str, object]:
    """This process's cores and the probe's time, taken now."""
    t = time.perf_counter()
    acc = 0
    for i in range(PROBE_N):
        acc += i * i % 7
    return {"cores": all_cores(), "probe_ms": (time.perf_counter() - t) * 1e3}
