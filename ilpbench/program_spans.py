"""The program's own spans and counts (``baryonyx_torch.spans``), as the
metric readers see them in rank 0's process after its run: a set-up span as
its mean over the calls made with no profiler running, after the first (the
one call of an optimize cell; a solve cell's timed solves, with the warm-up
solve, which pays the process's first work on the card, left out, and any
solve that started under the profiler, which slows every operation), a loop
span or count from the latest profiler session (the traced chunk, or the
traced sweeps).
Each function returns None where the program recorded nothing under the
name, or has no spans at all."""

from __future__ import annotations

from typing import Optional


def snapshot() -> Optional[dict]:
    try:
        from baryonyx_torch import spans
    except ImportError:
        return None
    return spans.snapshot()


def mean_s(name: str) -> Optional[float]:
    """Seconds per call of a set-up span with no profiler running, the
    process's first call left out where there were more."""
    snap = snapshot()
    t = None if snap is None else snap["rest"].get(name)
    if t is None:
        return None
    if t["calls"] == 1:
        return t["total_s"]
    return (t["total_s"] - t["first_s"]) / (t["calls"] - 1)


def traced(name: str) -> Optional[dict]:
    """The latest profiler session's totals of a loop span or count:
    ``{"calls", "total_s", "self_s", "n"}``."""
    snap = snapshot()
    return None if snap is None else snap["traced"].get(name)


def ms_per(name: str, per: str, key: str) -> Optional[float]:
    """Traced milliseconds of ``name`` over ``key`` (``"calls"`` or
    ``"n"``) of the traced span ``per``."""
    t, p = traced(name), traced(per)
    if t is None or p is None or not p[key]:
        return None
    return 1e3 * t["total_s"] / p[key]
