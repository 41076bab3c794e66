"""torch.profiler over whole chunks of a run, reduced to what the
per-layer metrics read: the device's busy seconds (the union of its
operations' intervals), device time and count by kernel name, the
launches, and the longest idle gaps by what the host was doing then.

The arithmetic follows the program's ``step_profile.py``, with busy time
and wall read from one traced window."""

from __future__ import annotations

import bisect
import time
from collections import defaultdict
from typing import Dict, List, Tuple

import torch

TOP = 10
NAME_CHARS = 160  # a kernel's name is cut to this many characters in the breakdown


class Profiler:
    def __init__(self):
        self.prof = torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU,
                        torch.profiler.ProfilerActivity.CUDA],
        )
        self.running = False
        self.start_cost_s = 0.0

    def start(self):
        t = time.monotonic()
        self.prof.start()
        self.start_cost_s = time.monotonic() - t
        self.running = True

    def stop(self):
        self.prof.stop()
        self.running = False

    def summary(self, window_s: float, steps: int) -> dict:
        """The traced window's numbers; ``window_s``: its wall on the
        host's clock (the profiler's own start left out), ``steps``: the
        steps or sweeps it held."""
        dev: List[Tuple[float, float, str]] = []
        host: List[Tuple[float, float, str]] = []
        for e in self.prof.events():
            tr = e.time_range
            if getattr(e, "is_user_annotation", False):
                continue  # a range drawn over device work (nccl:all_reduce), not an operation
            if e.device_type == torch.autograd.DeviceType.CUDA:
                dev.append((tr.start, tr.end, e.name))
            elif tr.end > tr.start:
                host.append((tr.start, tr.end, e.name))
        return reduce(dev, host, window_s, steps)


def reduce(dev, host, window_s: float, steps: int) -> dict:
    """``dev``, ``host``: (start us, end us, name) of each device
    operation and host event."""
    by_name: Dict[str, List[float]] = defaultdict(lambda: [0.0, 0])
    for a, b, name in dev:
        by_name[name][0] += b - a
        by_name[name][1] += 1
    busy, gaps = 0.0, []
    end = None
    for a, b, _ in sorted(dev):
        if end is None or a > end:
            if end is not None:
                gaps.append((a - end, end, a))
            busy += b - a
            end = b
        elif b > end:
            busy += b - end
            end = b
    host.sort()
    starts = [h[0] for h in host]
    idle = defaultdict(float)
    for length, a, b in sorted(gaps, reverse=True)[:200]:
        idle[_doing(host, starts, (a + b) / 2)] += length / 1e6
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])
    return {
        "window_s": window_s,
        "busy_s": busy / 1e6,
        "steps": steps,
        "launches": len(dev),
        "device_us": {k: v[0] for k, v in by_name.items()},
        "device_count": {k: v[1] for k, v in by_name.items()},
        "device_ops": [[k[:NAME_CHARS], v[0] / 1e6] for k, v in top[:TOP]],
        "idle_gaps": sorted(([k, v] for k, v in idle.items()), key=lambda kv: -kv[1])[:TOP],
    }


def _doing(host, starts, t: float, look: int = 4000) -> str:
    """The innermost host event running at ``t`` (the latest started of
    those that cover it, among the ``look`` started last before it)."""
    i = bisect.bisect_right(starts, t)
    for a, b, name in reversed(host[max(0, i - look):i]):
        if b >= t:
            return name
    return "(host between operations)"


def device_us(summary: dict, *needles: str) -> Tuple[float, int]:
    """Device us and count of the operations whose name holds any of
    ``needles``."""
    us, count = 0.0, 0
    for name, v in summary["device_us"].items():
        if any(s in name for s in needles):
            us += v
            count += summary["device_count"][name]
    return us, count
