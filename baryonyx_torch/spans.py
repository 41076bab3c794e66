"""Spans and counters of the host side, kept in memory.

    with spans.span("entry.compile"):          # set-up: always recorded
        ...
    with spans.loop("optimize.chunk", steps):  # per chunk or sweep: only
        ...                                    # while a torch profiler runs
    spans.add("parallel.bytes", nbytes)        # a count, as a loop span
    spans.snapshot()                           # the totals by name

A span has a name, a start, an end and a parent (the span open around it
on the same thread); its self time is its duration less the time its
recorded children cover. A set-up span costs two clock reads and one read
of the profiler's flag. A loop span or a count costs the flag's read alone
when no profiler runs, and records nothing; a loop span that a session's
start or end cuts in two is left out.

While a ``torch.profiler`` session runs, every recorded span also opens
``torch.profiler.record_function(name)``, so it shows on the profiler's
timeline (``export_chrome_trace``) beside the device's work, and its totals
go to the traced part of ``snapshot()``. The traced part is cleared at the
first span or count of a session that follows a span or count seen with no
profiler running, so it holds the latest session.

No span sits inside an evolution step, the general sweep's row-block loop
or a kernel: a chunk's or a sweep's total divided by its steps is the
resolution.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional

import torch

_profiler_enabled = torch.autograd._profiler_enabled


class _Totals:
    """Calls, total and self nanoseconds, summed counts and the first
    call's nanoseconds of one name."""

    __slots__ = ("calls", "total_ns", "self_ns", "n", "first_ns")

    def __init__(self) -> None:
        self.calls = self.total_ns = self.self_ns = self.n = self.first_ns = 0

    def as_dict(self) -> dict:
        return {"calls": self.calls, "total_s": self.total_ns / 1e9,
                "self_s": self.self_ns / 1e9, "n": self.n, "first_s": self.first_ns / 1e9}


class _Recorder:
    """The process's totals (traced and the rest) and each thread's stack
    of open spans."""

    def __init__(self) -> None:
        self.lock = threading.Lock()
        self.local = threading.local()
        self.traced: Dict[str, _Totals] = {}
        self.rest: Dict[str, _Totals] = {}
        self.was_on = False

    def on(self) -> bool:
        """Whether a profiler runs; clears the traced totals when one has
        started since the last look."""
        on = _profiler_enabled()
        if on != self.was_on:
            with self.lock:
                if on and not self.was_on:
                    self.traced.clear()
                self.was_on = on
        return on

    def stack(self) -> List["span"]:
        st = getattr(self.local, "stack", None)
        if st is None:
            st = self.local.stack = []
        return st

    def record(self, name: str, traced: bool, total_ns: int, self_ns: int, n: int) -> None:
        with self.lock:
            table = self.traced if traced else self.rest
            t = table.get(name)
            if t is None:
                t = table[name] = _Totals()
                t.first_ns = total_ns
            t.calls += 1
            t.total_ns += total_ns
            t.self_ns += self_ns
            t.n += n


_REC = _Recorder()


class span:
    """A set-up span: recorded on every call."""

    __slots__ = ("name", "n", "t0", "child_ns", "traced", "rf")
    whole_session = False  # True: recorded only if a profiler runs at both ends

    def __init__(self, name: str, n: int = 0) -> None:
        self.name, self.n = name, n
        self.t0: Optional[int] = None

    def _open(self, on: bool) -> None:
        self.traced = on
        self.child_ns = 0
        self.rf = None
        if on:
            self.rf = torch.profiler.record_function(self.name)
            self.rf.__enter__()
        _REC.stack().append(self)
        self.t0 = time.perf_counter_ns()

    def close(self) -> None:
        """End the span now (a second close, or the ``with`` block's end
        after it, does nothing)."""
        if self.t0 is None:
            return
        dur = time.perf_counter_ns() - self.t0
        self.t0 = None
        st = _REC.stack()
        if st and st[-1] is self:
            st.pop()
        if self.rf is not None:
            self.rf.__exit__(None, None, None)
        if self.whole_session and not _REC.on():
            return
        if st:
            st[-1].child_ns += dur
        _REC.record(self.name, self.traced, dur, dur - self.child_ns, self.n)

    def __enter__(self) -> "span":
        self._open(_REC.on())
        return self

    def __exit__(self, *exc) -> None:
        self.close()


class loop(span):
    """A loop span (per chunk, sweep or collective): recorded only while a
    torch profiler runs, at its start and at its end. ``n`` is summed with
    the span's totals (a chunk's steps)."""

    __slots__ = ()
    whole_session = True

    def __enter__(self) -> "loop":
        if _REC.on():
            self._open(True)
        return self


def add(name: str, n: int) -> None:
    """Count ``n`` under ``name``, while a torch profiler runs."""
    if _REC.on():
        _REC.record(name, True, 0, 0, n)


def end(name: str) -> None:
    """End the innermost open span of this thread if it is named ``name``
    (a span that starts in one function and ends in another: the entry's
    set-up, which ends where the budget clock starts)."""
    st = _REC.stack()
    if st and st[-1].name == name:
        st[-1].close()


def snapshot() -> dict:
    """``{"traced": {name: totals}, "rest": {name: totals}, "launches":
    {kernel: launches}}``; totals are ``{"calls", "total_s", "self_s",
    "n", "first_s"}`` (``first_s``: the first call's seconds).
    ``traced`` holds what the latest profiler session recorded, ``rest``
    what was recorded with no profiler running; ``launches`` are the two
    CUDA kernels' own launch counters."""
    from baryonyx_torch.ops import psweep as pw
    from baryonyx_torch.ops import zsweep as zs

    with _REC.lock:
        out = {part: {k: v.as_dict() for k, v in table.items()}
               for part, table in (("traced", _REC.traced), ("rest", _REC.rest))}
    out["launches"] = {"psweep": pw.psweep_kernel.launches,
                       "dpselect": zs.dp_select_kernel.launches}
    return out


def reset() -> None:
    """Forget every total and this thread's open spans."""
    with _REC.lock:
        _REC.traced.clear()
        _REC.rest.clear()
        _REC.was_on = False
    _REC.stack().clear()
