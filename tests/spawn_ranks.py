"""Helpers for the multi-process tests and ``chip_smoke.py``: run a
function on N ranks of one host, each a fresh process, and watch the
top-K population exchange.

    results = spawn(fn, 2, args=(...,), device="cpu")

starts N processes (``torch.multiprocessing``, spawn start method), joins
them to one process group through a ``file://`` store in a temporary
directory (no port to collide with), calls ``fn(*args)`` on each and
returns every rank's return value in rank order. A rank that fails
raises here; ranks still running past ``timeout_s`` are killed and
``TimeoutError`` raised, so no rank outlives the call. (Users start
ranks with ``torchrun``.)
"""

from __future__ import annotations

import os
import pickle
import tempfile
import time
from pathlib import Path
from typing import Any, Callable, List, Optional

import numpy as np
import torch
import torch.multiprocessing as mp

from baryonyx_torch.parallel import distributed


def _rank_main(
    rank: int, fn: Callable, args: tuple, nprocs: int, store: str,
    device: Optional[str], backend: Optional[str], threads: int,
    timeout_s: float, out_dir: str,
) -> None:
    if threads:
        torch.set_num_threads(threads)
    distributed.init_distributed(
        f"file://{store}", nprocs, rank, device=device, backend=backend,
        timeout_s=timeout_s,
    )
    try:
        result = fn(*args)
    finally:
        distributed.shutdown()
    with open(Path(out_dir) / f"rank{rank}.pkl", "wb") as fh:
        pickle.dump(result, fh)


def spawn(
    fn: Callable,
    nprocs: int,
    args: tuple = (),
    device: Optional[str] = "cpu",
    backend: Optional[str] = None,
    timeout_s: float = 120.0,
    threads: int = 1,
) -> List[Any]:
    """``fn(*args)`` on ``nprocs`` ranks of one process group on
    ``device`` (the backend as ``init_distributed`` picks it, unless
    named), each with ``threads`` torch threads (0: torch's default);
    every rank's return value, in rank order."""
    with tempfile.TemporaryDirectory() as tmp:
        ctx = mp.start_processes(
            _rank_main,
            args=(fn, args, nprocs, os.path.join(tmp, "store"), device,
                  backend, threads, timeout_s, tmp),
            nprocs=nprocs, join=False, start_method="spawn",
        )
        deadline = time.monotonic() + timeout_s
        try:
            while not ctx.join(timeout=max(deadline - time.monotonic(), 0.1)):
                if time.monotonic() >= deadline:
                    raise TimeoutError(
                        f"spawn: ranks still running after {timeout_s} s"
                    )
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
                    p.join()
        out = []
        for r in range(nprocs):
            with open(Path(tmp) / f"rank{r}.pkl", "rb") as fh:
                out.append(pickle.load(fh))
        return out


def watch_first_exchange() -> dict:
    """Patch this process's ``exchange_top_k`` to note, at its first call,
    this rank's population before it (``before``) and after it
    (``after``), the gathered candidates (``cand``) and their victim slots
    (``victims``), as numpy arrays in the returned dict."""
    from baryonyx_torch.solver import optimize as bopt

    first: dict = {}
    real_exchange, real_insert = bopt.exchange_top_k, bopt.batch_insert

    def insert(pop, cx, cv, cr, mask, victims, *rest):
        first.update(cand=cx.cpu().numpy(), victims=victims.cpu().numpy())
        return real_insert(pop, cx, cv, cr, mask, victims, *rest)

    def exchange(ev, state):
        if first:
            return real_exchange(ev, state)
        bopt.batch_insert = insert
        try:
            out = real_exchange(ev, state)
        finally:
            bopt.batch_insert = real_insert
        first.update(before=state.pop.x.cpu().numpy(), after=out.x.cpu().numpy())
        return out

    bopt.exchange_top_k = exchange
    return first


def exchange_kept(best: np.ndarray, seen: dict) -> bool:
    """Whether the first exchange that ``seen`` watched
    (``watch_first_exchange``) kept ``best``, another rank's best member,
    as the exchange's semantics promise: ``best`` is in the population
    after it, or it was there before (the exchange brought nothing new),
    or every candidate copy of it lost its victim slot to a later
    candidate that now holds it (victims are drawn with replacement, and
    the later candidate takes a shared slot)."""
    after = {r.tobytes() for r in seen["after"]}
    if best.tobytes() in after or any(
        np.array_equal(r, best) for r in seen["before"]
    ):
        return True
    cand, victims = seen["cand"], seen["victims"]
    copies = [c for c, r in enumerate(cand) if np.array_equal(r, best)]
    return bool(copies) and all(
        any(victims[j] == victims[c] and cand[j].tobytes() in after
            for j in range(c + 1, len(cand)))
        for c in copies
    )
