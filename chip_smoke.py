#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N]

Run from the root of a checkout. It builds the port's CUDA kernels from
baryonyx_torch/csrc, then:

  0. prints the card's name and power limit, and turns TF32 off;
  1. holds the fused-sweep kernel against its plain PyTorch version on the
     card, 3 sweeps each from one state, on scp200x1000 (at the replica
     batch and row block the optimizer picks) and on the scpnre class
     (random_set_cover_lp(500, 5000, 0.1, seed=7)): x and remaining
     bit-exact, P and pi within atol 2e-4, S within atol 2e-3. The chain
     starts from x = 0 with half the lanes pushing (every row scheduled,
     as the optimizer's push phase does), so the first sweep schedules
     every (row, replica) pair; it fails unless most pairs are scheduled
     and most end with a moved P;
  2. drives the main path — baryonyx_torch.optimize on scp200x1000
     through make_problem and parse_lp, for 10 s — with the launch counters
     set to 0 just before and read just after, and validates the solution;
     then optimize on the scpnre class for a few seconds. Both runs keep
     copies of the inputs of some of their sweeps;
  3. at those main-path sweep inputs, holds the kernel against its plain
     version once more and times both with CUDA events; the bound counts
     the bytes that state needs (the scheduled pairs' P, pi, S and x);
  4. prints one JSON line with every kernel's numbers, then the last
     line {"ok": true, "device": {...}}.

Any failure exits nonzero before the last line. Without a CUDA device, or
outside a checkout, it exits nonzero and prints no result.
"""

from __future__ import annotations

import argparse
import collections
import io
import json
import subprocess
import sys
import time
from pathlib import Path

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate
F32_OPS_PER_S = 67e12  # H100 SXM float32 outside the tensor cores
SWEEPS = 3
TIME_LIMIT_S = 10.0  # the optimize budget of the main-path run
NRE_TIME_LIMIT_S = 6.0  # the optimize budget of the scpnre run
KERNELS = ["psweep"]
TOL = {"P": 2e-4, "pi": 2e-4, "S": 2e-3}


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=1)
    args = ap.parse_args()

    repo = Path(__file__).resolve().parent
    if not (repo / "baryonyx_torch" / "csrc").is_dir():
        print("chip_smoke: run from a checkout (baryonyx_torch/ missing)",
              file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(repo))

    # ---- phase 0: device
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"allow_tf32: matmul={torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn={torch.backends.cudnn.allow_tf32}")
    print(f"python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}")

    from baryonyx_torch import kernels

    t = time.monotonic()
    logs = kernels.build(KERNELS)
    print(f"build: {time.monotonic() - t:.1f} s")
    for name in KERNELS:
        log = logs.get(name)
        if log is None:
            log = kernels.library_path(name).with_suffix(".log").read_text()
        for line in dict.fromkeys(log.splitlines()):
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")

    import numpy as np

    import baryonyx_torch as bt
    from baryonyx_torch.generators import random_set_cover_lp
    from baryonyx_torch.ops import psweep as pw
    from baryonyx_torch.ops.layout import compile_problem
    from baryonyx_torch.ops.sweep import violated_mask
    from baryonyx_torch.preprocess.merge import make_merged_constraints
    from baryonyx_torch.solver import common
    from baryonyx_torch.solver.api import _prepare
    from baryonyx_torch.solver.optimize import replica_batch

    dev = torch.device("cuda", 0)

    def compiled(lp: str):
        ctx = bt.make_context(0)
        ctx.parameters = ctx.parameters.validated()
        pb = _prepare(ctx, bt.parse_lp(lp))
        cp = compile_problem(
            make_merged_constraints(ctx, pb), len(pb.vars.values), device=dev
        )
        R, B = replica_batch(ctx, cp, ctx.parameters, dev)
        return cp, R, B

    def compare(a, b):
        """x and remaining mismatch counts and the P/pi/S max |err| of two
        sweep results (x, P, pi, S, ..., remaining)."""
        errs = {k: float((u - v).abs().max())
                for k, u, v in zip(("P", "pi", "S"), a[1:4], b[1:4])}
        return int((a[0] != b[0]).sum()), int((a[-1] != b[-1]).sum()), errs

    def check(label, a, b):
        x_mis, rem_mis, errs = compare(a, b)
        print(f"[{label}] x mismatches {x_mis}, remaining mismatches "
              f"{rem_mis}, max|err| {errs}")
        if x_mis or rem_mis:
            fail(f"{label}: kernel x/remaining differ from the plain version")
        if any(errs[k] > TOL[k] for k in TOL):
            fail(f"{label}: kernel P/pi/S outside tolerance: {errs}")
        return max(errs.values())

    def run_chain(fn, cp, R, B, cost, push):
        """SWEEPS sweeps from x = 0; push lanes schedule every row, the
        others their violated rows; the order puts the scheduled rows
        first, as the optimizer's step does."""
        x = torch.zeros((cp.n, R), dtype=torch.int32, device=dev)
        P = torch.zeros((cp.m, cp.Kr, R), device=dev)
        pi = torch.zeros((cp.m, R), device=dev)
        S = None
        sched = violated_mask(cp, x) | push
        shares = []
        for it in range(SWEEPS):
            shares.append(float(sched[:cp.m_real].float().mean()))
            any_row = sched.any(dim=1)
            order = torch.argsort((~any_row).to(torch.int8), stable=True)
            seed = torch.tensor([1000 + it, -77 * it], dtype=torch.int32,
                                device=dev)
            x, P, pi, S, viol, rem = fn(
                cp, x, P, pi, cost, sched, order.to(torch.int32),
                torch.full((R,), 0.15, device=dev), 0.01, 0.5, seed,
                torch.zeros(R, device=dev), n_rows=any_row.sum(),
                minimize=True, block_size=B, S=S, S_fresh=it != 0,
            )
            sched = viol | push
        torch.cuda.synchronize()
        return (x, P, pi, S, rem), shares

    class Capture:
        """Wraps psweep for an optimize run: keeps copies of the inputs of
        every ``every``-th sweep (the last ``keep`` of them)."""

        def __init__(self, every: int, keep: int):
            self.every = every
            self.states = collections.deque(maxlen=keep)
            self.calls = 0
            self.real = pw.psweep

        def __call__(self, *a, **kw):
            self.calls += 1
            if self.calls % self.every == 0:
                self.states.append(cloned((a, kw)))
            return self.real(*a, **kw)

    def cloned(state):
        a, kw = state
        c = lambda v: v.clone() if isinstance(v, torch.Tensor) else v  # noqa: E731
        return tuple(c(v) for v in a), {k: c(v) for k, v in kw.items()}

    def run_optimize(lp: str, limit: float, every: int, keep: int):
        ctx = bt.make_context(4)
        ctx.parameters.seed = args.seed
        ctx.parameters.time_limit = limit
        last = {}

        def on_update(remaining, value, loop, elapsed, restarts):
            last.update(loop=loop, elapsed=elapsed, value=value)

        ctx.register(update=on_update)
        raw = bt.make_problem(ctx, io.StringIO(lp))
        cap = Capture(every, keep)
        pw.psweep = cap
        try:
            pw.psweep_kernel.launches = 0
            result = bt.optimize(ctx, raw)
            torch.cuda.synchronize()
            launches = pw.psweep_kernel.launches
        finally:
            pw.psweep = cap.real
        rate = result.replicas * last["loop"] / last["elapsed"]
        return raw, result, launches, rate, list(cap.states)

    def prepared(state):
        a, kw = cloned(state)
        return pw._prepare(
            *a, kw.get("n_rows"), kw.get("minimize", True),
            kw.get("block_size", 8), kw.get("quad_mat"), kw.get("S"),
            kw.get("S_fresh"),
        )

    def bound(cp, inp):
        """Least time of one sweep at this state: the bytes it needs —
        sched of the rows it walks; for each scheduled (row, replica)
        pair its P row and pi read and written; S read and written and x
        written once for each (variable, replica) a scheduled pair
        touches; the row tables, costs and per-replica vectors — over the
        memory rate; or its operations over the float32 rate. Per
        scheduled slot the sweep needs: the reduced cost 6, the splitmix
        hash 13, the tie noise 7, the count of keys <= 0 2, the J_bot +
        J_top order statistics and the two keys nearest 0 2 each, and
        phase B's threshold test, P, S and x updates 7."""
        R = inp.S.shape[1]
        order = inp.order[: int(inp.n_rows)].long()
        rows = order[order < cp.m]
        L = rows.numel()
        sch = inp.sched[rows].float()  # [L, R]
        rsz = cp.r_size[rows].long()
        live = torch.arange(cp.Kr, device=dev)[None, :] < rsz[:, None]
        inc = torch.zeros((L, cp.n + 1), device=dev)
        inc.scatter_(1, torch.where(live, cp.row_vars[rows].long(), cp.n), 1.0)
        touched = int(((inc[:, : cp.n].T @ sch) > 0).sum())
        slots = float((rsz.float()[:, None] * sch).sum())
        pairs = float(sch.sum())
        nbytes = (
            L * R  # sched
            + 8 * slots  # P read + written
            + 8 * pairs  # pi read + written
            + 12 * touched  # S read + written, x written
            + 4 * int(rsz.sum()) + 20 * L + 4 * cp.n + 16 * R  # tables
        )
        ops = (6 + 13 + 7 + 2 + 2 * (cp.J_bot + cp.J_top + 2) + 7) * slots
        t_b = nbytes / HBM_BYTES_PER_S * 1e3
        t_o = ops / F32_OPS_PER_S * 1e3
        share = pairs / max(1, cp.m_real * R)
        return (t_b, "bytes", share) if t_b >= t_o else (t_o, "operations", share)

    def timed(fn, inp, n):
        fn(inp)  # warm-up
        torch.cuda.synchronize()
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        for _ in range(n):
            fn(inp)
        t1.record()
        torch.cuda.synchronize()
        return t0.elapsed_time(t1) / n

    # ---- phase 1: kernel vs plain version on the card, from x = 0
    instances = {
        "scp200x1000": random_set_cover_lp(200, 1000, 0.02, seed=41),
        "scpnre500x5000": random_set_cover_lp(500, 5000, 0.1, seed=7),
    }
    max_err = 0.0
    mismatches = 0
    for name, lp in instances.items():
        t = time.monotonic()
        cp, R, B = compiled(lp)
        n = cp.n
        rng = np.random.default_rng(args.seed)
        push = torch.as_tensor(rng.random(R) < 0.5, device=dev)[None, :]
        cost = torch.as_tensor(
            1.0 + np.arange(n) + 0.01 * ((np.arange(n) * 37) % 61),
            dtype=torch.float32, device=dev,
        )
        print(f"[{name}] m={cp.m} n={cp.n} Kr={cp.Kr} J=({cp.J_bot},"
              f"{cp.J_top}) R={R} B={B} setup {time.monotonic() - t:.1f} s")
        a, shares = run_chain(pw.psweep_reference, cp, R, B, cost, push)
        b, _ = run_chain(pw.psweep, cp, R, B, cost, push)
        moved = float((b[1][: cp.m_real] != 0).any(dim=1).float().mean())
        print(f"[{name}] scheduled share per sweep {shares}, pairs with a "
              f"moved P {moved:.4f}, min remaining {int(b[4].min())}")
        if shares[0] < 0.5 or moved < 0.5:
            fail(f"{name}: the chain schedules too little to check phase B")
        max_err = max(max_err, check(f"{name} chain", a, b))

        # informational: the normalized (tie-heavy) costs the solver uses
        cn = common.normalize_costs(
            (1.0 + (np.arange(n) % 100)).astype(np.float64),
            bt.CostNormType.loo, np.random.default_rng(0),
        )
        cn_t = torch.as_tensor(cn, dtype=torch.float32, device=dev)
        a2, _ = run_chain(pw.psweep_reference, cp, R, B, cn_t, push)
        b2, _ = run_chain(pw.psweep, cp, R, B, cn_t, push)
        print(f"[{name}] normalized costs: x mismatches "
              f"{int((a2[0] != b2[0]).sum())} of {a2[0].numel()}")
        del a, b, a2, b2, cp
        torch.cuda.empty_cache()

    # ---- phase 2: the main path, then optimize on the scpnre class
    raw, result, launches, rate, main_states = run_optimize(
        instances["scp200x1000"], TIME_LIMIT_S, every=256, keep=8
    )
    valid = bt.is_valid_solution(raw, result)
    print(f"[optimize scp200x1000] status {result.status.name} objective "
          f"{result.value} sweeps {result.loop} R {result.replicas} "
          f"B {result.block_size} replica-sweeps/s {rate:.1f} "
          f"psweep.launches {launches} valid {valid} "
          f"duration {result.duration:.2f} s")
    if result.status != bt.ResultStatus.success or not valid:
        fail("optimize did not return a valid feasible solution")
    if not np.isfinite(result.value):
        fail("optimize returned a non-finite objective")
    if launches <= 0 or launches != result.loop:
        fail(f"psweep launches {launches} vs sweeps {result.loop}")
    optimize_rec = {"objective": result.value, "sweeps": result.loop,
                    "R": result.replicas, "B": result.block_size,
                    "replica_sweeps_per_s": rate}

    raw2, res2, launches2, rate2, nre_states = run_optimize(
        instances["scpnre500x5000"], NRE_TIME_LIMIT_S, every=4, keep=3
    )
    print(f"[optimize scpnre500x5000] status {res2.status.name} objective "
          f"{res2.value} sweeps {res2.loop} R {res2.replicas} "
          f"B {res2.block_size} replica-sweeps/s {rate2:.1f} "
          f"psweep.launches {launches2} valid "
          f"{bt.is_valid_solution(raw2, res2)}")
    del raw2, res2

    # ---- phase 3: kernel vs plain version at the main paths' states
    per_instance = []
    for name, states, reps in (("scp200x1000", main_states, 50),
                               ("scpnre500x5000", nre_states, 5)):
        if not states:
            fail(f"{name}: optimize ran too few sweeps to keep a state")
        recs = []
        for i, st in enumerate(states):
            a = pw.psweep_reference(*cloned(st)[0], **cloned(st)[1])
            b = pw.psweep(*cloned(st)[0], **cloned(st)[1])
            max_err = max(max_err, check(f"{name} state {i}", a, b))
            mismatches += compare(a, b)[0]
            del a, b
            cp = st[0][0]
            inp = prepared(st)
            b_ms, b_by, share = bound(cp, inp)
            recs.append(dict(
                ms=timed(pw.psweep_kernel, inp, reps),
                plain_ms=timed(pw._sweep_plain, prepared(st), 1),
                bound_ms=b_ms, bound_by=b_by, sched_share=share,
                n_rows=int(inp.n_rows),
            ))
            print(f"[{name} state {i}] scheduled share {share:.4f} rows "
                  f"{recs[-1]['n_rows']}: kernel {recs[-1]['ms']:.4f} ms, "
                  f"plain {recs[-1]['plain_ms']:.4f} ms, bound "
                  f"{b_ms:.5f} ms ({b_by})")
            del inp
        mean = {k: sum(r[k] for r in recs) / len(recs)
                for k in ("ms", "plain_ms", "bound_ms", "sched_share")}
        by = collections.Counter(r["bound_by"] for r in recs).most_common(1)
        per_instance.append(dict(
            instance=name, R=st[0][3].shape[-1], B=st[1]["block_size"],
            m=cp.m, n=cp.n, Kr=cp.Kr,
            states=len(recs), bound_by=by[0][0], **mean,
        ))
        print(f"[{name}] mean over {len(recs)} states: kernel "
              f"{mean['ms']:.4f} ms/sweep, plain {mean['plain_ms']:.4f} "
              f"ms/sweep, bound {mean['bound_ms']:.5f} ms, scheduled share "
              f"{mean['sched_share']:.4f}")
        del states[:]
        torch.cuda.empty_cache()

    # ---- phase 4: the kernels line, then the result line
    main = per_instance[0]
    print(json.dumps({"kernels": [{
        "name": "psweep",
        "route": "cuda",
        "source": "baryonyx_torch/csrc/psweep.cu",
        "replaces": "JAX package ops/psweep.py:225 (_make_kernel)",
        "launches": launches,
        "max_abs_err": max_err,
        "mismatches": mismatches,
        "ms": main["ms"],
        "plain_ms": main["plain_ms"],
        "bound_ms": main["bound_ms"],
        "bound_by": main["bound_by"],
        "library_ms": None,
        "instances": per_instance,
        "optimize": optimize_rec,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
