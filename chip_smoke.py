#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N]

Run from the root of a checkout. It builds the port's CUDA kernels from
baryonyx_torch/csrc, then:

  0. prints the card's name and power limit, turns TF32 off, and prints
     what the compiler reports for every kernel (registers, static shared
     memory, spills);
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
     copies of the inputs of some of their sweeps (the main path's last
     ones, the scpnre run's first ones);
  3. at those main-path sweep inputs, holds the kernel against its plain
     version once more and times it (its launches captured into one CUDA
     graph, so the host's time to enqueue them is not in the number), in
     turns with the first design (the replica_thread variant) and, where
     the plan keeps S resident in shared memory, with the same plan
     without that; the plain version is timed with CUDA events; each
     state's time is printed beside its scheduled share; the bound counts
     the bytes that state needs (the scheduled pairs' P, pi, S and x). It
     prints each instance's launch plan and fails if one takes the
     replica_thread variant;
  4. holds the knapsack DP kernel (csrc/dpselect.cu) against its plain
     PyTorch version, bit for bit, at random reduced costs (R = 512, both
     objectives) on the DP rows of zknap200x1000
     (random_z_multiknapsack_lp(200, 1000, seed=2), table width 88) and of
     a wide-table instance (random_z_multiknapsack_lp(64, 400,
     row_len=(13, 24), coeff_range=(1, 150), seed=3), width 2048), and
     times both, and the first design (the device_table variant) in turns
     with the kernel; prints each table's launch plan and fails if one
     takes the device_table variant;
  5. drives the Z path — baryonyx_torch.optimize on zknap200x1000 through
     make_problem, for 10 s — with the launch counters set to 0 just
     before and read just after: the solution must be valid, and the DP
     launches must equal the blocks the sweeps processed; the run keeps
     copies of the DP inputs of some sweeps;
  6. at those inputs, holds the DP kernel against its plain version again
     and times both and the first design; the bound is the larger of the
     bytes the selection
     needs over the memory rate and its operations over the float32 rate;
  7. holds the DP kernel against its plain version at one replica, the
     shape solve mode gives it (both Z instances, both objectives, bit for
     bit), prints its launch plan there and times it;
  8. runs the general sweep (ops/sweep.py:sweep, plain PyTorch ops) on the
     card and on the CPU from the same inputs and the same injected tie
     noise, 3 sweeps at R = 32 in float32, on scp200x1000 and on the same
     instance with two cardinality rows appended (whose selection takes the
     full sort): x and remaining equal, P, pi and S within 1e-5 absolute
     plus 1e-5 relative;
  9. drives solve mode — baryonyx_torch.solve on scp200x1000, default
     parameters, 20 s — and then on zknap200x1000 (10 s): status success, a
     solution the numpy oracle accepts; on the Z instance the DP launches
     must equal sweeps x blocks, and neither run may launch the fused
     sweep;
 10. drives baryonyx_torch.optimize for 5 s on the cardinality instance,
     which the fused sweep does not take: a valid solution, no launch of
     the fused sweep kernel;
 11. runs the command line in-process (baryonyx_torch.cli.main) on an LP
     file in a temporary directory, solve mode, --limit 200: exit code 0, a
     .sol file that --check then calls valid;
 12. prints one JSON line with every kernel's numbers, then the last
     line {"ok": true, "device": {...}}.

Any failure exits nonzero before the last line. Without a CUDA device, or
outside a checkout, it exits nonzero and prints no result.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import io
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate
F32_OPS_PER_S = 67e12  # H100 SXM float32 outside the tensor cores
SWEEPS = 3
TIME_LIMIT_S = 6.0  # the optimize budget of the main-path run
NRE_TIME_LIMIT_S = 6.0  # the optimize budget of the scpnre run
Z_TIME_LIMIT_S = 6.0  # the optimize budget of the Z-path run
SOLVE_TIME_LIMIT_S = 20.0  # solve on scp200x1000
Z_SOLVE_TIME_LIMIT_S = 10.0  # solve on zknap200x1000
FALLBACK_TIME_LIMIT_S = 5.0  # optimize through the general sweep
SWEEP_R = 32  # replicas of the general sweep's card-against-CPU check
SWEEP_TOL = 1e-5  # absolute plus relative, on P, pi and S
DP_R = 512  # replicas of the DP parity phase (the Z path's default R)
KERNELS = ["psweep", "dpselect"]
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
        for line in kernels.resource_lines(logs.get(name) or kernels.build_log(name)):
            print(f"  {name}: {line}")

    import numpy as np

    import baryonyx_torch as bt
    from baryonyx_torch.generators import (
        random_set_cover_lp,
        random_z_multiknapsack_lp,
    )
    from baryonyx_torch.ops import psweep as pw
    from baryonyx_torch.ops import zsweep as zs
    from baryonyx_torch.ops.layout import compile_problem
    from baryonyx_torch.ops.sweep import SweepNoise, sweep, violated_mask
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

    def max_err_of(u, v):
        """max |u - v|, where entries that are the same infinity or both
        NaN in u and v count as equal (a long optimize run can drive a
        replica's duals out of range; both versions must then agree on
        where). NaN if one is NaN where the other is not."""
        same = (u == v) | (u.isnan() & v.isnan())
        return float(torch.where(same, 0.0, (u - v).abs()).max())

    def compare(a, b):
        """x and remaining mismatch counts and the P/pi/S max |err| of two
        sweep results (x, P, pi, S, ..., remaining)."""
        errs = {k: max_err_of(u, v)
                for k, u, v in zip(("P", "pi", "S"), a[1:4], b[1:4])}
        return int((a[0] != b[0]).sum()), int((a[-1] != b[-1]).sum()), errs

    def check(label, a, b):
        x_mis, rem_mis, errs = compare(a, b)
        odd = sum(int((~torch.isfinite(t)).sum()) for t in a[1:4])
        print(f"[{label}] x mismatches {x_mis}, remaining mismatches "
              f"{rem_mis}, max|err| {errs}"
              + (f", {odd} non-finite entries in the plain version's P, pi, S"
                 if odd else ""))
        if x_mis or rem_mis:
            fail(f"{label}: kernel x/remaining differ from the plain version")
        if not all(errs[k] <= TOL[k] for k in TOL):
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

    counters = {"psweep": pw.psweep_kernel, "dpselect": zs.dp_select_kernel}

    class Capture:
        """Wraps a kernel's dispatcher for an optimize run: keeps copies of
        the inputs of every ``every``-th call, the last ``keep`` of them
        or, with ``first``, the first ``keep``."""

        def __init__(self, real, every: int, keep: int, first: bool = False):
            self.every = every
            self.keep = keep
            self.first = first
            self.states = collections.deque(maxlen=keep)
            self.calls = 0
            self.real = real

        def __call__(self, *a, **kw):
            self.calls += 1
            full = self.first and len(self.states) == self.keep
            if self.calls % self.every == 0 and not full:
                self.states.append(cloned((a, kw)))
            return self.real(*a, **kw)

    def cloned(state):
        a, kw = state
        c = lambda v: v.clone() if isinstance(v, torch.Tensor) else v  # noqa: E731
        return tuple(c(v) for v in a), {k: c(v) for k, v in kw.items()}

    def run_optimize(lp: str, limit: float, every: int, keep: int,
                     module=pw, attr="psweep", first=False):
        """optimize on ``lp`` for ``limit`` s, with ``module.attr`` wrapped
        by a Capture; every launch counter is set to 0 just before and
        read just after. Returns (raw, result, launches by kernel,
        replica-sweeps/s, captured inputs)."""
        ctx = bt.make_context(4)
        ctx.parameters.seed = args.seed
        ctx.parameters.time_limit = limit
        last = {}

        def on_update(remaining, value, loop, elapsed, restarts):
            last.update(loop=loop, elapsed=elapsed, value=value)

        ctx.register(update=on_update)
        raw = bt.make_problem(ctx, io.StringIO(lp))
        cap = Capture(getattr(module, attr), every, keep, first)
        setattr(module, attr, cap)
        try:
            for k in counters.values():
                k.launches = 0
            result = bt.optimize(ctx, raw)
            torch.cuda.synchronize()
            launches = {name: k.launches for name, k in counters.items()}
        finally:
            setattr(module, attr, cap.real)
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

    def timed(fn, inp, n, graph=False):
        """ms per call of fn(inp) over n calls after one warm-up. With
        ``graph`` the n calls are captured into one CUDA graph and its
        replay is timed: device time, without the host's time to enqueue
        (a kernel's wrapper takes longer on the host than a fast kernel on
        the card)."""
        fn(inp)
        torch.cuda.synchronize()

        def run():
            for _ in range(n):
                fn(inp)

        if graph:
            captured = torch.cuda.CUDAGraph()
            with torch.cuda.graph(captured):
                run()
            run = captured.replay
            run()
            torch.cuda.synchronize()
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        run()
        t1.record()
        torch.cuda.synchronize()
        return t0.elapsed_time(t1) / n

    def in_turns(fns, inp, n):
        """Device ms per call of each function, timed in turns, there and
        back (a, b, c, c, b, a): the mean of each one's two times."""
        order = list(fns) + list(reversed(fns))
        ms = collections.defaultdict(list)
        for name in order:
            ms[name].append(timed(fns[name], inp, n, graph=True))
        return {name: sum(v) / len(v) for name, v in ms.items()}

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
    raw, result, counts, rate, main_states = run_optimize(
        instances["scp200x1000"], TIME_LIMIT_S, every=256, keep=8
    )
    launches = counts["psweep"]
    valid = bt.is_valid_solution(raw, result)
    print(f"[optimize scp200x1000] status {result.status.name} objective "
          f"{result.value} sweeps {result.loop} R {result.replicas} "
          f"B {result.block_size} replica-sweeps/s {rate:.1f} "
          f"launches {counts} valid {valid} "
          f"duration {result.duration:.2f} s")
    if result.status != bt.ResultStatus.success or not valid:
        fail("optimize did not return a valid feasible solution")
    if not np.isfinite(result.value):
        fail("optimize returned a non-finite objective")
    if launches <= 0 or launches != result.loop or counts["dpselect"]:
        fail(f"launches {counts} vs sweeps {result.loop}")
    optimize_rec = {"objective": result.value, "sweeps": result.loop,
                    "R": result.replicas, "B": result.block_size,
                    "replica_sweeps_per_s": rate}

    # the first states of this run, not the last: hundreds of sweeps on
    # this class drive the duals of many replicas out of float32's range,
    # where an error bound on P, pi and S says little
    raw2, res2, counts2, rate2, nre_states = run_optimize(
        instances["scpnre500x5000"], NRE_TIME_LIMIT_S, every=16, keep=3,
        first=True,
    )
    print(f"[optimize scpnre500x5000] status {res2.status.name} objective "
          f"{res2.value} sweeps {res2.loop} R {res2.replicas} "
          f"B {res2.block_size} replica-sweeps/s {rate2:.1f} "
          f"launches {counts2} valid "
          f"{bt.is_valid_solution(raw2, res2)}")
    del raw2, res2

    # ---- phase 3: kernel vs plain version at the main paths' states
    per_instance = []
    for name, states, reps in (("scp200x1000", main_states, 50),
                               ("scpnre500x5000", nre_states, 5)):
        if not states:
            fail(f"{name}: optimize ran too few sweeps to keep a state")
        recs = []
        cp = states[0][0][0]
        R, B = states[0][0][3].shape[-1], states[0][1]["block_size"]
        plan = pw.launch_plan(cp.n, cp.Kr, R, B)
        print(f"[{name}] launch plan: {plan}, {plan.threads} threads x "
              f"{plan.grid(R)} CUDA blocks")
        if plan.variant != "group":
            fail(f"{name}: the launch plan takes the {plan.variant} variant")
        fns = {"ms": lambda inp: pw.psweep_kernel(inp),
               "old_ms": lambda inp: pw.psweep_kernel(inp, pw.REPLICA_THREAD)}
        if plan.s_resident:
            s_in_l2 = pw.group_plan(cp.n, cp.Kr, B, plan.G, plan.Wr,
                                    plan.key_storage == "registers", False)
            fns["s_in_l2_ms"] = lambda inp: pw.psweep_kernel(inp, s_in_l2)
        for i, st in enumerate(states):
            a = pw.psweep_reference(*cloned(st)[0], **cloned(st)[1])
            b = pw.psweep(*cloned(st)[0], **cloned(st)[1])
            max_err = max(max_err, check(f"{name} state {i}", a, b))
            mismatches += compare(a, b)[0]
            del a, b
            inp = prepared(st)
            b_ms, b_by, share = bound(cp, inp)
            recs.append(dict(
                **in_turns(fns, inp, reps),
                plain_ms=timed(pw._sweep_plain, prepared(st), 1),
                bound_ms=b_ms, bound_by=b_by, sched_share=share,
                n_rows=int(inp.n_rows),
            ))
            r = recs[-1]
            both = (f" (S resident; {r['s_in_l2_ms']:.4f} ms with S in L2)"
                    if plan.s_resident else "")
            print(f"[{name} state {i}] scheduled share {share:.4f} rows "
                  f"{r['n_rows']}: kernel {r['ms']:.4f} ms{both}, first design "
                  f"{r['old_ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, bound "
                  f"{b_ms:.5f} ms ({b_by})")
            del inp
        mean = {k: sum(r[k] for r in recs) / len(recs)
                for k in recs[0] if k not in ("bound_by", "n_rows")}
        by = collections.Counter(r["bound_by"] for r in recs).most_common(1)
        per_instance.append(dict(
            instance=name, R=R, B=B, m=cp.m, n=cp.n, Kr=cp.Kr,
            plan=plan._asdict(), states=len(recs), bound_by=by[0][0], **mean,
            by_state=[{k: r[k] for k in ("sched_share", "ms", "old_ms")}
                      for r in recs],
        ))
        print(f"[{name}] mean over {len(recs)} states: kernel "
              f"{mean['ms']:.4f} ms/sweep, first design {mean['old_ms']:.4f} "
              f"ms/sweep, plain {mean['plain_ms']:.4f} ms/sweep, bound "
              f"{mean['bound_ms']:.5f} ms, scheduled share "
              f"{mean['sched_share']:.4f}")
        del states[:]
        torch.cuda.empty_cache()

    # ---- phase 4: the DP kernel vs its plain version at random inputs
    z_instances = {
        "zknap200x1000": random_z_multiknapsack_lp(200, 1000, seed=2),
        "wide64x400": random_z_multiknapsack_lp(
            64, 400, row_len=(13, 24), coeff_range=(1, 150), seed=3
        ),
    }
    gen = torch.Generator(device=dev)
    gen.manual_seed(args.seed)
    dp_mismatches = 0
    dp_max_err = 0.0

    def dp_check(label, dp_args):
        nonlocal dp_mismatches, dp_max_err
        got = zs.dp_select(*dp_args)
        want = zs.dp_select_reference(*dp_args)
        torch.cuda.synchronize()
        mis = int((got != want).sum())
        dp_mismatches += mis
        dp_max_err = max(dp_max_err, float((got.int() - want.int()).abs().max()))
        if mis:
            fail(f"{label}: the DP kernel differs from its plain version "
                 f"on {mis} of {got.numel()} bits")
        return got

    def dp_bound(cp, B, R):
        """Least time of one DP call of B rows and R replicas: the bytes it
        needs (r read, the chosen set written, the row tables and the
        slot mask) over the memory rate, or its operations over the
        float32 rate: per (row, replica) the table's set-up 1 per w; per
        slot and w the shift test, the add, the compare and two selects
        5; the argmin over w 4 per w (the range test 2, the compare and
        the select); the read-out 2 per slot. The table itself stays on
        chip in an ideal kernel and is not counted."""
        W, Kr = cp.Wdp, cp.Kr
        nbytes = 5 * B * Kr * R + 5 * B * Kr + 16 * B
        ops = B * R * (W * (1 + 5 * Kr + 4) + 2 * Kr)
        t_b = nbytes / HBM_BYTES_PER_S * 1e3
        t_o = ops / F32_OPS_PER_S * 1e3
        return (t_b, "bytes") if t_b >= t_o else (t_o, "operations")

    def dp_timed(dp_args, reps):
        """The DP kernel and its first design in turns, then the plain
        version."""
        fns = {"ms": lambda a: zs.dp_select_kernel(*a),
               "old_ms": lambda a: zs.dp_select_kernel(*a, zs.DEVICE_TABLE)}
        return dict(
            **in_turns(fns, dp_args, reps),
            plain_ms=timed(lambda a: zs.dp_select_reference(*a), dp_args, 3),
        )

    dp_records = []
    for name, lp in z_instances.items():
        t = time.monotonic()
        cp, R, B = compiled(lp)
        dp_rows = torch.nonzero(cp.dp_row).flatten().to(torch.int32)
        n_blocks = dp_rows.numel() // B
        print(f"[{name}] m={cp.m} n={cp.n} Kr={cp.Kr} Wdp={cp.Wdp} "
              f"Amax={cp.Amax} DP rows {dp_rows.numel()} R={DP_R} B={B} "
              f"setup {time.monotonic() - t:.1f} s")
        if not cp.Wdp or n_blocks < 1:
            fail(f"{name}: no DP rows")
        dplan = zs.dp_launch_plan(cp.Wdp, cp.Kr, DP_R, B)
        print(f"[{name}] launch plan: {dplan}, {dplan.threads} threads x "
              f"{dplan.grid(DP_R, B)} CUDA blocks")
        if dplan.variant != "shared":
            fail(f"{name}: the launch plan takes the {dplan.variant} variant")
        for minimize in (True, False):
            for blk in range(n_blocks):
                rows_c = dp_rows[blk * B:(blk + 1) * B].contiguous()
                r = torch.randn((B, cp.Kr, DP_R), generator=gen, device=dev)
                mask = cp.row_mask[rows_c.long()].contiguous()
                dp_args = (cp, rows_c, r, mask, minimize)
                got = dp_check(f"{name} block {blk}", dp_args)
                if blk == 0 and minimize:
                    first = dp_args
        print(f"[{name}] DP kernel bit-exact on {n_blocks} blocks x 2 "
              f"objectives; chosen share {float(got.float().mean()):.3f}")
        b_ms, b_by = dp_bound(cp, B, DP_R)
        rec = dict(instance=name, inputs="random", R=DP_R, B=B, W=cp.Wdp,
                   Kr=cp.Kr, plan=dplan._asdict(), bound_ms=b_ms,
                   bound_by=b_by, **dp_timed(first, 20))
        dp_records.append(rec)
        print(f"[{name} random] kernel {rec['ms']:.4f} ms, first design "
              f"{rec['old_ms']:.4f} ms, plain {rec['plain_ms']:.4f} ms, bound "
              f"{b_ms:.6f} ms ({b_by})")
        del cp, first, dp_args
        torch.cuda.empty_cache()

    # ---- phase 5: the Z path: optimize on zknap200x1000
    # every 37th DP call: 37 is 5 mod the 32 blocks of a sweep, so the
    # kept inputs spread over the blocks of the order, not its tail only
    zraw, zres, zcounts, zrate, z_states = run_optimize(
        z_instances["zknap200x1000"], Z_TIME_LIMIT_S, every=37, keep=6,
        module=zs, attr="dp_select",
    )
    zvalid = bt.is_valid_solution(zraw, zres)
    if not z_states:
        fail("zknap200x1000: optimize ran too few sweeps to keep a DP input")
    zcp = z_states[0][0][0]
    blocks = -(-zcp.m // zres.block_size)
    print(f"[optimize zknap200x1000] status {zres.status.name} objective "
          f"{zres.value} sweeps {zres.loop} R {zres.replicas} "
          f"B {zres.block_size} replica-sweeps/s {zrate:.1f} "
          f"launches {zcounts} (blocks per sweep {blocks}) valid {zvalid} "
          f"duration {zres.duration:.2f} s")
    if zres.status != bt.ResultStatus.success or not zvalid:
        fail("Z optimize did not return a valid feasible solution")
    if not np.isfinite(zres.value):
        fail("Z optimize returned a non-finite objective")
    if zcounts["dpselect"] <= 0 or zcounts["dpselect"] != zres.loop * blocks \
            or zcounts["psweep"]:
        fail(f"launches {zcounts} vs {zres.loop} sweeps x {blocks} blocks")
    z_rec = {"objective": zres.value, "sweeps": zres.loop,
             "R": zres.replicas, "B": zres.block_size,
             "replica_sweeps_per_s": zrate}

    # ---- phase 6: the DP kernel vs its plain version at the Z path's inputs
    recs = []
    for i, st in enumerate(z_states):
        dp_args = cloned(st)[0]
        got = dp_check(f"zknap200x1000 captured {i}", dp_args)
        B, _, R = dp_args[2].shape
        b_ms, b_by = dp_bound(zcp, B, R)
        recs.append(dict(bound_ms=b_ms, bound_by=b_by, **dp_timed(dp_args, 50)))
        dp_rows_in = int(zcp.dp_row[dp_args[1].long()].sum())
        print(f"[zknap200x1000 captured {i}] {dp_rows_in} DP rows of {B}, "
              f"chosen share {float(got.float().mean()):.3f}: kernel "
              f"{recs[-1]['ms']:.4f} ms, first design "
              f"{recs[-1]['old_ms']:.4f} ms, plain "
              f"{recs[-1]['plain_ms']:.4f} ms, bound {b_ms:.6f} ms ({b_by})")
    dp_main = {k: sum(r[k] for r in recs) / len(recs)
               for k in ("ms", "old_ms", "plain_ms", "bound_ms")}
    dp_main.update(instance="zknap200x1000", inputs="captured", R=R, B=B,
                   W=zcp.Wdp, Kr=zcp.Kr, states=len(recs),
                   bound_by=recs[0]["bound_by"])
    dp_records.insert(0, dp_main)
    del z_states, zcp

    # ---- phase 7: the DP kernel at one replica, solve mode's shape
    dp_r1_records = []
    for name, lp in z_instances.items():
        cp, _, B = compiled(lp)
        dp_rows = torch.nonzero(cp.dp_row).flatten().to(torch.int32)
        n_blocks = dp_rows.numel() // B
        dplan = zs.dp_launch_plan(cp.Wdp, cp.Kr, 1, B)
        print(f"[{name} R=1] launch plan: {dplan}, {dplan.threads} threads x "
              f"{dplan.grid(1, B)} CUDA blocks")
        if dplan.variant != "shared":
            fail(f"{name} R=1: the launch plan takes the {dplan.variant} variant")
        for minimize in (True, False):
            for blk in range(n_blocks):
                rows_c = dp_rows[blk * B:(blk + 1) * B].contiguous()
                r = torch.randn((B, cp.Kr, 1), generator=gen, device=dev)
                mask = cp.row_mask[rows_c.long()].contiguous()
                dp_args = (cp, rows_c, r, mask, minimize)
                dp_check(f"{name} R=1 block {blk}", dp_args)
                if blk == 0 and minimize:
                    first = dp_args
        b_ms, b_by = dp_bound(cp, B, 1)
        rec = dict(instance=name, inputs="random", R=1, B=B, W=cp.Wdp,
                   Kr=cp.Kr, plan=dplan._asdict(), bound_ms=b_ms,
                   bound_by=b_by, **dp_timed(first, 50))
        dp_r1_records.append(rec)
        print(f"[{name} R=1] DP kernel bit-exact on {n_blocks} blocks x 2 "
              f"objectives: kernel {rec['ms']:.4f} ms, first design "
              f"{rec['old_ms']:.4f} ms, plain {rec['plain_ms']:.4f} ms, bound "
              f"{b_ms:.7f} ms ({b_by})")
        del cp, first, dp_args
    dp_records += dp_r1_records

    # ---- phase 8: the general sweep on the card against itself on the CPU
    def cardinality_lp(lp: str) -> str:
        """``lp`` plus two rows `sum of 40 variables = 10`: their selection
        reads ranks that no sort-free split covers."""
        names = list(bt.parse_lp(lp).vars.names)
        rows = "".join(
            f"card{i}: " + " + ".join(names[i * 40:(i + 1) * 40]) + " = 10\n"
            for i in range(2)
        )
        head, tail = lp.split("binary\n", 1)
        return head + rows + "binary\n" + tail

    instances["scp200x1000+card"] = cardinality_lp(instances["scp200x1000"])

    def sweep_chain(cp, cost, push, noise, B):
        """SWEEPS general sweeps from x = 0 on cp's device, scheduled as
        run_chain schedules them, the tie noise injected."""
        d = cp.device
        R = SWEEP_R
        x = torch.zeros((cp.n, R), dtype=torch.int32, device=d)
        P = torch.zeros((cp.m, cp.Kr, R), device=d)
        pi = torch.zeros((cp.m, R), device=d)
        S = None
        sched = violated_mask(cp, x) | push.to(d)
        pad = torch.full((-cp.m % B,), cp.m, dtype=torch.int32, device=d)
        for it in range(SWEEPS):
            any_row = sched.any(dim=1)
            order = torch.argsort((~any_row).to(torch.int8), stable=True)
            order = torch.cat([order.to(torch.int32), pad])  # sentinel rows
            x, P, pi, S, viol, rem = sweep(
                cp, x, P, pi, cost.to(d), sched, order, 0.15,
                0.01, 0.5, None, 0.0, n_rows=int(any_row.sum()),
                block_size=B, S=S, S_fresh=it != 0,
                noise=SweepNoise(noise[it].to(d)),
            )
            sched = viol | push.to(d)
        return x, P, pi, S, rem

    sweep_recs = []
    for name, full_sort in (("scp200x1000", False), ("scp200x1000+card", True)):
        ctx = bt.make_context(0)
        ctx.parameters = ctx.parameters.validated()
        pb = _prepare(ctx, bt.parse_lp(instances[name]))
        cp_cpu = compile_problem(
            make_merged_constraints(ctx, pb), len(pb.vars.values), device="cpu"
        )
        if cp_cpu.sel_reduction_ok == full_sort:
            fail(f"{name}: sel_reduction_ok is {cp_cpu.sel_reduction_ok}")
        cp_dev = cp_cpu.to(dev)
        B = ctx.parameters.block_size
        n = cp_cpu.n
        cpu_gen = torch.Generator().manual_seed(args.seed)
        cost = torch.as_tensor(
            (1.0 + np.arange(n) + 0.01 * ((np.arange(n) * 37) % 61)) / (n + 1.0),
            dtype=torch.float32,
        )
        push = (torch.rand(SWEEP_R, generator=cpu_gen) < 0.5)[None, :]
        noise = torch.rand(
            (SWEEPS, -(-cp_cpu.m // B), B, cp_cpu.Kr, SWEEP_R), generator=cpu_gen
        )
        t = time.monotonic()
        a = sweep_chain(cp_cpu, cost, push, noise, B)
        t_cpu = time.monotonic() - t
        sweep_chain(cp_dev, cost, push, noise, B)  # warm-up
        torch.cuda.synchronize()
        t = time.monotonic()
        b = sweep_chain(cp_dev, cost, push, noise, B)
        torch.cuda.synchronize()
        t_dev = time.monotonic() - t
        b = [v.cpu() for v in b]
        x_mis = int((a[0] != b[0]).sum())
        rem_mis = int((a[4] != b[4]).sum())
        errs = {}
        for k, u, v in zip(("P", "pi", "S"), a[1:4], b[1:4]):
            errs[k] = float((u - v).abs().max())
            if not torch.allclose(v, u, rtol=SWEEP_TOL, atol=SWEEP_TOL):
                fail(f"{name}: the general sweep's {k} on the card is outside "
                     f"{SWEEP_TOL} of the CPU's (max |err| {errs[k]})")
        moved = float((b[1][: cp_cpu.m_real] != 0).any(dim=1).float().mean())
        print(f"[sweep {name}] {'full sort' if full_sort else 'sort-free'} "
              f"m={cp_cpu.m} Kr={cp_cpu.Kr} R={SWEEP_R} B={B}: x mismatches "
              f"{x_mis}, remaining mismatches {rem_mis}, max|err| {errs}, pairs "
              f"with a moved P {moved:.4f}; wall {t_dev / SWEEPS * 1e3:.1f} ms "
              f"per sweep on the card, {t_cpu / SWEEPS * 1e3:.1f} ms on the CPU")
        if x_mis or rem_mis:
            fail(f"{name}: the general sweep differs between the card and the CPU")
        if moved < 0.5:
            fail(f"{name}: the general sweep moved too little to check")
        sweep_recs.append(dict(instance=name, full_sort=full_sort, R=SWEEP_R,
                               B=B, max_abs_err=errs,
                               card_wall_ms_per_sweep=t_dev / SWEEPS * 1e3))
        del cp_cpu, cp_dev, a, b

    # ---- phase 9: solve mode on scp200x1000 and on zknap200x1000
    def run_entry(label, lp, limit, entry):
        """``entry`` (bt.solve or bt.optimize) on ``lp`` for ``limit`` s
        through make_problem, every launch counter set to 0 just before and
        read just after; the result must be a valid feasible solution."""
        ctx = bt.make_context(4)
        ctx.parameters.seed = args.seed
        ctx.parameters.time_limit = limit
        raw = bt.make_problem(ctx, io.StringIO(lp))
        for k in counters.values():
            k.launches = 0
        t = time.monotonic()
        res = entry(ctx, raw)
        torch.cuda.synchronize()
        wall = time.monotonic() - t
        counts = {name: k.launches for name, k in counters.items()}
        ok = bool(res.solutions) and bt.is_valid_solution(raw, res)
        sweeps = res.sweeps if entry is bt.solve else res.loop
        value = res.value if res.solutions else float("nan")
        print(f"[{label}] status {res.status.name} objective {value} "
              f"sweeps {sweeps} (best at {res.loop}) wall {wall:.2f} s "
              f"{wall / max(sweeps, 1) * 1e3:.3f} ms per sweep launches "
              f"{counts} valid {ok}")
        if res.status != bt.ResultStatus.success or not ok:
            fail(f"{label}: no valid feasible solution")
        if not np.isfinite(value) or sweeps <= 0:
            fail(f"{label}: objective {value} after {sweeps} sweeps")
        rec = {"objective": value, "sweeps": sweeps, "wall_s": wall,
               "ms_per_sweep": wall / sweeps * 1e3, "launches": counts}
        return res, counts, rec

    _, counts, solve_rec = run_entry(
        "solve scp200x1000", instances["scp200x1000"], SOLVE_TIME_LIMIT_S,
        bt.solve)
    if counts["psweep"] or counts["dpselect"]:
        fail(f"solve scp200x1000 launched a hand-written kernel: {counts}")

    zcp1, _, _ = compiled(z_instances["zknap200x1000"])
    zres1, zcounts1, z_solve_rec = run_entry(
        "solve zknap200x1000", z_instances["zknap200x1000"],
        Z_SOLVE_TIME_LIMIT_S, bt.solve)
    zblocks = -(-zcp1.m // bt.SolverParameters().block_size)
    print(f"[solve zknap200x1000] {zres1.sweeps} sweeps x {zblocks} blocks = "
          f"{zres1.sweeps * zblocks}, DP launches {zcounts1['dpselect']}")
    if zcounts1["dpselect"] != zres1.sweeps * zblocks or zcounts1["psweep"]:
        fail(f"launches {zcounts1} vs {zres1.sweeps} sweeps x {zblocks} blocks")
    del zcp1

    # ---- phase 10: optimize through the general sweep
    fres, fcounts, fallback_rec = run_entry(
        "optimize scp200x1000+card", instances["scp200x1000+card"],
        FALLBACK_TIME_LIMIT_S, bt.optimize)
    fallback_rec.update(R=fres.replicas, B=fres.block_size)
    print(f"[optimize scp200x1000+card] R {fres.replicas} B {fres.block_size}")
    if fcounts["psweep"] or fcounts["dpselect"]:
        fail(f"the general-sweep route launched a hand-written kernel: {fcounts}")

    # ---- phase 11: the command line, in-process
    from baryonyx_torch.cli import main as cli_main

    with tempfile.TemporaryDirectory() as tmp:
        lp_path = Path(tmp) / "scp200x1000.lp"
        lp_path.write_text(instances["scp200x1000"])
        rc = cli_main(["--quiet", "--limit", "200", "--time-limit", "5",
                       "--seed", str(args.seed), str(lp_path)])
        sols = list(Path(tmp).glob("scp200x1000.lp-*.sol"))
        if rc != 0 or len(sols) != 1:
            fail(f"the command line returned {rc} and wrote {len(sols)} .sol files")
        if not sols[0].read_text().startswith("\\ solver..........: baryonyx-torch"):
            fail("the .sol file's header does not name baryonyx-torch")
        said = io.StringIO()
        with contextlib.redirect_stdout(said):
            rc = cli_main(["--quiet", "--check", str(sols[0]), str(lp_path)])
        said = said.getvalue().strip()
        print(f"[cli] solve wrote {sols[0].name}; --check: "
              f"{said.splitlines()[0].split(': ')[-1]}, "
              f"{said.splitlines()[-1]}")
        if rc != 0 or ": valid" not in said:
            fail(f"--check did not call the command line's .sol valid: {said}")

    # ---- phase 12: the kernels line, then the result line
    main = per_instance[0]
    print(json.dumps({"kernels": [{
        "name": "psweep",
        "route": "cuda",
        "source": "baryonyx_torch/csrc/psweep.cu",
        "replaces": "JAX package ops/psweep.py:225 (_make_kernel)",
        "launches": launches,
        "launches_by_path": {"optimize scp200x1000": launches,
                             "solve scp200x1000": solve_rec["launches"]["psweep"],
                             "optimize scp200x1000+card": fcounts["psweep"]},
        "max_abs_err": max_err,
        "mismatches": mismatches,
        "ms": main["ms"],
        "plain_ms": main["plain_ms"],
        "bound_ms": main["bound_ms"],
        "bound_by": main["bound_by"],
        "library_ms": None,
        "instances": per_instance,
        "optimize": optimize_rec,
    }, {
        "name": "dpselect",
        "route": "cuda",
        "source": "baryonyx_torch/csrc/dpselect.cu",
        "replaces": "JAX package ops/zsweep.py:125 (_dp_select_pallas)",
        "launches": zcounts["dpselect"],
        "launches_by_path": {"optimize zknap200x1000": zcounts["dpselect"],
                             "solve zknap200x1000": zcounts1["dpselect"]},
        "max_abs_err": dp_max_err,
        "mismatches": dp_mismatches,
        "ms": dp_main["ms"],
        "plain_ms": dp_main["plain_ms"],
        "bound_ms": dp_main["bound_ms"],
        "bound_by": dp_main["bound_by"],
        "library_ms": None,
        "instances": dp_records,
        "optimize": z_rec,
        "solve": z_solve_rec,
    }], "general_sweep": sweep_recs, "solve": solve_rec,
        "optimize_general_sweep": fallback_rec}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
