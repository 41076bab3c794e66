"""Time the two hand-written kernels under different launch plans on a CUDA
device, each plan first held against the kernel's plain PyTorch version.

    python -m baryonyx_torch.kernel_tune [--quick] [--out DIR]

Kernel A (csrc/psweep.cu) on scp200x1000 and the scpnre class 500x5000:
three sweeps from x = 0 with half the lanes pushing bring the state to a
scheduled share near 0.5; the inputs of a fourth sweep are kept, once as
they are and once with a random 85% of the (row, replica) pairs taken off
the schedule. At both, every candidate plan (the first design,
replica_thread; the group variant at several group sizes and warps per
row, keys in registers or in the tile, with and without S resident in
shared memory) runs once and is held
against the plain version (x bit for bit, P, pi, S within 2e-4 / 2e-4 /
2e-3), then is timed (its launches captured into a CUDA graph, so the
host's time to enqueue them is not in the number), the plans taking turns,
two rounds.

Kernel B (csrc/dpselect.cu) on zknap200x1000 (W 88) and the wide-table
instance (W 2048), R = 512, B = 8, random N(0, 1) reduced costs: every
candidate plan (device_table; the shared variant at several G and T) is
held against the plain version bit for bit, then timed the same way.

``--quick`` builds, prints the compiler's register report, runs every plan
once against the plain version, and times nothing. Prints one line per
plan and writes DIR/kernel_tune.json (default build/).
"""

from __future__ import annotations

import argparse
import json
import subprocess
from pathlib import Path

import numpy as np
import torch

import baryonyx_torch as bt
from baryonyx_torch import kernels
from baryonyx_torch.generators import random_set_cover_lp, random_z_multiknapsack_lp
from baryonyx_torch.ops import psweep as pw
from baryonyx_torch.ops import zsweep as zs
from baryonyx_torch.ops.layout import compile_problem
from baryonyx_torch.ops.sweep import violated_mask
from baryonyx_torch.preprocess.merge import make_merged_constraints
from baryonyx_torch.solver.api import _prepare
from baryonyx_torch.solver.optimize import replica_batch

TOL = (2e-4, 2e-4, 2e-3)  # P, pi, S


def compiled(lp: str, dev):
    ctx = bt.make_context(0)
    ctx.parameters = ctx.parameters.validated()
    pb = _prepare(ctx, bt.parse_lp(lp))
    cp = compile_problem(
        make_merged_constraints(ctx, pb), len(pb.vars.values), device=dev
    )
    R, B = replica_batch(ctx, cp, ctx.parameters, dev)
    return cp, R, B


def timed(fn, reps: int) -> float:
    """Device ms per call of ``fn``: ``reps`` calls captured into one CUDA
    graph, so the host's time to enqueue a call is not in the number."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    graph.replay()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def sweep_states(cp, R, B, dev, seed: int):
    """The inputs of a fourth sweep after three from x = 0 (see the module
    docstring): [(label, sweep arguments, keywords)]."""
    rng = np.random.default_rng(seed)
    push = torch.as_tensor(rng.random(R) < 0.5, device=dev)[None, :]
    cost = torch.as_tensor(
        1.0 + np.arange(cp.n) + 0.01 * ((np.arange(cp.n) * 37) % 61),
        dtype=torch.float32, device=dev,
    )
    x = torch.zeros((cp.n, R), dtype=torch.int32, device=dev)
    P = torch.zeros((cp.m, cp.Kr, R), device=dev)
    pi = torch.zeros((cp.m, R), device=dev)
    S = None
    sched = violated_mask(cp, x) | push

    def call(it, sched, x, P, pi, S):
        any_row = sched.any(dim=1)
        order = torch.argsort((~any_row).to(torch.int8), stable=True)
        seed_t = torch.tensor([1000 + it, -77 * it], dtype=torch.int32, device=dev)
        args = (cp, x, P, pi, cost, sched, order.to(torch.int32),
                torch.full((R,), 0.15, device=dev), 0.01, 0.5, seed_t,
                torch.zeros(R, device=dev))
        kw = dict(n_rows=any_row.sum(), minimize=True, block_size=B, S=S,
                  S_fresh=it != 0)
        return args, kw

    for it in range(3):
        args, kw = call(it, sched, x, P, pi, S)
        x, P, pi, S, viol, _ = pw.psweep(*args, **kw)
        sched = viol | push
    keep = torch.as_tensor(rng.random((cp.m, R)) < 0.15, device=dev)
    return [("half", *call(3, sched, x, P, pi, S)),
            ("sparse", *call(3, sched & keep, x, P, pi, S))]


def prepared(args, kw):
    c = lambda v: v.clone() if isinstance(v, torch.Tensor) else v  # noqa: E731
    a = tuple(c(v) for v in args)
    return pw._prepare(*a, kw["n_rows"], kw["minimize"], kw["block_size"], None,
                       c(kw["S"]), kw["S_fresh"])


def sweep_plans(cp, R, B):
    """Candidate plans of kernel A for this shape, the default first."""
    default = pw.launch_plan(cp.n, cp.Kr, R, B)
    plans = [default, pw.REPLICA_THREAD]
    for G in (8, 16, 4):
        for Wr in (1, 2, 4):
            for key_regs in (True, False):
                for s_res in (False, True):
                    try:
                        plans.append(
                            pw.group_plan(cp.n, cp.Kr, B, G, Wr, key_regs, s_res))
                    except ValueError:
                        pass
    return list(dict.fromkeys(plans))


def tune_sweep(name, lp, dev, seed, quick, reps):
    cp, R, B = compiled(lp, dev)
    out = []
    for label, args, kw in sweep_states(cp, R, B, dev, seed):
        share = float(args[5][: cp.m_real].float().mean())
        want = prepared(args, kw)
        pw._sweep_plain(want)
        plans = sweep_plans(cp, R, B)
        good = []
        for plan in plans:
            got = prepared(args, kw)
            pw.psweep_kernel(got, plan)
            torch.cuda.synchronize()
            x_mis = int((got.x != want.x).sum())
            errs = [float((u - v).abs().max()) for u, v in
                    zip((got.P, got.pi, got.S), (want.P, want.pi, want.S))]
            ok = x_mis == 0 and all(e <= t for e, t in zip(errs, TOL))
            print(f"[{name} {label} share {share:.3f}] {plan}: x mismatches "
                  f"{x_mis}, max|err| P, pi, S {errs} {'ok' if ok else 'WRONG'}",
                  flush=True)
            if not ok:
                raise SystemExit(f"kernel_tune: {plan} differs from the plain version")
            good.append(plan)
        if quick:
            continue
        inp = prepared(args, kw)
        ms = {plan: [] for plan in good}
        for _ in range(2):
            for plan in good:
                ms[plan].append(timed(lambda: pw.psweep_kernel(inp, plan), reps))
        for plan in good:
            print(f"[{name} {label}] {min(ms[plan]):9.4f} ms  {plan}", flush=True)
            out.append(dict(kernel="psweep", instance=name, state=label,
                            share=share, R=R, B=B, Kr=cp.Kr, n=cp.n,
                            plan=plan._asdict(), ms=ms[plan]))
    return out


def dp_plans(cp, R, B):
    default = zs.dp_launch_plan(cp.Wdp, cp.Kr, R, B)
    plans = [default, zs.DEVICE_TABLE]
    for G in (32, 16, 8, 4):
        for T in (1024 // G, 512 // G, 256 // G, 128 // G):
            if T * G % 32 == 0 and T <= cp.Wdp + 32 // G:
                try:
                    plans.append(zs.dp_plan(cp.Wdp, cp.Kr, G, T))
                except ValueError:
                    pass
    return list(dict.fromkeys(plans))


def tune_dp(name, lp, dev, seed, quick, reps, R=512):
    cp, _, B = compiled(lp, dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    # the first B rows of the instance: DP rows and others mixed, as a sweep
    # meets them; and B DP rows
    mixed = torch.arange(B, dtype=torch.int32, device=dev)
    dp_only = torch.nonzero(cp.dp_row).flatten()[:B].to(torch.int32)
    out = []
    for label, rows_c in (("dp_rows", dp_only), ("mixed_rows", mixed)):
        r = torch.randn((B, cp.Kr, R), generator=gen, device=dev)
        mask = cp.row_mask[rows_c.long()].contiguous()
        n_dp = int(cp.dp_row[rows_c.long()].sum())
        good = []
        for minimize in (True, False):
            want = zs.dp_select_reference(cp, rows_c, r, mask, minimize)
            for plan in dp_plans(cp, R, B):
                got = zs.dp_select_kernel(cp, rows_c, r, mask, minimize, plan)
                torch.cuda.synchronize()
                mis = int((got != want).sum())
                print(f"[{name} {label} ({n_dp} DP rows) W {cp.Wdp} minimize "
                      f"{minimize}] {plan}: {mis} of {got.numel()} bits differ",
                      flush=True)
                if mis:
                    raise SystemExit(
                        f"kernel_tune: {plan} differs from the plain version")
                if minimize:
                    good.append(plan)
        if quick:
            continue
        ms = {plan: [] for plan in good}
        for _ in range(2):
            for plan in good:
                ms[plan].append(timed(
                    lambda: zs.dp_select_kernel(cp, rows_c, r, mask, True, plan),
                    reps))
        for plan in good:
            print(f"[{name} {label}] {min(ms[plan]):9.4f} ms  {plan}", flush=True)
            out.append(dict(kernel="dpselect", instance=name, rows=label,
                            dp_rows=n_dp, R=R, B=B, Kr=cp.Kr, W=cp.Wdp,
                            plan=plan._asdict(), ms=ms[plan]))
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--only", choices=["psweep", "dpselect"])
    ap.add_argument("--out", default="build")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("kernel_tune: needs a CUDA device")
    dev = torch.device("cuda", 0)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(card)
    logs = kernels.build(["psweep", "dpselect"])
    for name, log in logs.items():
        for line in kernels.resource_lines(log):
            print(f"  {name}: {line}")
    rows = []
    if args.only != "dpselect":
        rows += tune_sweep("scp200x1000",
                           random_set_cover_lp(200, 1000, 0.02, seed=41), dev,
                           args.seed, args.quick, 20)
        rows += tune_sweep("scpnre500x5000",
                           random_set_cover_lp(500, 5000, 0.1, seed=7), dev,
                           args.seed, args.quick, 3)
    if args.only != "psweep":
        rows += tune_dp("zknap200x1000",
                        random_z_multiknapsack_lp(200, 1000, seed=2), dev,
                        args.seed, args.quick, 50)
        rows += tune_dp("wide64x400",
                        random_z_multiknapsack_lp(64, 400, row_len=(13, 24),
                                                  coeff_range=(1, 150), seed=3),
                        dev, args.seed, args.quick, 10)
    Path(args.out).mkdir(parents=True, exist_ok=True)
    (Path(args.out) / "kernel_tune.json").write_text(
        json.dumps(dict(card=card, rows=rows), indent=1))


if __name__ == "__main__":
    main()
