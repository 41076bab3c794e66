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
     through make_problem and parse_lp, for 4 s — with the launch counters
     set to 0 just before and read just after, and validates the solution;
     then optimize on the scpnre class for a few seconds. Both runs keep
     copies of the inputs of some of their sweeps (the main path's last
     ones, the scpnre run's first ones and, for phase 25, its last ones);
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
     make_problem, for 4 s — with the launch counters set to 0 just
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
 12. the quadratic path: writes qsap500x10 (random_qsap_lp(500, 10,
     seed=3); m 512, n 5120, 19,599 quadratic terms) to build/, loads it
     with make_problem (it fails unless the native LP parser read it) and
     drives baryonyx_torch.optimize on it for 6 s with the launch counters
     set to 0 just before and read just after: a valid solution whose
     objective equals the numpy oracle's, through the fused sweep kernel
     (the general sweep must not run), at the R and B replica_batch gives;
     keeps copies of the inputs of some sweeps, the dense quad_mat
     included;
 13. at those inputs, holds the kernel (its HAS_CQ variant) against its
     plain version (x and remaining bit-exact, P, pi and S within the
     tolerances of phase 1) and times it in turns with its first design,
     as phase 3 does; times CQ = quad_mat @ x (a float32 torch.matmul,
     TF32 off) on its own; the kernel's byte bound counts the CQ reads;
 14. the three meta-optimizer modes through cli.main in-process on
     scp200x1000 (--auto:manual for 7 s, --auto:nlopt for 4 s,
     --auto:branch for 4 s), each followed by --check: exit code 0 and a
     valid .sol; prints the method, objective, replica count and wall time
     of each, with the kernel launches of each run;
 15. at sweep inputs copied from the manual mode's first runs over its grid,
     the 100th sweep of each (scp200x1000, R = 512, every replica at a combo
     of its own: the first run varies delta, kappa_min, kappa_step and
     init_policy_random, a later one theta too) holds the kernel against
     its plain version again (x bit for bit, P, pi and S within phase 1's
     tolerances) and times it as phase 3 does, with its byte bound;
 16. population checkpoints: optimize on scp200x1000 for 3 s writing
     build/checkpoint-scp200x1000.npz after every chunk, then a second 3 s
     run that must say it resumed from it and be no worse;
 17. a one-rank NCCL group (a fresh process, so that later phases see no
     process group): baryonyx_torch.optimize on scp200x1000 (R = 2048,
     B = 4, the cycle order, a fixed budget of 400 sweeps in 4 chunks)
     through the group's path, then through the plain path: the same
     Result bit for bit (solutions, values, sweeps, annoying variable),
     and kernel A launched once per sweep through the group's path;
 18. two gloo ranks sharing the card (NCCL refuses two ranks on one
     device), 1024 replicas each, optimize on scp200x1000 for 4 s: both
     ranks return the same valid Result, the first top-K exchange kept
     each rank's best in the other's population (or lost it only to a
     later candidate that drew the same victim slot), each rank launches
     kernel A once per sweep; prints the replica-sweeps/s over both ranks
     beside phase 2's one-process figure;
 19. the row route at two gloo ranks on the card: optimize on
     scp200x1000 past a forced device budget (BARYONYX_HBM_BUDGET=5000)
     must take it (method "+rowshard") and return a valid cover; then 3
     row-sharded sweeps of each rank's shard on the card and on the CPU,
     from x = 0 and the same injected tie noise: x and remaining equal,
     P and pi within phase 8's tolerances. Every rank of phases 17-19 is
     a spawned process with a join timeout (tests/spawn_ranks.py);
 21. holds kernel B's double instance (float64 scores; its "infinity" is
     +inf, as the JAX package's float64 DP) against its plain version, bit
     for bit, at random N(0, 1) reduced costs on the DP rows of both Z
     instances (widths 88 and 2048), at R = 512 and R = 1, both
     objectives; prints each launch plan (the float32 one beside it) and
     fails if one takes the device_table variant; times it in turns with
     that first design, with its bound at 8-byte scores and the float64
     rate; then the same at the DP inputs phase 22 keeps;
 22. float64 on the card: baryonyx_torch.solve on zknap200x1000 (10 s),
     then optimize on it (4 s): valid solutions, DP launches equal to the
     blocks the sweeps processed, float64 DP inputs kept; optimize on
     scp200x1000 in float64 (4 s) through the general sweep: valid, no
     kernel launch;
 23. the equality classes at the JAX package's battery sizes, not cut
     (scripts/bench_battery.py): optimize for 4 s each on sppus145
     (random_set_partition_lp(145, 48, 3, (1, 1000), 30000, seed=3)),
     tele1200 (telebus_crew_lp(1200, 20, 4, seed=2)) and nq100
     (n_queens_lp(100); = and <= rows): a valid solution whose objective
     equals the numpy oracle's, kernel A launched once per sweep; at the
     kept sweep inputs kernel A is held against its plain version with
     phase 1's tolerances and timed as phase 3 does, with its byte bound;
 24. +-1 rows and maximization: optimize for 4 s on
     random_knapsack_101_lp(2000, 64, seed=5) (maximize; its rows read
     middle ranks, so the general sweep runs): valid, objective equal to
     the oracle's; kernel A's non-unit variant against its plain version,
     maximizing, at R = 2048 on random_knapsack_101_lp(22, 64, seed=5),
     the largest of that generator's instances whose selection needs no
     sort; optimize for 4 s on zknap200x1000 turned to maximize, P left to
     grow as in the JAX package: prints status, validity, objective, the
     largest finite |P| and whether P went non-finite, and holds kernel B
     against its plain version (float32) at the run's DP inputs;
 25. (run beside phase 3, while the states are on the card) kernel A
     against its plain version at the scpnre run's last kept sweeps, where
     non-finite entries of P, pi and S must agree in place;
 27. (run before phase 26) the BARYONYX_ABLATE hooks: optimize on
     scp200x1000 for 2 s with no ablation, then once per hook (compact,
     value, flips, insert, violw), the variable set just before each run
     and restored after, then once more with no ablation (the first run
     of a series is the slowest): kernel A launched once per sweep, the
     warning printed exactly when a hook is named, a valid solution where
     the hook leaves the population's inserts and values alone (none,
     compact, flips, violw; value and insert print what they end with);
     prints each run's replica-sweeps/s beside the first unablated run's.
     At the compact run's kept sweep inputs (n_rows = m, make_order's
     order) kernel A against its plain version (phase 1's tolerances, x
     bit for bit), then timed in turns against the same states compacted
     as the plain step compacts them, ms per row block and the byte bound
     of each. Then zknap200x1000 under compact for 2 s: valid, DP
     launches equal to sweeps x blocks;
 28. (run before phase 26) the evolution step's CUDA graphs: 40 steps of
     optimize on scp200x1000 at R 2,048 (two column-sum recomputes, a
     chunk boundary, a cataclysm between chunks) through
     ``StepGraphs`` and through ``one_step``, every state tensor and the
     random stream's state bit for bit after each chunk, with the graphed
     run's peak of device memory above what the script held; then ms per
     step over 200 steps after 20, eager, graphed, graphed, eager
     (``tests/step_graph_run.py``);
 26. prints one JSON line with every kernel's numbers (kernel B's double
     instance as a row of its own), then the last line
     {"ok": true, "device": {...}}.

Any failure exits nonzero before the last line. Without a CUDA device, or
outside a checkout, it exits nonzero and prints no result.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import io
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate
F32_OPS_PER_S = 67e12  # H100 SXM float32 outside the tensor cores
F64_OPS_PER_S = F32_OPS_PER_S / 2  # and float64: half the float32 rate
SWEEPS = 3
TIME_LIMIT_S = 4.0  # the optimize budget of the main-path run
NRE_TIME_LIMIT_S = 4.0  # the optimize budget of the scpnre run
Z_TIME_LIMIT_S = 4.0  # the optimize budget of the Z-path run
SOLVE_TIME_LIMIT_S = 20.0  # solve on scp200x1000
Z_SOLVE_TIME_LIMIT_S = 10.0  # solve on zknap200x1000
FALLBACK_TIME_LIMIT_S = 5.0  # optimize through the general sweep
QSAP_TIME_LIMIT_S = 6.0  # optimize on qsap500x10
META_TIME_LIMIT_S = {"manual": 7.0, "nlopt": 4.0, "branch": 4.0}
CHECKPOINT_TIME_LIMIT_S = 3.0  # each of the two checkpoint runs
GROUP_SWEEPS = 400  # the one-rank group's fixed sweep budget...
GROUP_CHUNK = 100  # ...in 4 chunks (the cataclysm of one process needs 7)
TWO_RANKS_TIME_LIMIT_S = 4.0  # optimize at 2 ranks on one card
ROW_TIME_LIMIT_S = 3.0  # optimize through the row route
RANKS_TIMEOUT_S = 240.0  # no spawned rank outlives this
F64_SOLVE_TIME_LIMIT_S = 10.0  # float64 solve on zknap200x1000
F64_TIME_LIMIT_S = 4.0  # each float64 optimize run
CLASS_TIME_LIMIT_S = 4.0  # each optimize run of phases 23 and 24
ABLATE_TIME_LIMIT_S = 2.0  # each optimize run of phase 27
STEP_GRAPH_WARM = 20  # phase 28's timed runs: steps before the timed chunk
STEP_GRAPH_TIMED = 200  # and in it
# phase 27's runs on scp200x1000: no ablation, one run per hook, and no
# ablation again (the first run of a series is the slowest)
ABLATE_RUNS = ("", "compact", "value", "flips", "insert", "violw", "")
# hooks that leave the population's inserts and values alone: valid runs
ABLATE_VALID = ("", "compact", "flips", "violw")
SWEEP_R = 32  # replicas of the general sweep's card-against-CPU check
SWEEP_TOL = 1e-5  # absolute plus relative, on P, pi and S
DP_R = 512  # replicas of the DP parity phase (the Z path's default R)
KERNELS = ["psweep", "dpselect"]
TOL = {"P": 2e-4, "pi": 2e-4, "S": 2e-3}


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


# ---- phases 17-19 run their ranks in fresh processes (tests/spawn_ranks.py),
# so these functions live at the top level, where a spawned rank finds them


def _summary(res, raw) -> dict:
    import baryonyx_torch as bt

    return dict(
        status=res.status.name, value=res.value, loop=res.loop,
        remaining=res.remaining_constraints, method=res.method,
        annoying_variable=res.annoying_variable, replicas=res.replicas,
        block_size=res.block_size,
        solutions=[(list(s.variables), s.value) for s in res.solutions],
        valid=bool(res.solutions) and bt.is_valid_solution(raw, res),
    )


def _optimize_counted(lp: str, seed: int, **params):
    """optimize on ``lp`` with ``params`` set, kernel A's counter set to
    0 just before and read just after; (summary, launches, replica-sweeps
    per second of the run's last chunk report)."""
    import torch

    import baryonyx_torch as bt
    from baryonyx_torch.ops import psweep as pw

    ctx = bt.make_context(3)
    ctx.parameters.seed = seed
    for k, v in params.items():
        setattr(ctx.parameters, k, v)
    last = {}
    ctx.register(update=lambda rem, val, loop, elapsed, rst: last.update(
        loop=loop, elapsed=elapsed))
    raw = bt.make_problem(ctx, io.StringIO(lp))
    pw.psweep_kernel.launches = 0
    res = bt.optimize(ctx, raw)
    torch.cuda.synchronize()
    launches = pw.psweep_kernel.launches
    rate = res.replicas * last["loop"] / last["elapsed"] if last else 0.0
    return _summary(res, raw), launches, rate


def _one_rank_group(lp: str, seed: int, limit: int, chunk: int):
    """Phase 17, in a one-rank NCCL group: optimize through the group's
    path, then, the group left, through the plain path; where the two
    differ, the plain path once more (is it deterministic at all?)."""
    from baryonyx_torch.core.params import ConstraintOrder
    from baryonyx_torch.parallel import distributed

    kw = dict(limit=limit, time_limit=0.0, chunk_size=chunk,
              order=ConstraintOrder.cycle)
    grouped = _optimize_counted(lp, seed, **kw)
    distributed.shutdown()
    plain = _optimize_counted(lp, seed, **kw)
    again = None if plain[0] == grouped[0] else _optimize_counted(lp, seed, **kw)
    return grouped, plain, again


def _two_ranks(lp: str, seed: int, time_limit: float):
    """Phase 18, one of two gloo ranks on one card: optimize with 1,024
    replicas per rank, watching the first top-K exchange."""
    from baryonyx_torch.parallel import distributed
    from baryonyx_torch.solver import optimize as bopt
    from spawn_ranks import watch_first_exchange

    real = bopt.exchange_top_k
    first = watch_first_exchange()
    try:
        out = _optimize_counted(lp, seed, time_limit=time_limit,
                                thread=2 * 1024, block_size=4)
    finally:
        bopt.exchange_top_k = real
    return out, first, distributed.rank()


def _row_route(lp: str, seed: int, time_limit: float, sweeps: int, R: int,
               tol: float):
    """Phase 19, one of two gloo ranks on one card: optimize past a tiny
    device budget (the row route), then ``sweeps`` row-sharded sweeps of
    this rank's shard on the card and on the CPU from the same state and
    the same injected tie noise."""
    import os
    import time as _time

    import numpy as np
    import torch

    import baryonyx_torch as bt
    from baryonyx_torch.ops.sweep import SweepNoise
    from baryonyx_torch.parallel.mesh import make_mesh
    from baryonyx_torch.parallel.rowshard import (
        compile_row_shards,
        shard_of,
        sweep_row_sharded,
    )
    from baryonyx_torch.preprocess import unpreprocess
    from baryonyx_torch.preprocess.merge import make_merged_constraints

    os.environ["BARYONYX_HBM_BUDGET"] = "5000"
    t = _time.monotonic()
    summary, launches, _ = _optimize_counted(lp, seed, time_limit=time_limit)
    wall = _time.monotonic() - t
    del os.environ["BARYONYX_HBM_BUDGET"]

    mesh = make_mesh()
    ctx = bt.make_context(0)
    pb = bt.parse_lp(lp)
    csts = make_merged_constraints(ctx, unpreprocess(ctx, pb))
    n = len(pb.vars.names)
    cp_cpu = shard_of(compile_row_shards(csts, n, mesh.size, device="cpu"),
                      mesh.rank)
    B = 8
    gen = torch.Generator().manual_seed(seed * 1000 + mesh.rank)
    # from x = 0 every cover row is violated: the first sweep walks them all
    x0 = torch.zeros((cp_cpu.n, R), dtype=torch.int32)
    cost = torch.as_tensor(
        (1.0 + np.arange(cp_cpu.n) + 0.01 * ((np.arange(cp_cpu.n) * 37) % 61))
        / (cp_cpu.n + 1.0), dtype=torch.float32)
    kappa = torch.full((R,), 0.15)
    noise = torch.rand((sweeps, -(-cp_cpu.m // B), B, cp_cpu.Kr, R), generator=gen)
    out = {}
    for where in ("cpu", "cuda"):
        dev = torch.device(where, 0) if where == "cuda" else torch.device("cpu")
        cp = cp_cpu.to(dev)
        x = x0.to(dev)
        P = torch.zeros((cp.m, cp.Kr, R), device=dev)
        pi = torch.zeros((cp.m, R), device=dev)
        for it in range(sweeps):
            x, P, pi, rem = sweep_row_sharded(
                cp, x, P, pi, cost.to(dev), kappa.to(dev), 0.01, 0.5, None,
                mesh=mesh, block_size=B, noise=SweepNoise(noise[it].to(dev)),
            )
        out[where] = [v.cpu() for v in (x, P, pi, rem)]
    a, b = out["cpu"], out["cuda"]
    errs = {k: float((u - v).abs().max()) for k, u, v in zip(("P", "pi"), a[1:3], b[1:3])}
    close = all(torch.allclose(v, u, rtol=tol, atol=tol) for u, v in zip(a[1:3], b[1:3]))
    moved = float((a[1] != 0).any(dim=1).float().mean())
    return dict(
        optimize=summary, launches=launches, wall=wall, rank=mesh.rank,
        x_mismatches=int((a[0] != b[0]).sum()),
        rem_mismatches=int((a[3] != b[3]).sum()), errs=errs, close=close,
        moved=moved, shard=(cp_cpu.m, cp_cpu.Kr, cp_cpu.n),
    )


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=1)
    args = ap.parse_args()

    t_script = time.monotonic()
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
        n_queens_lp,
        random_knapsack_101_lp,
        random_qsap_lp,
        random_set_cover_lp,
        random_set_partition_lp,
        random_z_multiknapsack_lp,
        telebus_crew_lp,
    )
    from baryonyx_torch.ops import psweep as pw
    from baryonyx_torch.ops import zsweep as zs
    from baryonyx_torch.ops.layout import compile_problem
    from baryonyx_torch.ops.sweep import SweepNoise, sweep, violated_mask
    from baryonyx_torch.preprocess.merge import make_merged_constraints
    from baryonyx_torch.solver import common
    from baryonyx_torch.solver import optimize as bopt
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

    def run_chain(fn, cp, R, B, cost, push, delta=0.01, theta=0.5,
                  minimize=True):
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
                torch.full((R,), 0.15, device=dev), delta, theta, seed,
                torch.zeros(R, device=dev), n_rows=any_row.sum(),
                minimize=minimize, block_size=B, S=S, S_fresh=it != 0,
            )
            sched = viol | push
        torch.cuda.synchronize()
        return (x, P, pi, S, rem), shares

    counters = {"psweep": pw.psweep_kernel, "dpselect": zs.dp_select_kernel}

    class Capture:
        """Wraps a kernel's dispatcher for an optimize run: keeps copies of
        the inputs of every ``every``-th call, the last ``keep`` of them
        or, with ``first``, the first ``keep`` (and then, with ``late``,
        the last ``late`` of them apart); notes when the first call
        came."""

        def __init__(self, real, every: int, keep: int, first: bool = False,
                     late: int = 0):
            self.every = every
            self.keep = keep
            self.first = first
            self.states = collections.deque(maxlen=keep)
            self.late = collections.deque(maxlen=late)
            self.calls = 0
            self.real = real
            self.t_first = None

        def __call__(self, *a, **kw):
            if self.t_first is None:
                self.t_first = time.monotonic()
            self.calls += 1
            if self.calls % self.every == 0:
                if not (self.first and len(self.states) == self.keep):
                    self.states.append(cloned((a, kw)))
                elif self.late.maxlen:
                    self.late.append(cloned((a, kw)))
            return self.real(*a, **kw)

    def cloned(state):
        a, kw = state
        c = lambda v: v.clone() if isinstance(v, torch.Tensor) else v  # noqa: E731
        return tuple(c(v) for v in a), {k: c(v) for k, v in kw.items()}

    def run_optimize(lp, limit: float, every: int, keep: int,
                     module=pw, attr="psweep", first=False, timing=None,
                     late=0, entry=None, params=None):
        """optimize (or ``entry``: bt.solve) on ``lp`` (LP text, or a Path
        to an LP file) for ``limit`` s, with ``params`` set and
        ``module.attr`` wrapped by a Capture; every launch counter is set
        to 0 just before and read just after. Returns (raw, result,
        launches by kernel, replica-sweeps/s, captured inputs; with
        ``late``, the pair (first, last) of them); ``timing`` gets the
        seconds of the parse and of the set-up before the first sweep."""
        ctx = bt.make_context(4)
        ctx.parameters.seed = args.seed
        ctx.parameters.time_limit = limit
        for k, v in (params or {}).items():
            setattr(ctx.parameters, k, v)
        last = {}

        def on_update(remaining, value, loop, elapsed, restarts):
            last.update(loop=loop, elapsed=elapsed, value=value)

        ctx.register(update=on_update)
        t = time.monotonic()
        raw = bt.make_problem(
            ctx, str(lp) if isinstance(lp, Path) else io.StringIO(lp)
        )
        t_parse = time.monotonic() - t
        cap = Capture(getattr(module, attr), every, keep, first, late)
        setattr(module, attr, cap)
        try:
            for k in counters.values():
                k.launches = 0
            t = time.monotonic()
            result = (entry or bt.optimize)(ctx, raw)
            torch.cuda.synchronize()
            launches = {name: k.launches for name, k in counters.items()}
        finally:
            setattr(module, attr, cap.real)
        if timing is not None:
            timing.update(parse_s=t_parse,
                          setup_s=(cap.t_first or time.monotonic()) - t)
        rate = (result.replicas * last["loop"] / last["elapsed"]
                if last.get("elapsed") else float("nan"))
        states = list(cap.states)
        return (raw, result, launches, rate,
                (states, list(cap.late)) if late else states)

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
        pair its P row and pi read and written; S read and written, x
        written and (with a quadratic objective) CQ read once for each
        (variable, replica) a scheduled pair touches; the row tables, costs
        and per-replica vectors — over the
        memory rate; or its operations over the float32 rate. Per
        scheduled slot the sweep needs: the reduced cost 6, the splitmix
        hash 13, the tie noise 7, the count of keys <= 0 2, the J_bot +
        J_top order statistics and the two keys nearest 0 2 each, and
        phase B's threshold test, P, S and x updates 7."""
        R = inp.S.shape[1]
        cq = 4 if inp.CQ is not None else 0  # CQ read per touched pair
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
            + (12 + cq) * touched  # S read + written, x written, CQ read
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

    # the first states of this run for phase 3's times: hundreds of sweeps
    # on this class drive the duals of many replicas out of float32's
    # range, where an error bound on P, pi and S says little; the last ones
    # apart, for phase 25
    raw2, res2, counts2, rate2, (nre_states, nre_late) = run_optimize(
        instances["scpnre500x5000"], NRE_TIME_LIMIT_S, every=16, keep=3,
        first=True, late=2,
    )
    print(f"[optimize scpnre500x5000] status {res2.status.name} objective "
          f"{res2.value} sweeps {res2.loop} R {res2.replicas} "
          f"B {res2.block_size} replica-sweeps/s {rate2:.1f} "
          f"launches {counts2} valid "
          f"{bt.is_valid_solution(raw2, res2)}")
    del raw2, res2

    # ---- phase 3: kernel vs plain version at the main paths' states
    def kernel_at_states(name, states, reps):
        """Kernel A against its plain version at each captured state, then
        timed in turns with its first design (and with S in L2 where the
        plan keeps S resident); the plain version and the bound beside.
        Returns the instance's record (means over the states)."""
        nonlocal max_err, mismatches
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
        rec = dict(
            instance=name, R=R, B=B, m=cp.m, n=cp.n, Kr=cp.Kr,
            plan=plan._asdict(), states=len(recs), bound_by=by[0][0], **mean,
            by_state=[{k: r[k] for k in ("sched_share", "ms", "old_ms")}
                      for r in recs],
        )
        print(f"[{name}] mean over {len(recs)} states: kernel "
              f"{mean['ms']:.4f} ms/sweep, first design {mean['old_ms']:.4f} "
              f"ms/sweep, plain {mean['plain_ms']:.4f} ms/sweep, bound "
              f"{mean['bound_ms']:.5f} ms, scheduled share "
              f"{mean['sched_share']:.4f}")
        del states[:]
        torch.cuda.empty_cache()
        return rec

    per_instance = [kernel_at_states("scp200x1000", main_states, 50),
                    kernel_at_states("scpnre500x5000", nre_states, 5)]

    # ---- phase 25 (run here, while the scpnre run's states are on the
    # card): kernel A at that run's last sweeps, where non-finite entries
    # must agree in place (max_err_of)
    t = time.monotonic()
    if not nre_late:
        fail("scpnre500x5000: optimize ran too few sweeps to keep a late state")
    late_recs = []
    for i, st in enumerate(nre_late):
        a = pw.psweep_reference(*cloned(st)[0], **cloned(st)[1])
        b = pw.psweep(*cloned(st)[0], **cloned(st)[1])
        err = check(f"scpnre500x5000 late state {i}", a, b)
        max_err = max(max_err, err)
        inp = st[0]
        late_recs.append(dict(
            max_abs_err=err,
            nonfinite_P_in=int((~torch.isfinite(inp[2])).sum()),
            nonfinite_out={k: int((~torch.isfinite(v)).sum())
                           for k, v in zip(("P", "pi", "S"), b[1:4])},
            max_abs_P_in=float(inp[2][torch.isfinite(inp[2])].abs().max()),
        ))
        print(f"[scpnre500x5000 late state {i}] P entering: "
              f"{late_recs[-1]['nonfinite_P_in']} non-finite of "
              f"{inp[2].numel()}, largest finite |P| "
              f"{late_recs[-1]['max_abs_P_in']:.4g}; non-finite after the "
              f"sweep {late_recs[-1]['nonfinite_out']}, in the same places "
              f"in kernel and plain version")
        del a, b, inp
    del nre_late
    torch.cuda.empty_cache()
    print(f"[phase 25] {time.monotonic() - t:.1f} s")

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

    def dp_bound(cp, rows, R, itemsize=4, rate=F32_OPS_PER_S):
        """Least time of one DP call over the block ``rows`` and R
        replicas, counting only the rows the block sends to the DP
        (``cp.dp_row``; the kernel leaves the others alone): the bytes it
        needs (r at ``itemsize`` bytes, the row tables and the slot mask of
        the DP rows read, the chosen set written) over the memory rate, or
        its operations over ``rate``, the card's rate for the score type:
        per (row, replica) the table's set-up 1 per w; per
        slot and w the shift test, the add, the compare and two selects
        5; the argmin over w 4 per w (the range test 2, the compare and
        the select); the read-out 2 per slot. The table itself stays on
        chip in an ideal kernel and is not counted."""
        W, Kr, B = cp.Wdp, cp.Kr, rows.numel()
        n_dp = int(cp.dp_row[rows.long()].sum())
        # the chosen set [B, Kr, R] is written for every row of the block
        # (all 0 for a row that is not a DP row) and the row list read
        nbytes = (B * Kr * R + 5 * B + itemsize * n_dp * Kr * R + 5 * n_dp * Kr
                  + 12 * n_dp)
        ops = n_dp * R * (W * (1 + 5 * Kr + 4) + 2 * Kr)
        t_b = nbytes / HBM_BYTES_PER_S * 1e3
        t_o = ops / rate * 1e3
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
        b_ms, b_by = dp_bound(cp, first[1], DP_R)
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
        b_ms, b_by = dp_bound(zcp, dp_args[1], R)
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
        b_ms, b_by = dp_bound(cp, first[1], 1)
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

    # ---- phase 12: the quadratic path: optimize on qsap500x10
    build = repo / "build"
    build.mkdir(exist_ok=True)
    qsap_path = build / "qsap500x10.lp"
    qsap_path.write_text(random_qsap_lp(500, 10, seed=3))
    import baryonyx_torch.native.lp as native_lp

    native_reads = []
    real_native = native_lp.parse_lp_native

    def counted_native(path):
        pb = real_native(path)
        native_reads.append(pb is not None)
        return pb

    general_calls = [0]
    real_general = bopt.sweep

    def counted_general(*a, **kw):
        general_calls[0] += 1
        return real_general(*a, **kw)

    native_lp.parse_lp_native = counted_native
    bopt.sweep = counted_general
    qtiming = {}
    try:
        qraw, qres, qcounts, qrate, q_states = run_optimize(
            qsap_path, QSAP_TIME_LIMIT_S, every=97, keep=4, timing=qtiming,
        )
    finally:
        native_lp.parse_lp_native = real_native
        bopt.sweep = real_general
    if native_reads != [True]:
        fail(f"qsap500x10: the native LP parser did not read the file "
             f"({native_reads})")
    qvalid = bt.is_valid_solution(qraw, qres)
    qoracle = bt.compute_solution(qraw, qres)
    print(f"[optimize qsap500x10] parse {qtiming['parse_s']:.3f} s (native), "
          f"set-up to the first sweep {qtiming['setup_s']:.2f} s; status "
          f"{qres.status.name} objective {qres.value} (oracle {qoracle}) sweeps "
          f"{qres.loop} R {qres.replicas} B {qres.block_size} replica-sweeps/s "
          f"{qrate:.1f} launches {qcounts} general sweeps {general_calls[0]} "
          f"valid {qvalid} duration {qres.duration:.2f} s")
    if qres.status != bt.ResultStatus.success or not qvalid:
        fail("qsap500x10: optimize did not return a valid feasible solution")
    if not np.isfinite(qres.value) or abs(qoracle - qres.value) > 1e-6 * max(
            1.0, abs(qoracle)):
        fail(f"qsap500x10: objective {qres.value} vs the oracle's {qoracle}")
    if qcounts["psweep"] <= 0 or qcounts["psweep"] != qres.loop \
            or general_calls[0] or qcounts["dpselect"]:
        fail(f"qsap500x10: launches {qcounts}, general sweeps "
             f"{general_calls[0]}, vs sweeps {qres.loop}")
    if not q_states or q_states[0][1].get("quad_mat") is None:
        fail("qsap500x10: no sweep input with a quad_mat was kept")
    qsap_rec = {"objective": qres.value, "sweeps": qres.loop,
                "R": qres.replicas, "B": qres.block_size,
                "replica_sweeps_per_s": qrate, **qtiming}

    # ---- phase 13: kernel A's HAS_CQ variant at the qsap500x10 states
    qm = q_states[0][1]["quad_mat"]
    qx = q_states[-1][0][1].to(torch.float32)
    cq_out = torch.empty((qm.shape[0], qx.shape[1]), device=dev)
    cq_ms = timed(lambda _: torch.matmul(qm, qx, out=cq_out), None, 20,
                  graph=True)
    n_q, R_q = qm.shape[0], qx.shape[1]
    cq_bound = max((n_q * n_q + 2 * n_q * R_q) * 4 / HBM_BYTES_PER_S,
                   2.0 * n_q * n_q * R_q / F32_OPS_PER_S) * 1e3
    qsap_kernel = kernel_at_states("qsap500x10", q_states, 20)
    qsap_kernel.update(cq_matmul_ms=cq_ms, cq_matmul_bound_ms=cq_bound)
    per_instance.append(qsap_kernel)
    print(f"[qsap500x10] CQ = quad_mat @ x ([{n_q}, {n_q}] x [{n_q}, {R_q}], "
          f"float32, TF32 {torch.backends.cuda.matmul.allow_tf32}): "
          f"{cq_ms:.4f} ms, bound {cq_bound:.4f} ms (operations)")
    del qm, qx, cq_out, q_states
    torch.cuda.empty_cache()

    # ---- phase 14: the three meta-optimizer modes through the command line
    meta_recs = {}
    manual_states = []
    real_opt, real_sweep = bopt.optimize_compiled, pw.psweep
    with tempfile.TemporaryDirectory() as tmp:
        lp_path = Path(tmp) / "scp200x1000.lp"
        lp_path.write_text(instances["scp200x1000"])
        for mode, limit in META_TIME_LIMIT_S.items():
            runs = []

            def recorded(ctx, pb, device=None, hp_vectors=None):
                # the manual mode's runs over the grid: the inputs of each
                # one's 100th sweep, every replica at a combo of its own
                # (the grid turns theta slowest: it takes one value in the
                # first 625 combos, so the first run's 512 have one)
                keep = mode == "manual" and hp_vectors is not None
                if keep:
                    pw.psweep = run_cap = Capture(real_sweep, 100, 1, first=True)
                try:
                    res = real_opt(ctx, pb, device=device, hp_vectors=hp_vectors)
                finally:
                    pw.psweep = real_sweep
                if keep and len(manual_states) < 6:
                    manual_states.extend(run_cap.states)
                runs.append((res, hp_vectors is not None))
                return res

            bopt.optimize_compiled = recorded
            try:
                for k in counters.values():
                    k.launches = 0
                t = time.monotonic()
                rc = cli_main(["--quiet", f"--auto:{mode}", "--time-limit",
                               str(limit), "--seed", str(args.seed),
                               str(lp_path)])
                torch.cuda.synchronize()
                wall = time.monotonic() - t
                mcounts = {name: k.launches for name, k in counters.items()}
            finally:
                bopt.optimize_compiled = real_opt
            sols = list(Path(tmp).glob("scp200x1000.lp-*.sol"))
            if rc != 0 or len(sols) != 1:
                fail(f"--auto:{mode} returned {rc} and wrote {len(sols)} .sol "
                     f"files")
            said = io.StringIO()
            with contextlib.redirect_stdout(said):
                rc = cli_main(["--quiet", "--check", str(sols[0]), str(lp_path)])
            said = said.getvalue()
            if rc != 0 or ": valid" not in said:
                fail(f"--auto:{mode}: --check did not call the .sol valid: {said}")
            objective = float(said.strip().splitlines()[-1].split(": ")[-1])
            sols[0].unlink()
            last = runs[-1][0]
            rec = dict(
                method=last.method, objective=objective,
                R=sorted({r.replicas for r, _ in runs}),
                optimize_runs=len(runs),
                runs_with_hp_vectors=sum(hv for _, hv in runs),
                wall_s=wall, time_limit_s=limit, launches=mcounts,
            )
            meta_recs[mode] = rec
            print(f"[--auto:{mode}] method {rec['method']} objective "
                  f"{objective} R {rec['R']} optimize runs {len(runs)} "
                  f"({rec['runs_with_hp_vectors']} with per-replica "
                  f"hyperparameters) wall {wall:.2f} s launches {mcounts}; "
                  f"--check: valid")
            if mcounts["psweep"] <= 0:
                fail(f"--auto:{mode} launched the sweep kernel no time")
    if meta_recs["manual"]["runs_with_hp_vectors"] < 1:
        fail("--auto:manual ran no optimize with per-replica hyperparameters")

    # ---- phase 15: kernel A at per-replica theta and delta
    if not manual_states:
        fail("--auto:manual: no sweep input of its first runs was kept")
    thetas_seen = 1
    for i, st in enumerate(manual_states):
        delta_v, theta_v = st[0][8], st[0][9]
        if not (isinstance(delta_v, torch.Tensor) and delta_v.numel() > 1
                and isinstance(theta_v, torch.Tensor)
                and theta_v.numel() == delta_v.numel()
                and delta_v.unique().numel() > 1):
            fail("--auto:manual: a kept sweep input has no per-replica "
                 "theta and delta")
        thetas_seen = max(thetas_seen, theta_v.unique().numel())
        print(f"[per-replica theta/delta state {i}] R {theta_v.numel()}: "
              f"{theta_v.unique().numel()} thetas in "
              f"[{float(theta_v.min()):.3f}, {float(theta_v.max()):.3f}], "
              f"{delta_v.unique().numel()} deltas")
    if thetas_seen < 2:
        fail("--auto:manual: no kept sweep input has more than one theta")
    # x bit for bit, P, pi and S within TOL, then timed as phase 3 times
    mismatches_before = mismatches
    per_replica_rec = kernel_at_states(
        "scp200x1000 per-replica theta/delta", manual_states, 20)
    per_replica_rec.update(
        instance="scp200x1000, manual grid's first chunks",
        x_mismatches=mismatches - mismatches_before,
    )
    per_instance.append(per_replica_rec)
    del manual_states

    # ---- phase 16: population checkpoints
    ckpt = build / "checkpoint-scp200x1000.npz"
    ckpt.unlink(missing_ok=True)
    ckpt_runs = []
    for resume in (False, True):
        ctx = bt.make_context(4)
        ctx.parameters.seed = args.seed
        ctx.parameters.time_limit = CHECKPOINT_TIME_LIMIT_S
        ctx.parameters.checkpoint_path = str(ckpt)
        ctx.parameters.checkpoint_every = 0.0
        notices = []
        ctx.notice = lambda msg, *a: notices.append(msg.format(*a))
        raw = bt.make_problem(ctx, io.StringIO(instances["scp200x1000"]))
        for k in counters.values():
            k.launches = 0
        res = bt.optimize(ctx, raw)
        torch.cuda.synchronize()
        ccounts = {name: k.launches for name, k in counters.items()}
        resumed = any("resumed population" in m for m in notices)
        ok = res.status == bt.ResultStatus.success and bt.is_valid_solution(
            raw, res)
        ckpt_runs.append(dict(objective=res.value, sweeps=res.loop,
                              resumed=resumed, launches=ccounts))
        print(f"[checkpoint {'resume' if resume else 'write'}] objective "
              f"{res.value} sweeps {res.loop} resumed {resumed} file "
              f"{ckpt.exists()} launches {ccounts} valid {ok}")
        if not ok or not ckpt.exists() or resumed != resume:
            fail(f"checkpoint run {len(ckpt_runs)}: valid {ok}, file "
                 f"{ckpt.exists()}, resumed {resumed}")
    if ckpt_runs[1]["objective"] > ckpt_runs[0]["objective"]:
        fail(f"the resumed run is worse: {ckpt_runs}")

    # ---- phases 17-19: the process-group paths, each rank a fresh process
    # (the spawned ranks inherit this path)
    sys.path.insert(0, str(repo / "tests"))
    from spawn_ranks import exchange_kept, spawn

    t_parallel = time.monotonic()
    torch.cuda.empty_cache()
    scp = instances["scp200x1000"]

    # phase 17: a one-rank NCCL group against no group, bit for bit
    t = time.monotonic()
    (grouped, plain, plain2), = spawn(
        _one_rank_group, 1, (scp, args.seed, GROUP_SWEEPS, GROUP_CHUNK),
        device="cuda:0", backend="nccl", timeout_s=RANKS_TIMEOUT_S, threads=0)
    g_sum, g_launches, _ = grouped
    print(f"[optimize scp200x1000, 1-rank NCCL group] status {g_sum['status']} "
          f"objective {g_sum['value']} sweeps {g_sum['loop']} R "
          f"{g_sum['replicas']} B {g_sum['block_size']} annoying variable "
          f"{g_sum['annoying_variable']} kernel A launches {g_launches}; "
          f"without the group: objective {plain[0]['value']}, launches "
          f"{plain[1]}; same Result bit for bit: {g_sum == plain[0]}; "
          f"{time.monotonic() - t:.1f} s")
    if g_sum != plain[0]:
        fail(f"a one-rank group's Result differs from the plain path's (the "
             f"plain path against itself: {plain[0] == plain2[0]})")
    if not g_sum["valid"] or g_sum["status"] != "success":
        fail(f"the one-rank group's result: {g_sum['status']}, valid {g_sum['valid']}")
    if g_launches != GROUP_SWEEPS or g_sum["loop"] != GROUP_SWEEPS:
        fail(f"1-rank group: {g_launches} launches, {g_sum['loop']} sweeps")

    # phase 18: two gloo ranks on the one card
    t = time.monotonic()
    ranks = spawn(_two_ranks, 2, (scp, args.seed, TWO_RANKS_TIME_LIMIT_S),
                  device="cuda:0", backend="gloo", timeout_s=RANKS_TIMEOUT_S,
                  threads=0)
    (s0, l0, rate0), f0, _ = ranks[0]
    (s1, l1, rate1), f1, _ = ranks[1]
    holds = (exchange_kept(f1["before"][0], f0),
             exchange_kept(f0["before"][0], f1))
    print(f"[optimize scp200x1000, 2 gloo ranks on one card] status "
          f"{s0['status']} objective {s0['value']} sweeps {s0['loop']} R "
          f"{s0['replicas']} ({s0['replicas'] // 2} per rank) B "
          f"{s0['block_size']} valid {s0['valid']}; kernel A launches per rank "
          f"{[l0, l1]}; replica-sweeps/s over both ranks {rate0:.1f} (one "
          f"process, phase 2: {rate:.1f}); the first exchange kept each "
          f"rank's best in the other's population: {holds}; same Result on "
          f"both ranks "
          f"{s0 == s1}; {time.monotonic() - t:.1f} s")
    if s0 != s1:
        fail("the two ranks returned different Results")
    if not s0["valid"] or s0["status"] != "success":
        fail(f"2 ranks: {s0['status']}, valid {s0['valid']}")
    if not all(holds):
        fail("the first exchange lost a rank's best without a later "
             "candidate taking its victim slot")
    if min(l0, l1) <= 0 or l0 != s0["loop"] or l1 != s0["loop"]:
        fail(f"2 ranks: launches {[l0, l1]} vs sweeps {s0['loop']}")
    two_rec = dict(objective=s0["value"], sweeps=s0["loop"], R=s0["replicas"],
                   B=s0["block_size"], launches_per_rank=[l0, l1],
                   replica_sweeps_per_s=rate0, one_process_replica_sweeps_per_s=rate)

    # phase 19: the row route, two gloo ranks on the card
    t = time.monotonic()
    rows = spawn(_row_route, 2, (scp, args.seed, ROW_TIME_LIMIT_S, SWEEPS,
                                 SWEEP_R, SWEEP_TOL),
                 device="cuda:0", backend="gloo", timeout_s=RANKS_TIMEOUT_S,
                 threads=0)
    r0 = rows[0]["optimize"]
    row_rate = r0["loop"] / ROW_TIME_LIMIT_S
    print(f"[optimize scp200x1000, row route, 2 gloo ranks] method "
          f"{r0['method']} status {r0['status']} objective {r0['value']} "
          f"sweeps {r0['loop']} ({row_rate:.1f} sweeps/s, 16 replicas) valid "
          f"{r0['valid']} kernel A launches {[r['launches'] for r in rows]}; "
          f"wall {rows[0]['wall']:.2f} s")
    if not r0["method"].endswith("+rowshard"):
        fail(f"the row route was not taken: method {r0['method']}")
    if r0 != rows[1]["optimize"]:
        fail("the row route's two ranks returned different Results")
    if not r0["valid"] or r0["status"] != "success":
        fail(f"row route: {r0['status']}, valid {r0['valid']}")
    for r in rows:
        print(f"[row-sharded sweep, rank {r['rank']}, shard m={r['shard'][0]} "
              f"Kr={r['shard'][1]} n={r['shard'][2]}, R={SWEEP_R}] card against "
              f"CPU after {SWEEPS} sweeps: x mismatches {r['x_mismatches']}, "
              f"remaining mismatches {r['rem_mismatches']}, max|err| "
              f"{r['errs']}, rows with a moved P {r['moved']:.4f}")
        if r["x_mismatches"] or r["rem_mismatches"] or not r["close"]:
            fail(f"rank {r['rank']}: the row-sharded sweep on the card differs "
                 f"from the CPU's")
        if r["moved"] < 0.5:
            fail(f"rank {r['rank']}: the row-sharded sweep moved too little")
    print(f"[phases 17-19] {time.monotonic() - t_parallel:.1f} s")
    row_rec = dict(method=r0["method"], objective=r0["value"], sweeps=r0["loop"],
                   sweeps_per_s=row_rate,
                   sweep_max_abs_err=[r["errs"] for r in rows])

    # ---- phase 21: kernel B's double instance at random inputs
    dp64_mismatches_before = dp_mismatches
    dp64_records = []

    def dp64_record(label, dp_args, reps, **extra):
        """Kernel B in double against its plain version (bit for bit),
        then timed in turns with its first design, with its bound at
        8-byte scores and the float64 rate."""
        got = dp_check(label, dp_args)
        cp, rows_c, r = dp_args[:3]
        b_ms, b_by = dp_bound(cp, rows_c, r.shape[-1], 8, F64_OPS_PER_S)
        rec = dict(extra, R=r.shape[-1], B=r.shape[0], W=cp.Wdp, Kr=cp.Kr,
                   dtype="float64", bound_ms=b_ms, bound_by=b_by,
                   dp_rows=int(cp.dp_row[rows_c.long()].sum()),
                   chosen_share=float(got.float().mean()),
                   **dp_timed(dp_args, reps))
        print(f"[{label}] {rec['dp_rows']} DP rows of {rec['B']}: kernel "
              f"{rec['ms']:.4f} ms, first design {rec['old_ms']:.4f} ms, plain "
              f"{rec['plain_ms']:.4f} ms, bound {b_ms:.7f} ms ({b_by})")
        return rec

    t_new = time.monotonic()
    for name, lp in z_instances.items():
        cp, _, B = compiled(lp)
        dp_rows = torch.nonzero(cp.dp_row).flatten().to(torch.int32)
        n_blocks = dp_rows.numel() // B
        for R in (DP_R, 1):
            dplan = zs.dp_launch_plan(cp.Wdp, cp.Kr, R, B, itemsize=8)
            print(f"[{name} float64 R={R}] launch plan: {dplan}, "
                  f"{dplan.threads} threads x {dplan.grid(R, B)} CUDA blocks "
                  f"(float32: {zs.dp_launch_plan(cp.Wdp, cp.Kr, R, B)})")
            if dplan.variant != "shared":
                fail(f"{name} float64: the launch plan takes the "
                     f"{dplan.variant} variant")
            for minimize in (True, False):
                for blk in range(n_blocks):
                    rows_c = dp_rows[blk * B:(blk + 1) * B].contiguous()
                    r = torch.randn((B, cp.Kr, R), generator=gen, device=dev,
                                    dtype=torch.float64)
                    mask = cp.row_mask[rows_c.long()].contiguous()
                    dp_args = (cp, rows_c, r, mask, minimize)
                    dp_check(f"{name} float64 R={R} block {blk}", dp_args)
                    if blk == 0 and minimize:
                        first = dp_args
            print(f"[{name} float64 R={R}] DP kernel bit-exact on {n_blocks} "
                  f"blocks x 2 objectives")
            dp64_records.append(dp64_record(
                f"{name} float64 R={R} random", first, 20 if R > 1 else 50,
                instance=name, inputs="random", plan=dplan._asdict()))
        del cp, first, dp_args
        torch.cuda.empty_cache()

    # ---- phase 22: float64 on the card: solve and optimize on
    # zknap200x1000 (kernel B's double instance), optimize on scp200x1000
    # (the general sweep); then phase 21 at the Z runs' DP inputs
    f64 = {"float_type": bt.FloatType.float64}
    zlp = z_instances["zknap200x1000"]
    zcp = compiled(zlp)[0]
    z64 = {}
    # every 37th DP call (5 mod the 32 blocks of a sweep): the solve's
    # first 3, which fall on blocks 4, 9 and 14 (real rows, whatever the
    # run's length), the optimize run's last 6
    for label, entry, limit, keep, first in (
            ("solve", bt.solve, F64_SOLVE_TIME_LIMIT_S, 3, True),
            ("optimize", bt.optimize, F64_TIME_LIMIT_S, 6, False)):
        raw64, res64, counts64, rate64, states64 = run_optimize(
            zlp, limit, every=37, keep=keep, module=zs, attr="dp_select",
            first=first, entry=entry, params=f64)
        sweeps = res64.sweeps if entry is bt.solve else res64.loop
        R64 = res64.replicas if entry is bt.optimize else 1  # solve: one
        B64 = (bt.SolverParameters().block_size if entry is bt.solve
               else res64.block_size)
        blocks = -(-zcp.m // B64)
        ok = bool(res64.solutions) and bt.is_valid_solution(raw64, res64)
        print(f"[{label} zknap200x1000 float64] status {res64.status.name} "
              f"objective {res64.value} sweeps {sweeps} R {R64} B "
              f"{B64} launches {counts64} (blocks per sweep {blocks}) valid {ok}"
              + (f" replica-sweeps/s {rate64:.1f}" if entry is bt.optimize else ""))
        if res64.status != bt.ResultStatus.success or not ok:
            fail(f"{label} zknap200x1000 float64: no valid feasible solution")
        if counts64["dpselect"] <= 0 or counts64["dpselect"] != sweeps * blocks \
                or counts64["psweep"]:
            fail(f"{label} zknap200x1000 float64: launches {counts64} vs "
                 f"{sweeps} sweeps x {blocks} blocks")
        if not states64 or states64[0][0][2].dtype != torch.float64:
            fail(f"{label} zknap200x1000 float64: no float64 DP input kept")
        z64[label] = dict(objective=res64.value, sweeps=sweeps,
                          R=R64, B=B64, launches=counts64,
                          states=states64)
        if entry is bt.optimize:
            z64[label]["replica_sweeps_per_s"] = rate64
    graw, gres, gcounts, grate, _ = run_optimize(
        instances["scp200x1000"], F64_TIME_LIMIT_S, every=1 << 30, keep=1,
        module=bopt, attr="sweep", params=f64)
    gok = bool(gres.solutions) and bt.is_valid_solution(graw, gres)
    print(f"[optimize scp200x1000 float64] status {gres.status.name} objective "
          f"{gres.value} sweeps {gres.loop} R {gres.replicas} B "
          f"{gres.block_size} replica-sweeps/s {grate:.1f} launches {gcounts} "
          f"valid {gok}")
    if gres.status != bt.ResultStatus.success or not gok:
        fail("optimize scp200x1000 float64: no valid feasible solution")
    if gcounts["psweep"] or gcounts["dpselect"] or gres.loop <= 0:
        fail(f"optimize scp200x1000 float64 launched a kernel: {gcounts}")
    f64_rec = dict(
        {k: {kk: vv for kk, vv in v.items() if kk != "states"}
         for k, v in z64.items()},
        optimize_scp200x1000=dict(objective=gres.value, sweeps=gres.loop,
                                  R=gres.replicas, launches=gcounts,
                                  replica_sweeps_per_s=grate))
    for label in ("solve", "optimize"):  # the optimize run's record first
        recs = [dp64_record(f"zknap200x1000 float64 {label} captured {i}",
                            cloned(st)[0], 50, instance="zknap200x1000",
                            inputs=f"captured ({label})")
                for i, st in enumerate(z64[label].pop("states"))]
        mean = {k: sum(r[k] for r in recs) / len(recs)
                for k in ("ms", "old_ms", "plain_ms", "bound_ms")}
        dp64_records.insert(0, dict(recs[0], **mean, states=len(recs)))
    dp64_mismatches = dp_mismatches - dp64_mismatches_before
    del z64
    torch.cuda.empty_cache()

    # ---- phase 23: equality classes at the JAX package's battery sizes
    class_instances = {
        "sppus145": random_set_partition_lp(145, 48, 3, (1, 1000), 30000, seed=3),
        "tele1200": telebus_crew_lp(1200, 20, 4, seed=2),
        "nq100": n_queens_lp(100),
    }
    class_recs = {}
    for name, lp in class_instances.items():
        craw, cres, ccounts, crate, cstates = run_optimize(
            lp, CLASS_TIME_LIMIT_S, every=32, keep=2)
        cvalid = bool(cres.solutions) and bt.is_valid_solution(craw, cres)
        coracle = bt.compute_solution(craw, cres) if cres.solutions else None
        ccp = cstates[0][0][0] if cstates else None
        shape = (f"m {ccp.m} ({ccp.m_real} rows, {int(ccp.is_eq[:ccp.m_real].sum())}"
                 f" equalities) n {ccp.n} Kr {ccp.Kr}" if ccp is not None else "")
        print(f"[optimize {name}] {shape} status {cres.status.name} objective "
              f"{cres.value} (oracle {coracle}) sweeps {cres.loop} R "
              f"{cres.replicas} B {cres.block_size} replica-sweeps/s "
              f"{crate:.1f} launches {ccounts} valid {cvalid} duration "
              f"{cres.duration:.2f} s")
        if cres.status != bt.ResultStatus.success or not cvalid:
            fail(f"{name}: optimize did not return a valid feasible solution")
        if abs(coracle - cres.value) > 1e-6 * max(1.0, abs(coracle)):
            fail(f"{name}: objective {cres.value} vs the oracle's {coracle}")
        if ccounts["psweep"] <= 0 or ccounts["psweep"] != cres.loop \
                or ccounts["dpselect"]:
            fail(f"{name}: launches {ccounts} vs sweeps {cres.loop}")
        rec = kernel_at_states(name, cstates, 10 if name == "sppus145" else 20)
        rec.update(optimize=dict(objective=cres.value, sweeps=cres.loop,
                                 R=cres.replicas, B=cres.block_size,
                                 replica_sweeps_per_s=crate),
                   m_real=ccp.m_real, equalities=int(ccp.is_eq[:ccp.m_real].sum()))
        per_instance.append(rec)
        class_recs[name] = ccounts["psweep"]
        del cstates, ccp

    # ---- phase 24: +-1 rows and maximization
    kraw, kres, kcounts, krate, _ = run_optimize(
        random_knapsack_101_lp(2000, 64, seed=5), CLASS_TIME_LIMIT_S,
        every=1 << 30, keep=1, module=bopt, attr="sweep")
    kvalid = bool(kres.solutions) and bt.is_valid_solution(kraw, kres)
    koracle = bt.compute_solution(kraw, kres) if kres.solutions else None
    print(f"[optimize knapsack101 2000x64, maximize] status {kres.status.name} "
          f"objective {kres.value} (oracle {koracle}) sweeps {kres.loop} R "
          f"{kres.replicas} B {kres.block_size} replica-sweeps/s {krate:.1f} "
          f"launches {kcounts} valid {kvalid}")
    if kres.status != bt.ResultStatus.success or not kvalid:
        fail("knapsack101 2000x64: optimize did not return a valid solution")
    if abs(koracle - kres.value) > 1e-6 * max(1.0, abs(koracle)):
        fail(f"knapsack101 2000x64: objective {kres.value} vs the oracle's "
             f"{koracle}")
    if kcounts["psweep"] or kcounts["dpselect"] or kres.loop <= 0:
        fail(f"knapsack101 2000x64 launched a kernel: {kcounts}")

    # kernel A's non-unit variant, maximizing, at the largest knapsack-101
    # instance whose selection needs no sort (its rows read middle ranks)
    kcp, kR, kB = compiled(random_knapsack_101_lp(22, 64, seed=5))
    if not kcp.sel_reduction_ok or kcp.all_unit_pos or kR != 2048:
        fail(f"knapsack101 22x64: sel_reduction_ok {kcp.sel_reduction_ok}, "
             f"all_unit_pos {kcp.all_unit_pos}, R {kR}")
    kcost = torch.as_tensor(
        1.0 + np.arange(kcp.n) + 0.01 * ((np.arange(kcp.n) * 37) % 61),
        dtype=torch.float32, device=dev)
    kpush = torch.ones((1, kR), dtype=torch.bool, device=dev)
    before = pw.psweep_kernel.launches
    a, kshares = run_chain(pw.psweep_reference, kcp, kR, kB, kcost, kpush,
                           minimize=False)
    b, _ = run_chain(pw.psweep, kcp, kR, kB, kcost, kpush, minimize=False)
    kmoved = float((b[1][: kcp.m_real] != 0).any(dim=1).float().mean())
    print(f"[knapsack101 22x64, maximize] m {kcp.m} ({kcp.m_real} rows) n "
          f"{kcp.n} Kr {kcp.Kr} R {kR} B {kB}, plan "
          f"{pw.launch_plan(kcp.n, kcp.Kr, kR, kB)}; scheduled share per sweep "
          f"{kshares}, pairs with a moved P {kmoved:.4f}, kernel launches "
          f"{pw.psweep_kernel.launches - before}")
    if kmoved < 0.5 or pw.psweep_kernel.launches - before != SWEEPS:
        fail("knapsack101 22x64: the chain moved too little or did not launch "
             "the kernel")
    kerr = check("knapsack101 22x64 maximize chain", a, b)
    max_err = max(max_err, kerr)
    non_unit_rec = dict(instance="knapsack101 22x64 (random_knapsack_101_lp(22, "
                        "64, seed=5)), maximize", m=kcp.m, n=kcp.n, Kr=kcp.Kr,
                        R=kR, B=kB, max_abs_err=kerr, moved=kmoved)
    del a, b, kcp

    # zknap200x1000 turned to maximize: P is left to grow, as in the JAX
    # package; kernel B against its plain version at the run's DP inputs
    zmax_lp = "maximize\n" + zlp.split("\n", 1)[1]
    track = {"max": torch.zeros((), device=dev),
             "nonfinite": torch.zeros((), dtype=torch.bool, device=dev)}
    real_z = zs.z_sweep

    def tracked(*a, **kw):
        out = real_z(*a, **kw)
        fin = torch.isfinite(out[1])
        track["max"] = torch.maximum(
            track["max"], torch.where(fin, out[1].abs(), 0.0).amax())
        track["nonfinite"] |= ~fin.all()
        return out

    zs.z_sweep = tracked
    try:
        mraw, mres, mcounts, mrate, m_states = run_optimize(
            zmax_lp, CLASS_TIME_LIMIT_S, every=37, keep=3, module=zs,
            attr="dp_select")
    finally:
        zs.z_sweep = real_z
    mvalid = bool(mres.solutions) and bt.is_valid_solution(mraw, mres)
    zmax_rec = dict(status=mres.status.name, valid=mvalid, objective=mres.value,
                    sweeps=mres.loop, R=mres.replicas, B=mres.block_size,
                    max_abs_P=float(track["max"]),
                    P_went_nonfinite=bool(track["nonfinite"]),
                    launches=mcounts, replica_sweeps_per_s=mrate)
    print(f"[optimize zknap200x1000, maximize] status {mres.status.name} valid "
          f"{mvalid} objective {mres.value} sweeps {mres.loop} R {mres.replicas}"
          f" largest finite |P| {zmax_rec['max_abs_P']:.6g}, P went non-finite "
          f"{zmax_rec['P_went_nonfinite']}; launches {mcounts}")
    mblocks = -(-zcp.m // mres.block_size)
    if mcounts["dpselect"] != mres.loop * mblocks or mcounts["psweep"]:
        fail(f"zknap200x1000 maximize: launches {mcounts} vs {mres.loop} sweeps"
             f" x {mblocks} blocks")
    if not m_states:
        fail("zknap200x1000 maximize: no DP input kept")
    zmax_dp = []
    for i, st in enumerate(m_states):
        dp_args = cloned(st)[0]
        got = dp_check(f"zknap200x1000 maximize captured {i}", dp_args)
        r = dp_args[2]
        zmax_dp.append(dict(
            nonfinite_r=int((~torch.isfinite(r)).sum()),
            max_abs_r=float(torch.where(torch.isfinite(r), r.abs(), 0).max()),
            chosen_share=float(got.float().mean())))
        print(f"[zknap200x1000 maximize captured {i}] bit-exact; reduced costs: "
              f"{zmax_dp[-1]['nonfinite_r']} non-finite, largest finite "
              f"|r| {zmax_dp[-1]['max_abs_r']:.6g}")
    zmax_rec["dp_inputs"] = zmax_dp
    del m_states, zcp
    print(f"[phases 21-24] {time.monotonic() - t_new:.1f} s")

    # ---- phase 27: the BARYONYX_ABLATE hooks on the card
    t27 = time.monotonic()

    def ablated(token, lp, every, keep, **kw):
        """run_optimize with BARYONYX_ABLATE=token (unset for ""), the
        variable restored after; the warnings the run printed."""
        prev = os.environ.pop("BARYONYX_ABLATE", None)
        if token:
            os.environ["BARYONYX_ABLATE"] = token
        out = io.StringIO()
        try:
            with contextlib.redirect_stdout(out):
                got = run_optimize(lp, ABLATE_TIME_LIMIT_S, every, keep, **kw)
        finally:
            os.environ.pop("BARYONYX_ABLATE", None)
            if prev is not None:
                os.environ["BARYONYX_ABLATE"] = prev
        return got, "BARYONYX_ABLATE=" in out.getvalue()

    ablate_recs = {}
    compact_states = []
    for token in ABLATE_RUNS:
        (araw, ares, acounts, arate, astates), warned = ablated(
            token, instances["scp200x1000"], every=64, keep=4)
        avalid = bool(ares.solutions) and bt.is_valid_solution(araw, ares)
        name = token or ("none, again" if "none" in ablate_recs else "none")
        ablate_recs[name] = dict(
            status=ares.status.name, valid=avalid, objective=ares.value,
            sweeps=ares.loop, R=ares.replicas, B=ares.block_size,
            replica_sweeps_per_s=arate, launches=acounts, warned=warned)
        rel = arate / ablate_recs["none"]["replica_sweeps_per_s"]
        print(f"[ablate {name}] status {ares.status.name} valid {avalid} "
              f"objective {ares.value} sweeps {ares.loop} R {ares.replicas} "
              f"B {ares.block_size} replica-sweeps/s {arate:.1f} ({rel:.3f} "
              f"of the first unablated run) launches {acounts} warned "
              f"{warned}")
        if token in ABLATE_VALID and (
                ares.status != bt.ResultStatus.success or not avalid):
            fail(f"BARYONYX_ABLATE={token}: no valid feasible solution")
        if acounts["psweep"] <= 0 or acounts["psweep"] != ares.loop \
                or acounts["dpselect"]:
            fail(f"BARYONYX_ABLATE={token}: launches {acounts} vs sweeps "
                 f"{ares.loop}")
        if warned != bool(token):
            fail(f"BARYONYX_ABLATE={token}: warning printed {warned}")
        if token == "compact":
            compact_states = astates
        del araw, ares, astates

    # kernel A over every row block (n_rows = m, the order as make_order
    # gave it) against its plain version, then timed in turns with the
    # same states compacted as the plain step compacts them
    if not compact_states:
        fail("BARYONYX_ABLATE=compact: too few sweeps to keep a state")
    compact_recs = []
    for i, st in enumerate(compact_states):
        a, kw = cloned(st)
        cp, order, sched = a[0], a[6], a[5]
        unpermuted = bool(
            (order[:cp.m].sort().values
             == torch.arange(cp.m, device=dev, dtype=order.dtype)).all()
            and (order[cp.m:] == cp.m).all())
        if kw["n_rows"] != cp.m or not unpermuted:
            fail(f"compact state {i}: n_rows {kw['n_rows']} (m {cp.m}), "
                 f"every row once before the sentinel {unpermuted}")
        ref = pw.psweep_reference(*cloned(st)[0], **cloned(st)[1])
        got = pw.psweep(*cloned(st)[0], **cloned(st)[1])
        err = check(f"compact state {i}", ref, got)
        max_err = max(max_err, err)
        mismatches += compare(ref, got)[0]
        del ref, got
        padded = torch.cat([sched.any(dim=1), sched.new_zeros(1)])[
            order.long().clamp(max=cp.m)]
        order_c = order[torch.argsort((~padded).to(torch.int8), stable=True)]
        comp = (a[:6] + (order_c,) + a[7:],
                dict(kw, n_rows=padded.sum(dtype=torch.int32)))
        inp_all, inp_c = prepared(st), prepared(comp)
        B = inp_all.Bb
        ms = in_turns({"every_block_ms": lambda _: pw.psweep_kernel(inp_all),
                       "compacted_ms": lambda _: pw.psweep_kernel(inp_c)},
                      None, 50)
        b_all, by_all, share = bound(cp, inp_all)
        b_c, by_c, _ = bound(cp, inp_c)
        blocks_c = -(-int(inp_c.n_rows) // B)
        compact_recs.append(dict(
            **ms, blocks=cp.m // B, compacted_blocks=blocks_c,
            bound_ms=b_all, bound_by=by_all, compacted_bound_ms=b_c,
            compacted_bound_by=by_c, sched_share=share, max_abs_err=err,
            plain_ms=timed(pw._sweep_plain, prepared(st), 1)))
        r = compact_recs[-1]
        print(f"[compact state {i}] scheduled share {share:.4f}: every row "
              f"block ({r['blocks']}) {r['every_block_ms']:.4f} ms, "
              f"{1e3 * r['every_block_ms'] / r['blocks']:.2f} us per block, "
              f"bound {b_all:.5f} ms ({by_all}); compacted "
              f"({blocks_c} blocks) {r['compacted_ms']:.4f} ms, "
              f"{1e3 * r['compacted_ms'] / max(blocks_c, 1):.2f} us per block, "
              f"bound {b_c:.5f} ms ({by_c}); plain {r['plain_ms']:.4f} ms")
        del inp_all, inp_c, comp
    compact_rec = dict(
        instance="scp200x1000, every row block (BARYONYX_ABLATE=compact)",
        states=len(compact_recs), m=cp.m, B=B,
        **{k: sum(r[k] for r in compact_recs) / len(compact_recs)
           for k in ("every_block_ms", "compacted_ms", "bound_ms",
                     "compacted_bound_ms", "plain_ms", "sched_share",
                     "compacted_blocks")},
        by_state=compact_recs)
    print(f"[compact] mean over {len(compact_recs)} states: every row block "
          f"{compact_rec['every_block_ms']:.4f} ms/sweep, compacted "
          f"{compact_rec['compacted_ms']:.4f} ms/sweep "
          f"({compact_rec['compacted_blocks']:.1f} blocks of {cp.m // B})")
    del compact_states, cp

    # the Z path under compact: its sweep walks every block already
    (zaraw, zares, zacounts, zarate, zast), zwarned = ablated(
        "compact", z_instances["zknap200x1000"], every=37, keep=1,
        module=zs, attr="dp_select")
    zavalid = bool(zares.solutions) and bt.is_valid_solution(zaraw, zares)
    zablocks = -(-zast[0][0][0].m // zares.block_size) if zast else 0
    zablate_rec = dict(status=zares.status.name, valid=zavalid,
                       objective=zares.value, sweeps=zares.loop,
                       R=zares.replicas, B=zares.block_size,
                       replica_sweeps_per_s=zarate, launches=zacounts,
                       blocks=zablocks, warned=zwarned)
    print(f"[ablate compact, zknap200x1000] status {zares.status.name} valid "
          f"{zavalid} objective {zares.value} sweeps {zares.loop} "
          f"replica-sweeps/s {zarate:.1f} launches {zacounts} (blocks per "
          f"sweep {zablocks}) warned {zwarned}")
    if zares.status != bt.ResultStatus.success or not zavalid or not zwarned:
        fail("zknap200x1000 under compact: no valid solution or no warning")
    if zacounts["dpselect"] <= 0 or zacounts["psweep"] \
            or zacounts["dpselect"] != zares.loop * zablocks:
        fail(f"zknap200x1000 under compact: launches {zacounts} vs "
             f"{zares.loop} sweeps x {zablocks} blocks")
    del zaraw, zares, zast
    torch.cuda.empty_cache()
    print(f"[phase 27] {time.monotonic() - t27:.1f} s")

    # ---- phase 28: the evolution step's CUDA graphs against one_step
    t28 = time.monotonic()
    import step_graph_run as sgr

    graw = bt.parse_lp(instances["scp200x1000"])
    geager = sgr.run_plan(bt, graw, dev, graphed=False, seed=args.seed)
    torch.cuda.reset_peak_memory_stats(dev)
    gheld = torch.cuda.memory_allocated(dev)
    ggraphed = sgr.run_plan(bt, graw, dev, graphed=True, seed=args.seed)
    gpeak = torch.cuda.max_memory_allocated(dev) - gheld
    gbad = sgr.mismatches(ggraphed, geager)
    print(f"[step graphs] rule {ggraphed['rule']} R {ggraphed['result'].replicas} "
          f"plan {sgr.PLAN}: mismatched fields by item {gbad}; peak {gpeak} B "
          f"above the {gheld} B held before")
    if not ggraphed["rule"] or gbad:
        fail(f"step graphs: rule {ggraphed['rule']}, mismatches {gbad}")
    gms = {"eager": [], "graphed": []}
    for graphed in (False, True, True, False):
        r = sgr.run_plan(bt, graw, dev, graphed=graphed, seed=args.seed,
                         plan=(STEP_GRAPH_WARM, STEP_GRAPH_TIMED))
        gms["graphed" if graphed else "eager"].append(
            1e3 * r["seconds"][1] / STEP_GRAPH_TIMED)
    step_graph_rec = dict(rule=ggraphed["rule"], plan=list(sgr.PLAN),
                          mismatches=gbad, memory_peak_bytes=gpeak,
                          ms_per_step=gms, timed_steps=STEP_GRAPH_TIMED)
    print(f"[step graphs] ms per step over {STEP_GRAPH_TIMED} steps, in turns: "
          f"eager {gms['eager']}, graphed {gms['graphed']}")
    del graw, geager, ggraphed
    torch.cuda.empty_cache()
    print(f"[phase 28] {time.monotonic() - t28:.1f} s")

    # ---- phase 26: the kernels line, then the result line
    print(f"[chip_smoke] {time.monotonic() - t_script:.1f} s")
    main = per_instance[0]
    print(json.dumps({"kernels": [{
        "name": "psweep",
        "route": "cuda",
        "source": "baryonyx_torch/csrc/psweep.cu",
        "replaces": "JAX package ops/psweep.py:225 (_make_kernel)",
        "launches": launches,
        "launches_by_path": {"optimize scp200x1000": launches,
                             "solve scp200x1000": solve_rec["launches"]["psweep"],
                             "optimize scp200x1000+card": fcounts["psweep"],
                             "optimize qsap500x10": qcounts["psweep"],
                             **{f"--auto:{m}": r["launches"]["psweep"]
                                for m, r in meta_recs.items()},
                             "checkpoint write": ckpt_runs[0]["launches"]["psweep"],
                             "checkpoint resume": ckpt_runs[1]["launches"]["psweep"],
                             "optimize scp200x1000, 1-rank group": g_launches,
                             "optimize scp200x1000, 2 ranks": l0 + l1,
                             **{f"optimize {name}": n
                                for name, n in class_recs.items()},
                             "optimize scp200x1000 float64":
                                 f64_rec["optimize_scp200x1000"]["launches"]["psweep"],
                             "optimize knapsack101 2000x64": kcounts["psweep"],
                             **{(f"optimize scp200x1000, BARYONYX_ABLATE={t}"
                                 if not t.startswith("none") else
                                 f"optimize scp200x1000, 2 s, {t}"):
                                r["launches"]["psweep"]
                                for t, r in ablate_recs.items()}},
        "max_abs_err": max_err,
        "mismatches": mismatches,
        "ms": main["ms"],
        "plain_ms": main["plain_ms"],
        "bound_ms": main["bound_ms"],
        "bound_by": main["bound_by"],
        "library_ms": None,
        "instances": per_instance,
        "per_replica_theta_delta": per_replica_rec,
        "scpnre500x5000_late_states": late_recs,
        "non_unit_maximize": non_unit_rec,
        "optimize": optimize_rec,
        "optimize_qsap500x10": qsap_rec,
        "every_row_block": compact_rec,
        "ablate": ablate_recs,
    }, {
        "name": "dpselect",
        "route": "cuda",
        "source": "baryonyx_torch/csrc/dpselect.cu",
        "replaces": "JAX package ops/zsweep.py:125 (_dp_select_pallas)",
        "launches": zcounts["dpselect"],
        "launches_by_path": {"optimize zknap200x1000": zcounts["dpselect"],
                             "solve zknap200x1000": zcounts1["dpselect"],
                             "optimize zknap200x1000, maximize":
                                 mcounts["dpselect"],
                             "optimize zknap200x1000, BARYONYX_ABLATE=compact":
                                 zacounts["dpselect"]},
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
        "optimize_maximize": zmax_rec,
        "optimize_compact": zablate_rec,
    }, {
        "name": "dpselect<double>",
        "route": "cuda",
        "source": "baryonyx_torch/csrc/dpselect.cu",
        "replaces": "JAX package ops/zsweep.py:125 (_dp_select_pallas; in "
                    "float64 the JAX package runs _dp_select, :42)",
        "launches": f64_rec["optimize"]["launches"]["dpselect"],
        "launches_by_path": {
            "optimize zknap200x1000 float64":
                f64_rec["optimize"]["launches"]["dpselect"],
            "solve zknap200x1000 float64": f64_rec["solve"]["launches"]["dpselect"]},
        "max_abs_err": dp_max_err,
        "mismatches": dp64_mismatches,
        "ms": dp64_records[0]["ms"],
        "plain_ms": dp64_records[0]["plain_ms"],
        "bound_ms": dp64_records[0]["bound_ms"],
        "bound_by": dp64_records[0]["bound_by"],
        "library_ms": None,
        "instances": dp64_records,
        "float64_runs": f64_rec,
    }], "general_sweep": sweep_recs, "solve": solve_rec,
        "optimize_general_sweep": fallback_rec, "meta": meta_recs,
        "checkpoint": ckpt_runs, "two_ranks": two_rec, "row_route": row_rec,
        "step_graphs": step_graph_rec}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
