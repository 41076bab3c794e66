"""Where one step's time goes on a CUDA device, in optimize and in solve
mode.

    python -m baryonyx_torch.step_profile [--seed N] [--out DIR]

Runs ``optimize`` for its default budget of 1000 sweeps in fixed chunks,
on each instance in turn: scp200x1000
(random_set_cover_lp(200, 1000, 0.02, seed=41), the main path, whose
sweep is the fused sweep kernel), zknap200x1000
(random_z_multiknapsack_lp(200, 1000, seed=2), the Z path, whose long
rows go to the knapsack DP kernel) and qsap500x10
(random_qsap_lp(500, 10, seed=3), a quadratic objective: the fused sweep
kernel with CQ = quad_mat @ x, a float32 matrix product, at its entry,
and the objective's quadratic term gathered per replica). The fourth
chunk is traced with
torch.profiler, started and stopped from the progress callback so that
set-up and warm-up stay outside the window. Prints, and writes to
DIR/profile.json: the wall time per step of the untraced chunk before it,
the device time per step summed over all kernels and over the instance's
hand-written kernel, the device idle share (1 - device time / wall time),
and the ten kernels and the ten host ops that take the most time in the
traced chunk; and the device time per step by kind of kernel: the
hand-written kernel, matrix products (``gemm``: on qsap500x10 the CQ
product), matrix-vector products (``gemv``: the objective values),
gathers and index kernels (``index``: on qsap500x10 mostly the quadratic
term's x[qa] and x[qb]), and the rest of the glue.

Then ``solve`` (one replica, default parameters) on the same two
instances: its sweeps from the 20th on, of the annealed loop and the push
rounds as they come, 80 untraced for the wall time per sweep and the
next 80 traced (40 and 40 on zknap200x1000); the same numbers per sweep,
and how many of each window's sweeps were push sweeps over every row.
"""

from __future__ import annotations

import argparse
import io
import json
import subprocess
import time
from pathlib import Path

import torch

import baryonyx_torch as bt
from baryonyx_torch.generators import (
    random_qsap_lp,
    random_set_cover_lp,
    random_z_multiknapsack_lp,
)

# name: (LP text, steps per chunk, the hand-written kernel's symbol)
INSTANCES = {
    "scp200x1000": (
        lambda: random_set_cover_lp(200, 1000, 0.02, seed=41), 100, "psweep_kernel"
    ),
    "zknap200x1000": (
        lambda: random_z_multiknapsack_lp(200, 1000, seed=2), 25, "dpselect_kernel"
    ),
    "qsap500x10": (
        lambda: random_qsap_lp(500, 10, seed=3), 100, "psweep_kernel"
    ),
}


# solve mode: sweeps skipped before the windows, sweeps per window
SOLVE_WINDOWS = {"scp200x1000": (20, 80), "zknap200x1000": (20, 40)}


def _device_us(evt) -> float:
    for name in ("self_device_time_total", "self_cuda_time_total"):
        v = getattr(evt, name, None)
        if v is not None:
            return float(v)
    return 0.0


def profile(name: str, seed: int, card: str) -> dict:
    lp, chunk, kernel = INSTANCES[name]
    prof = torch.profiler.profile(
        activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA,
        ],
    )
    calls = []  # (monotonic time, sweeps) at the end of every chunk

    def on_update(remaining, value, loop, elapsed, restarts):
        # chunk 3 runs untraced, for the wall time per step; the trace
        # covers chunk 4 (the profiler's own overhead slows it and the
        # chunks after it, so their wall times are not used)
        calls.append((time.monotonic(), loop))
        if len(calls) == 3:
            prof.start()
        elif len(calls) == 4:
            prof.stop()

    ctx = bt.make_context(0)
    ctx.parameters.seed = seed
    ctx.parameters.chunk_size = chunk  # no time limit: fixed chunks
    ctx.register(update=on_update)
    raw = bt.make_problem(ctx, io.StringIO(lp()))
    result = bt.optimize(ctx, raw)
    if len(calls) < 4:
        raise SystemExit(f"step_profile: only {len(calls)} chunks ran")
    traced_s = calls[3][0] - calls[2][0]
    steps = calls[3][1] - calls[2][1]
    wall_s = calls[2][0] - calls[1][0]
    if calls[2][1] - calls[1][1] != steps:
        raise SystemExit("step_profile: chunks of unequal length")
    return dict(
        card=card, instance=name, mode="optimize", R=result.replicas,
        B=result.block_size, traced_chunk_wall_ms=traced_s * 1e3,
        **_summary(prof, steps, wall_s, kernel),
    )


def _summary(prof, steps: int, wall_s: float, kernel: str) -> dict:
    """Per-step numbers of a traced window of ``steps`` steps, beside the
    wall time ``wall_s`` of as many untraced steps."""
    events = prof.key_averages()
    # device activity only (kernels, copies): an aten op's own row repeats
    # the time of the kernels it launched
    dev = sorted(
        (
            (e.key, _device_us(e), e.count) for e in events
            if e.device_type == torch.autograd.DeviceType.CUDA
            and _device_us(e) > 0
        ),
        key=lambda t: -t[1],
    )
    host = sorted(
        ((e.key, float(e.self_cpu_time_total), e.count) for e in events),
        key=lambda t: -t[1],
    )
    device_us = sum(t[1] for t in dev)
    kernel_us = sum(t[1] for t in dev if kernel in t[0])
    kinds = {"gemm": 0.0, "gemv": 0.0, "index": 0.0}
    for key, us, _ in dev:
        low = key.lower()
        kind = next((k for k in ("gemm", "gemv") if k in low), None)
        if kind is None and ("index" in low or "gather" in low):
            kind = "index"
        if kind is not None and kernel not in key:
            kinds[kind] += us
    return dict(
        kernel=kernel,
        chunk_steps=steps,
        step_wall_ms=wall_s * 1e3 / steps,
        device_ms_per_step=device_us / 1e3 / steps,
        kernel_ms_per_step=kernel_us / 1e3 / steps,
        device_kernel_launches_per_step=sum(t[2] for t in dev) / steps,
        device_idle_share=1.0 - device_us / 1e6 / wall_s,
        kernel_share_of_wall=kernel_us / 1e6 / wall_s,
        **{f"{k}_ms_per_step": v / 1e3 / steps for k, v in kinds.items()},
        other_glue_ms_per_step=(device_us - kernel_us - sum(kinds.values()))
        / 1e3 / steps,
        top_device=[dict(name=k, ms=v / 1e3, count=c) for k, v, c in dev[:10]],
        top_host=[dict(name=k, ms=v / 1e3, count=c) for k, v, c in host[:10]],
    )


class _Done(Exception):
    """The traced window is over: nothing more of the solve is needed."""


def profile_solve(name: str, seed: int, card: str) -> dict:
    """The same numbers for solve mode's sweeps: ``solver.solve._step`` is
    wrapped to mark the windows (the device is drained at each mark)."""
    from baryonyx_torch.solver import solve as sv

    lp, _, kernel = INSTANCES[name]
    skip, steps = SOLVE_WINDOWS[name]
    prof = torch.profiler.profile(
        activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA,
        ],
    )
    real = sv._step
    marks = {}
    calls = 0
    pushes = [0, 0]  # objective-amplified sweeps (over every row) per window

    def step(*a, **kw):
        nonlocal calls
        if calls in (skip, skip + steps, skip + 2 * steps):
            torch.cuda.synchronize()
            marks[calls] = time.monotonic()
            if calls == skip + steps:
                prof.start()
            elif calls == skip + 2 * steps:
                prof.stop()
                raise _Done
        if calls >= skip and a[8] is not None:
            pushes[calls >= skip + steps] += 1
        calls += 1
        return real(*a, **kw)

    ctx = bt.make_context(0)
    ctx.parameters.seed = seed
    ctx.parameters.time_limit = 120.0
    raw = bt.make_problem(ctx, io.StringIO(lp()))
    sv._step = step
    try:
        bt.solve(ctx, raw)
        raise SystemExit(f"step_profile: solve on {name} ran only {calls} sweeps")
    except _Done:
        pass
    finally:
        sv._step = real
    wall_s = marks[skip + steps] - marks[skip]
    return dict(
        card=card, instance=name, mode="solve", R=1,
        B=ctx.parameters.block_size, push_sweeps_untraced=pushes[0],
        push_sweeps_traced=pushes[1],
        **_summary(prof, steps, wall_s, kernel),
    )


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--out", default="build")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("step_profile: needs a CUDA device")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(card)
    runs = []
    for fn, name in [(profile, n) for n in INSTANCES] + [
        (profile_solve, n) for n in SOLVE_WINDOWS
    ]:
        out = fn(name, args.seed, card)
        runs.append(out)
        for k, v in out.items():
            if k not in ("top_device", "top_host"):
                print(f"{k}: {v}")
        for row in out["top_device"]:
            print(f"  device {row['ms']:10.3f} ms  x{row['count']:6d}  {row['name'][:90]}")
        for row in out["top_host"]:
            print(f"  host   {row['ms']:10.3f} ms  x{row['count']:6d}  {row['name'][:90]}")
    Path(args.out).mkdir(parents=True, exist_ok=True)
    (Path(args.out) / "profile.json").write_text(json.dumps(runs, indent=1))


if __name__ == "__main__":
    main()
