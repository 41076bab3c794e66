"""Where one optimize step's time goes on a CUDA device.

    python -m baryonyx_torch.step_profile [--seed N] [--out DIR]

Runs ``optimize`` on scp200x1000 (random_set_cover_lp(200, 1000, 0.02,
seed=41), the main path) for its default budget of 1000 sweeps in fixed
chunks of 100 steps, and traces the fourth chunk with torch.profiler, started and
stopped from the progress callback so that set-up and warm-up stay
outside the window. Prints, and writes to DIR/profile.json:
the wall time per step of the untraced chunk before it, the device time per
step summed over all kernels and over the fused sweep kernel, the device
idle share (1 - device time / wall time), and the ten kernels and the ten
host ops that take the most time in the traced chunk.
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
from baryonyx_torch.generators import random_set_cover_lp


def _device_us(evt) -> float:
    for name in ("self_device_time_total", "self_cuda_time_total"):
        v = getattr(evt, name, None)
        if v is not None:
            return float(v)
    return 0.0


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
    ctx.parameters.seed = args.seed
    ctx.parameters.chunk_size = 100  # no time limit: fixed chunks
    ctx.register(update=on_update)
    raw = bt.make_problem(
        ctx, io.StringIO(random_set_cover_lp(200, 1000, 0.02, seed=41))
    )
    result = bt.optimize(ctx, raw)
    if len(calls) < 4:
        raise SystemExit(f"step_profile: only {len(calls)} chunks ran")
    traced_s = calls[3][0] - calls[2][0]
    steps = calls[3][1] - calls[2][1]
    wall_s = calls[2][0] - calls[1][0]
    if calls[2][1] - calls[1][1] != steps:
        raise SystemExit("step_profile: chunks of unequal length")
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
    sweep_us = sum(t[1] for t in dev if "psweep_kernel" in t[0])
    out = dict(
        card=card,
        instance="scp200x1000",
        R=result.replicas,
        B=result.block_size,
        chunk_steps=steps,
        traced_chunk_wall_ms=traced_s * 1e3,
        step_wall_ms=wall_s * 1e3 / steps,
        device_ms_per_step=device_us / 1e3 / steps,
        sweep_kernel_ms_per_step=sweep_us / 1e3 / steps,
        device_idle_share=1.0 - device_us / 1e6 / wall_s,
        sweep_kernel_share_of_wall=sweep_us / 1e6 / wall_s,
        top_device=[dict(name=k, ms=v / 1e3, count=c) for k, v, c in dev[:10]],
        top_host=[dict(name=k, ms=v / 1e3, count=c) for k, v, c in host[:10]],
    )
    Path(args.out).mkdir(parents=True, exist_ok=True)
    (Path(args.out) / "profile.json").write_text(json.dumps(out, indent=1))
    print(card)
    for k, v in out.items():
        if k not in ("top_device", "top_host"):
            print(f"{k}: {v}")
    for row in out["top_device"]:
        print(f"  device {row['ms']:10.3f} ms  x{row['count']:6d}  {row['name'][:90]}")
    for row in out["top_host"]:
        print(f"  host   {row['ms']:10.3f} ms  x{row['count']:6d}  {row['name'][:90]}")


if __name__ == "__main__":
    main()
