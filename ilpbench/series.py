"""Run a cell several times, each run a process of its own as a check
runs it, and summarise the result lines.

    python3 -m ilpbench.series --workload <cell> --seeds 11,12,13 --seconds 25 \
        [--trace 0|1] [--out chiprun_out/series.jsonl]

Appends one JSON record per run to ``--out`` (seed, trace, exit code,
wall seconds, the result line, the end of standard error), then prints
each metric's median and its spread: the distance between the first and
third quartiles (``statistics.quantiles(values, n=4)``) over the median."""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

RUN_TIMEOUT_S = 1200.0  # a cell's first run in a checkout builds the kernels


def spread(values):
    if len(values) < 2:
        return float("nan")
    q = statistics.quantiles(values, n=4)
    return (q[2] - q[0]) / statistics.median(values)


def summarise(records) -> None:
    by_metric = {}
    for rec in records:
        line = rec.get("line") or {}
        for name, m in line.get("metrics", {}).items():
            by_metric.setdefault(name, []).append(m["value"])
    for name, values in sorted(by_metric.items()):
        print(f"{name}: n {len(values)} median {statistics.median(values)!r} "
              f"spread {spread(values)!r} values {values}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, default=0)
    ap.add_argument("--out", default="chiprun_out/series.jsonl")
    args = ap.parse_args(argv)
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    records = []
    for seed in args.seeds.split(","):
        cmd = [sys.executable, "-m", "ilpbench.run", "--workload", args.workload,
               "--seed", seed, "--seconds", str(args.seconds), "--trace", str(args.trace)]
        t = time.monotonic()
        try:
            p = subprocess.run(cmd, capture_output=True, text=True, timeout=RUN_TIMEOUT_S)
            rc, stdout, stderr = p.returncode, p.stdout, p.stderr
        except subprocess.TimeoutExpired as e:
            rc, stdout, stderr = 124, e.stdout or "", e.stderr or ""
            stdout = stdout.decode() if isinstance(stdout, bytes) else stdout
            stderr = stderr.decode() if isinstance(stderr, bytes) else stderr
        wall = time.monotonic() - t
        lines = stdout.strip().splitlines()
        try:
            line = json.loads(lines[-1]) if lines else None
        except json.JSONDecodeError:
            line = None
        rec = {"workload": args.workload, "seed": int(seed), "trace": args.trace, "rc": rc,
               "wall_s": wall, "line": line, "stderr": stderr[-3000:]}
        records.append(rec)
        with out.open("a") as fh:
            fh.write(json.dumps(rec) + "\n")
        summary = {k: v["value"] for k, v in (line or {}).get("metrics", {}).items()}
        print(f"seed {seed} rc {rc} wall {wall:.1f} s correct "
              f"{(line or {}).get('correct')} {summary}", flush=True)
        if rc != 0 or line is None:
            print(stderr[-3000:], flush=True)
    summarise(records)
    return 0


if __name__ == "__main__":
    sys.exit(main())
