"""A copy of the benchmark (``BENCHMARK.json`` and ``ilpbench/``) in a
directory of the tests' own, with every configuration cut to a size the
CPU runs in seconds, and a cell of two ranks added (the traffic
``optimize-4gpu`` cut to 2); the harness runs it on the CPU through
``run.run(..., device_type="cpu", root=...)``."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

from ilpbench import manifest

TINY_ARGS = {
    "set_cover": {"m": 40, "n": 200, "density": 0.05},
}
TWO_RANKS = "scp4.optimize-2rank"


def copy_benchmark(dst: Path) -> Path:
    shutil.copy(manifest.ROOT / "BENCHMARK.json", dst / "BENCHMARK.json")
    shutil.copytree(manifest.HERE, dst / "ilpbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    return dst


def tiny_benchmark(dst: Path) -> Path:
    copy_benchmark(dst)
    bench = json.loads((dst / "BENCHMARK.json").read_text())
    for c in bench["configs"]:
        path = dst / c["file"]
        cfg = json.loads(path.read_text())
        cfg["args"].update(TINY_ARGS[cfg["generator"]])
        path.write_text(json.dumps(cfg))
    bench["workloads"].append({"name": TWO_RANKS, "config": "scp4", "traffic": "optimize-4gpu",
                               "chips": 4, "why": "the exchange between ranks"})
    for m in bench["end_to_end"]:
        if "replica_sweeps_per_s" == m["name"]:
            m["workloads"].append(TWO_RANKS)
    for w in bench["workloads"]:
        path = dst / "ilpbench" / "traffic" / f"{w['traffic']}.json"
        t = json.loads(path.read_text())
        if t["mode"] == "optimize":
            t.update(warmup_sweeps=100, warmup_budget_s=3.0)
        else:
            t.update(params={"pushes_limit": 3}, probe_sweep=5, traced_sweeps=5)
        if w["chips"] > 2:
            # two ranks, and a population small enough that their best
            # members differ, so that an exchange takes something
            w["chips"] = t["ranks"] = 2
            t["params"] = dict(t["params"], init_population_size=20)
        path.write_text(json.dumps(t))
    (dst / "BENCHMARK.json").write_text(json.dumps(bench))
    return dst
