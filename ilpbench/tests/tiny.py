"""Copies of the benchmark (``BENCHMARK.json`` and ``ilpbench/``) in a
directory of the tests' own. ``tiny_benchmark``: every configuration cut
to a size the CPU runs in seconds, a cell of two ranks added (the traffic
``optimize-4gpu`` cut to 2) and cells of two small Z configurations in
both modes; the harness runs it on the CPU through
``run.run(..., device_type="cpu", root=...)``. ``with_z_cells``: cells of
Z configurations of any size added as data (on the card, at OR-Library's
sizes)."""

from __future__ import annotations

import json
import shutil
from pathlib import Path
from typing import Dict, List

from ilpbench import manifest

TINY_ARGS = {
    "set_cover": {"m": 40, "n": 200, "density": 0.05},
}
TWO_RANKS = "scp4.optimize-2rank"
# Z configurations (OR-Library generalised assignment, type D): at 5
# agents x 30 jobs the job rows enumerate and the capacity rows (sum of a
# about 1,500) take the knapsack DP; at 14 x 90 every row walks (14 unit
# factors > 12; sum of a about 4,500 > 4,096)
Z_TINY = {"gap5x30": {"m": 5, "n": 30}, "gap14x90": {"m": 14, "n": 90}}
# on the card: gapd's largest size (every row walks) and 5 x 60, whose
# capacity rows (sum of a about 3,000) reach kernel B
Z_CARD = {"gap20x200": {"m": 20, "n": 200}, "gap5x60": {"m": 5, "n": 60}}
MODES = ("optimize", "solve")


def z_cells(configs: Dict[str, dict]) -> List[str]:
    return [f"{c}.{mode}" for c in configs for mode in MODES]


Z_CELLS = z_cells(Z_TINY)


def copy_benchmark(dst: Path) -> Path:
    shutil.copy(manifest.ROOT / "BENCHMARK.json", dst / "BENCHMARK.json")
    shutil.copytree(manifest.HERE, dst / "ilpbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    return dst


def with_z_cells(dst: Path, configs: Dict[str, dict], suffix: str = "") -> Path:
    """Adds to the copy at ``dst`` a GAP type D configuration of each size
    in ``configs`` and its cells in both modes, on the traffic
    ``optimize<suffix>`` and ``solve<suffix>``."""
    bench = json.loads((dst / "BENCHMARK.json").read_text())
    for name, args in configs.items():
        (dst / "ilpbench" / "configs" / f"{name}.json").write_text(json.dumps({
            "name": name, "generator": "gap", "instance_seed": 0, "args": args,
            "float_type": "float32", "reduced": [],
            "assumed": {"b_i": "0.8 sum_j a_ij / m rounded down"},
        }))
        bench["configs"].append({"name": name, "source": "tests", "reduced": [], "why": "Z rows",
                                 "file": f"ilpbench/configs/{name}.json"})
        for mode in MODES:
            bench["workloads"].append({"name": f"{name}.{mode}", "config": name,
                                       "traffic": mode + suffix, "chips": 1, "why": "Z rows"})
    # each metric that the scp4 cell of a mode reports, the Z cells of the
    # mode report too
    for m in bench["end_to_end"] + bench["per_layer"]:
        for mode in MODES:
            if f"scp4.{mode}" in m.get("workloads", []):
                m["workloads"] += [f"{c}.{mode}" for c in configs]
    (dst / "BENCHMARK.json").write_text(json.dumps(bench))
    return dst


def _z_traffic(dst: Path, changes: Dict[str, dict]) -> None:
    """The traffic ``<mode>-z``: the mode's traffic with ``changes``."""
    traffic = dst / "ilpbench" / "traffic"
    for mode, change in changes.items():
        t = json.loads((traffic / f"{mode}.json").read_text())
        (traffic / f"{mode}-z.json").write_text(json.dumps(dict(t, **change)))


def card_z_benchmark(dst: Path) -> Path:
    """The benchmark with the Z cells at ``Z_CARD``'s sizes, on traffic
    that warms optimize up over 50 sweeps (a Z step launches some 3,800
    operations) and cuts a solve to at most 300 sweeps and 5 push rounds."""
    copy_benchmark(dst)
    _z_traffic(dst, {
        "optimize": dict(warmup_sweeps=50, warmup_budget_s=30.0),
        "solve": dict(params={"limit": 300, "pushes_limit": 5, "pushing_iteration_limit": 20}),
    })
    return with_z_cells(dst, Z_CARD, "-z")


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
    # the Z cells' traffic: a Z sweep takes up to a third of a second on
    # the CPU, so chunks and solves are cut short
    _z_traffic(dst, {
        "optimize": dict(params={"chunk_size": 2}, warmup_sweeps=4, warmup_budget_s=20.0),
        "solve": dict(params={"limit": 100, "pushes_limit": 1, "pushing_iteration_limit": 3}),
    })
    return with_z_cells(dst, Z_TINY, "-z")
