"""Copies of the benchmark (``BENCHMARK.json`` and ``ilpbench/``) in a
directory of the tests' own, with the solve cell added as data
(``with_solve_cell``). ``tiny_benchmark``: a cell of two ranks
added (the traffic ``optimize-4gpu`` cut to 2) and cells of two small Z
configurations in both modes, then ``cut``: every configuration cut to
the size its own files give for the CPU, each cell's traffic to a short
run; the harness runs it on the CPU through ``run.run(...,
device_type="cpu", root=...)``. ``with_z_cells``: cells of Z
configurations of any size added as data (on the card, at OR-Library's
sizes)."""

from __future__ import annotations

import json
import shutil
from pathlib import Path
from typing import Dict, List, Tuple

from ilpbench import driver, manifest

# each mode's traffic on the CPU; a configuration's generator
# (``TINY_TRAFFIC``) adds to it
MODE_CUT = {
    "optimize": {"warmup_sweeps": 100, "warmup_budget_s": 3.0},
    "solve": {"params": {"pushes_limit": 3}, "probe_sweep": 5, "traced_sweeps": 5},
}
TWO_RANKS = "scp4.optimize-2rank"
# Z configurations (OR-Library generalised assignment, type D): at 5
# agents x 30 jobs the job rows enumerate and the capacity rows (sum of a
# about 1,500) take the knapsack DP; at 14 x 90 every row walks in the
# program's layout (14 unit factors > 12; sum of a about 4,500 > 4,096)
Z_TINY = {"gap5x30": {"m": 5, "n": 30}, "gap14x90": {"m": 14, "n": 90}}
# on the card: gapd's largest size (every row walks in the program's
# layout; in a layout sized to the rows' reachable windows its capacity
# rows take kernel B) and 5 x 60, whose capacity rows (sum of a about
# 3,000) reach kernel B
Z_CARD = {"gap20x200": {"m": 20, "n": 200}, "gap5x60": {"m": 5, "n": 60}}
MODES = ("optimize", "solve")
SOLVE_CELL = Path(__file__).with_name("scp4_solve.json")


def z_cells(configs: Dict[str, dict]) -> List[str]:
    return [f"{c}.{mode}" for c in configs for mode in MODES]


Z_CELLS = z_cells(Z_TINY)


def with_solve_cell(bench: dict) -> dict:
    """``bench`` with the cell ``scp4.solve`` and its metrics added as data
    (``SOLVE_CELL``: its entries of ``workloads``, ``end_to_end`` and
    ``per_layer``, and under ``also_in`` the metrics whose ``workloads``
    take it too). ``BENCHMARK.json`` has no solve cell: a host-paced solve's
    time per sweep spreads more than the largest bound allows on the
    card's host, so the solve mode is held by the tests alone."""
    extra = json.loads(SOLVE_CELL.read_text())
    for kind in ("workloads", "end_to_end", "per_layer"):
        bench[kind] += extra[kind]
    cells = [w["name"] for w in extra["workloads"]]
    for m in bench["per_layer"]:
        if m["name"] in extra["also_in"]:
            m["workloads"] += cells
    return bench


def copy_benchmark(dst: Path) -> Path:
    """``BENCHMARK.json`` with the solve cell (``with_solve_cell``), and
    ``ilpbench/`` but its tests."""
    bench = with_solve_cell(manifest.load())
    (dst / "BENCHMARK.json").write_text(json.dumps(bench))
    shutil.copytree(manifest.HERE, dst / "ilpbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    return dst


def with_z_cells(dst: Path, configs: Dict[str, dict], suffix: str = "") -> Path:
    """Adds to the copy at ``dst`` a GAP type D configuration of each size
    in ``configs``, which is also its CPU size, and its cells in both
    modes, on the traffic ``optimize<suffix>`` and ``solve<suffix>``."""
    bench = json.loads((dst / "BENCHMARK.json").read_text())
    for name, args in configs.items():
        (dst / "ilpbench" / "configs" / f"{name}.json").write_text(json.dumps({
            "name": name, "generator": "gap", "instance_seed": 0, "args": args,
            "tiny_args": args, "float_type": "float32", "reduced": [],
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


def card_z_benchmark(dst: Path) -> Path:
    """The benchmark with the Z cells at ``Z_CARD``'s sizes, on the traffic
    ``<mode>-z``: optimize warmed up over 50 sweeps (a Z step launches
    some 2,000 to 6,000 operations), a solve cut to at most 300 sweeps and
    5 push rounds."""
    copy_benchmark(dst)
    traffic = dst / "ilpbench" / "traffic"
    for mode, change in {
        "optimize": dict(warmup_sweeps=50, warmup_budget_s=30.0),
        "solve": dict(params={"limit": 300, "pushes_limit": 5, "pushing_iteration_limit": 20}),
    }.items():
        t = json.loads((traffic / f"{mode}.json").read_text())
        (traffic / f"{mode}-z.json").write_text(json.dumps(dict(t, **change)))
    return with_z_cells(dst, Z_CARD, "-z")


def tiny_size(here: Path, cfg: dict) -> Tuple[dict, Dict[str, dict]]:
    """A configuration's CPU size (its file's ``"tiny_args"``, or else its
    generator's ``TINY_ARGS``) and, by mode, its traffic's (its
    generator's ``TINY_TRAFFIC``, where it has one)."""
    gen = driver.generator(cfg["generator"], here)
    args = cfg.get("tiny_args", getattr(gen, "TINY_ARGS", None))
    if args is None:
        raise ValueError(
            f"configuration {cfg['name']!r} has no size for the CPU tests: give "
            f"ilpbench/generators/{cfg['generator']}.py a TINY_ARGS, or "
            f"ilpbench/configs/{cfg['name']}.json a \"tiny_args\"")
    return args, getattr(gen, "TINY_TRAFFIC", {})


def cut(dst: Path) -> Path:
    """Cuts the copy at ``dst`` to the CPU: each configuration to its CPU
    size (``tiny_size``), each cell's traffic to ``MODE_CUT`` of its mode
    and its configuration's own cut, in a traffic file of the cell's
    configuration (``<traffic>.<config>``), and a cell of more than two
    chips to two."""
    here = dst / "ilpbench"
    bench = json.loads((dst / "BENCHMARK.json").read_text())
    traffic_cut = {}
    for c in bench["configs"]:
        path = dst / c["file"]
        cfg = json.loads(path.read_text())
        args, traffic_cut[c["name"]] = tiny_size(here, cfg)
        cfg["args"].update(args)
        path.write_text(json.dumps(cfg))
    for w in bench["workloads"]:
        t = manifest.traffic(w["traffic"], here)
        t.update(MODE_CUT[t["mode"]])
        t.update(traffic_cut[w["config"]].get(t["mode"], {}))
        if w["chips"] > 2:
            # two ranks, and a population small enough that their best
            # members differ, so that an exchange takes something
            w["chips"] = t["ranks"] = 2
            t["params"] = dict(t["params"], init_population_size=20)
        w["traffic"] = f"{w['traffic']}.{w['config']}"
        (here / "traffic" / f"{w['traffic']}.json").write_text(json.dumps(t))
    (dst / "BENCHMARK.json").write_text(json.dumps(bench))
    return dst


def tiny_benchmark(dst: Path) -> Path:
    copy_benchmark(dst)
    bench = json.loads((dst / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": TWO_RANKS, "config": "scp4", "traffic": "optimize-4gpu",
                               "chips": 4, "why": "the exchange between ranks"})
    for m in bench["end_to_end"]:
        if "replica_sweeps_per_s" == m["name"]:
            m["workloads"].append(TWO_RANKS)
    (dst / "BENCHMARK.json").write_text(json.dumps(bench))
    return cut(with_z_cells(dst, Z_TINY))
