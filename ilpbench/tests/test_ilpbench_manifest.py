"""BENCHMARK.json against the benchmark's contract, the data files it
names, the import rules, and a configuration, a cell and a metric added
as files alone, cut to the CPU by the sizes their own files give."""

from __future__ import annotations

import ast
import json
import re
import sys
from pathlib import Path

import pytest
import torch

from ilpbench import manifest, run
from ilpbench.tests.tiny import copy_benchmark, cut, with_solve_cell

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
BENCH = manifest.load()
E2E = {m["name"]: m for m in BENCH["end_to_end"]}
CELLS = {w["name"]: w for w in BENCH["workloads"]}


def _line(s: str) -> bool:
    return 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_top_level_keys_and_run_seconds():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert 1 <= BENCH["run_seconds"] <= 51 and isinstance(BENCH["run_seconds"], int)
    assert 1 <= len(BENCH["command"]) <= 32 and all(_line(w) for w in BENCH["command"])
    assert all(PATH.match(p) and ".." not in p and not p.startswith("/") for p in BENCH["paths"])
    assert len(json.dumps(BENCH)) <= 64 * 1024


@pytest.mark.parametrize("kind", ["configs", "workloads", "end_to_end", "per_layer"])
def test_names_units_and_keys(kind):
    keys = {
        "configs": {"name", "source", "file", "reduced", "why"},
        "workloads": {"name", "config", "traffic", "chips", "why"},
        "end_to_end": {"name", "unit", "better", "bound", "source"},
        "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
    }[kind]
    names = [e["name"] for e in BENCH[kind]]
    assert len(names) == len(set(names))
    for e in BENCH[kind]:
        assert set(e) - {"workloads"} == keys, e["name"]
        assert NAME.match(e["name"]), e["name"]
        if kind in ("end_to_end", "per_layer"):
            assert UNIT.match(e["unit"]) and e["better"] in ("lower", "higher")
        if kind == "end_to_end":
            assert e["source"] in ("host_clock", "device_trace") and 0.01 <= e["bound"] <= 0.25
        if kind == "per_layer":
            assert e["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
            assert _line(e["layer"]) and e["moves"] in E2E
        if kind == "configs":
            assert _line(e["source"]) and _line(e["why"]) and len(e["reduced"]) <= 16
            assert e["file"].startswith(BENCH["paths"][0] + "/")
            assert json.loads((manifest.ROOT / e["file"]).read_text())["reduced"] == e["reduced"]
        if kind == "workloads":
            assert _line(e["why"]) and e["chips"] in (1, 4)
            assert NAME.match(e["config"]) and NAME.match(e["traffic"])


def test_cells_configs_and_traffic_agree():
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == {c["name"] for c in BENCH["configs"]}
    for w in BENCH["workloads"]:
        assert manifest.traffic(w["traffic"]).get("ranks", 1) == w["chips"]
    four = sum(w["chips"] == 4 for w in BENCH["workloads"])
    assert four <= max(1, len(BENCH["workloads"]) // 4)
    assert "setup_s" in E2E


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_every_cell_reports_what_it_must(cell):
    e2e = {m["name"] for m in manifest.metrics_for(BENCH, cell, False)}
    layers = manifest.metrics_for(BENCH, cell, True)
    assert "setup_s" in e2e and len(e2e) >= 2 and layers
    for m in layers:
        assert m["moves"] in e2e, (cell, m["name"])


def test_the_solve_cell_held_as_data_fits_the_benchmark():
    """``scp4.solve``, out of ``BENCHMARK.json``, added back as its entries
    alone: names unique, its traffic and readers there, and it reports
    what a cell must."""
    bench = with_solve_cell(manifest.load())
    for kind in ("workloads", "end_to_end", "per_layer"):
        names = [e["name"] for e in bench[kind]]
        assert len(names) == len(set(names)), kind
    cell = manifest.cell(bench, "scp4.solve")
    assert cell["name"] not in CELLS
    assert manifest.traffic(cell["traffic"]).get("ranks", 1) == cell["chips"] == 1
    e2e = {m["name"] for m in manifest.metrics_for(bench, cell["name"], False)}
    layers = manifest.metrics_for(bench, cell["name"], True)
    assert e2e == {"setup_s", "solve_ms_per_sweep"} and layers
    for m in layers:
        assert m["moves"] in e2e, m["name"]
    for m in manifest.metrics_for(bench, cell["name"], False) + layers:
        assert callable(manifest.reader(m["name"])), m["name"]


def test_layer_metrics_name_cells_that_report_what_they_move():
    for m in BENCH["per_layer"] + BENCH["end_to_end"]:
        for cell in m.get("workloads", []):
            assert cell in CELLS, (m["name"], cell)
            if "moves" in m:
                reported = {e["name"] for e in manifest.metrics_for(BENCH, cell, False)}
                assert m["moves"] in reported, (m["name"], cell)


def test_one_layer_name_per_layer_and_a_reader_per_metric():
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert (manifest.HERE / "metrics" / f"{m['name']}.py").is_file(), m["name"]
        assert callable(manifest.reader(m["name"]))
    assert all(m["name"].endswith("_roofline") for m in BENCH["per_layer"] if "roofline" in m["name"])


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            yield node.module
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module":
            if node.args and isinstance(node.args[0], ast.Constant):
                yield node.args[0].value


@pytest.mark.parametrize("path", sorted(p.relative_to(manifest.HERE).as_posix()
                                        for p in manifest.HERE.rglob("*.py")))
def test_no_jax_import_by_whole_top_level_name(path):
    tops = {name.split(".")[0] for name in _imports(manifest.HERE / path)}
    assert not tops & run.FORBIDDEN, path
    if path.startswith("reference/"):
        assert "baryonyx_torch" not in tops, path


def test_the_loaded_module_check_compares_whole_names(monkeypatch):
    before = set(run.forbidden_modules())
    for near in ("baryonyx_tpux.probe", "jaxlike", "flaxen.probe"):
        monkeypatch.setitem(sys.modules, near, sys)
    assert set(run.forbidden_modules()) == before
    monkeypatch.setitem(sys.modules, "baryonyx_tpu.probe", sys)
    assert set(run.forbidden_modules()) == before | {"baryonyx_tpu"}


def _add_config(root: Path, name: str, generator: str, args: dict, traffic: str, **extra):
    """A configuration, its own traffic file (``optimize`` with ``extra``)
    and its optimize cell, added to the copy at ``root`` as new files and
    entries."""
    here = root / "ilpbench"
    (here / "configs" / f"{name}.json").write_text(json.dumps({
        "name": name, "source": "a test", "generator": generator, "instance_seed": 3,
        "args": args, "float_type": "float32", "lagrangian_iterations": 200, "assumed": {},
        "reduced": [],
    }))
    t = json.loads((here / "traffic" / "optimize.json").read_text())
    (here / "traffic" / f"{traffic}.json").write_text(json.dumps(dict(t, **extra)))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": name, "source": "a test", "why": "a test",
                             "file": f"ilpbench/configs/{name}.json", "reduced": []})
    bench["workloads"].append({"name": f"{name}.optimize", "config": name, "traffic": traffic,
                               "chips": 1, "why": "a test"})
    for m in bench["end_to_end"]:
        if m["name"] == "replica_sweeps_per_s":
            m["workloads"].append(f"{name}.optimize")
    (root / "BENCHMARK.json").write_text(json.dumps(bench))


def test_a_cell_and_a_metric_added_as_files_alone(tmp_path):
    """Two configurations, each with its own traffic and a cell, and a
    metric, added as new files and entries before the copy is cut to the
    CPU: a set covering one, and a GAP type D one at gapd's largest size,
    whose CPU size and traffic the cut takes from its generator. Both runs
    are correct."""
    root = copy_benchmark(tmp_path)
    here = root / "ilpbench"
    _add_config(root, "scp_small", "set_cover", {"m": 20, "n": 80, "density": 0.08},
                "optimize-short", warmup_sweeps=50)
    _add_config(root, "gapd20x200", "gap", {"m": 20, "n": 200}, "optimize-gapd",
                warmup_sweeps=50, warmup_budget_s=30.0)
    (here / "metrics" / "optimize.window_sweeps.py").write_text(
        "def read(run):\n    return run['sweeps'] if run['mode'] == 'optimize' else None\n")
    bench = json.loads((root / "BENCHMARK.json").read_text())
    for name, unit in (("optimize.window_sweeps", "sweeps"), ("gap_pct", "%")):
        bench["end_to_end"].append({"name": name, "unit": unit, "better": "higher",
                                    "bound": 0.25, "source": "host_clock",
                                    "workloads": ["scp_small.optimize"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    cut(root)
    cfg = json.loads((here / "configs" / "gapd20x200.json").read_text())
    assert cfg["args"] == {"m": 5, "n": 30}
    torch.set_num_threads(2)
    line = run.run("scp_small.optimize", 5, 1.0, False, device_type="cpu", root=root)
    assert line["correct"], line["checks"]
    assert line["metrics"]["optimize.window_sweeps"]["value"] > 0
    assert {"replica_sweeps_per_s", "gap_pct", "setup_s"} <= set(line["metrics"])
    line = run.run("gapd20x200.optimize", 5, 1.0, False, device_type="cpu", root=root)
    assert line["correct"], line["checks"]
    assert all(c["value"] == 0 for c in line["checks"].values())
    assert {"replica_sweeps_per_s", "setup_s"} <= set(line["metrics"])


def test_a_configuration_without_a_cpu_size_names_where_to_give_one(tmp_path):
    root = copy_benchmark(tmp_path)
    src = (root / "ilpbench" / "generators" / "set_cover.py").read_text()
    (root / "ilpbench" / "generators" / "cover_copy.py").write_text(
        src.replace("TINY_ARGS =", "_NOT_TINY_ARGS ="))
    _add_config(root, "cover_copy", "cover_copy", {"m": 20, "n": 80, "density": 0.08}, "optimize")
    with pytest.raises(ValueError, match=r"generators/cover_copy\.py a TINY_ARGS, or "
                                         r"ilpbench/configs/cover_copy\.json a \"tiny_args\""):
        cut(root)
