"""What ``BENCHMARK.json`` and the benchmark's data files say, found by
name: a cell's configuration (``configs/<config>.json``), its traffic
(``traffic/<traffic>.json``), and each metric's reader
(``metrics/<metric>.py``, a ``read(run)`` that returns a number or None
when the run holds nothing for it to read)."""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from typing import Callable, Dict, List, Optional

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def load(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def cell(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def config(bench: dict, name: str, root: Path = ROOT) -> dict:
    for c in bench["configs"]:
        if c["name"] == name:
            return json.loads((root / c["file"]).read_text())
    raise KeyError(f"no configuration {name!r} in BENCHMARK.json")


def traffic(name: str, here: Path = HERE) -> dict:
    return json.loads((here / "traffic" / f"{name}.json").read_text())


def metrics_for(bench: dict, cell_name: str, per_layer: bool) -> List[dict]:
    """The metrics a run of the cell reports: its end-to-end metrics, or
    (traced) its per-layer ones. A metric without ``workloads`` belongs
    to every cell that reports the end-to-end metric it moves (or, for an
    end-to-end metric, to every cell)."""
    e2e = [m for m in bench["end_to_end"] if cell_name in m.get("workloads", [cell_name])]
    if not per_layer:
        return e2e
    names = {m["name"] for m in e2e}
    return [
        m for m in bench["per_layer"]
        if cell_name in m.get("workloads", [cell_name] if m["moves"] in names else [])
    ]


def reader(name: str, here: Path = HERE) -> Callable[[dict], Optional[float]]:
    path = here / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"ilpbench_metric_{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def limits(here: Path = HERE) -> Dict[str, float]:
    return json.loads((here / "reference" / "limits.json").read_text())
