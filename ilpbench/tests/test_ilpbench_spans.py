"""The metrics that read the program's own spans (``program_spans.py``),
from traced runs of each cell at the tiny size on the CPU, the cell of four
ranks cut to two: each reads a number in the cells it lists, and nothing in
the others. ``entry.kernel_load_s`` reads nothing on the CPU, where no
kernel is loaded; on the card it reads in the optimize cells."""

from __future__ import annotations

import json
import sys

import pytest
import torch

from ilpbench import manifest, run
from ilpbench.tests.tiny import tiny_benchmark, with_solve_cell

SEED = 2**31 + 77
NEW = [m for m in with_solve_cell(manifest.load())["per_layer"] if m["source"] == "program_span"
       and m["name"] not in ("entry.parse_s", "entry.solver_setup_s")]
ON_THE_CARD_ONLY = {"entry.kernel_load_s"}


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    """The tiny benchmark, its optimize chunks kept short: on the CPU a chunk
    under the profiler takes several times as long, its chunk length grows
    fourfold while a chunk is short, and reading the profiler's events takes
    about 60 us each (some 8,000 per sweep). From 2 sweeps the traced chunk
    is the third: 32 sweeps."""
    torch.set_num_threads(2)
    root = tiny_benchmark(tmp_path_factory.mktemp("bench"))
    for path in (root / "ilpbench" / "traffic").glob("*.json"):
        t = json.loads(path.read_text())
        if t["mode"] == "optimize":
            t.update(warmup_sweeps=2, params=dict(t["params"], chunk_size=2))
            path.write_text(json.dumps(t))
    return root


@pytest.mark.parametrize("cell", ["scp4.optimize", "scp4.solve", "scp4.optimize-4gpu"])
def test_span_metrics_read_where_they_apply(root, cell):
    line = run.run(cell, SEED, 1.5, True, device_type="cpu", root=root)
    assert line["correct"], line["checks"]
    bench = json.loads((root / "BENCHMARK.json").read_text())
    mode = manifest.traffic(manifest.cell(bench, cell)["traffic"], root / "ilpbench")["mode"]
    for m in NEW:
        # the readers read this process's spans: rank 0's, of the run just made
        value = manifest.reader(m["name"])({"mode": mode, "trace": {"steps": 1}})
        if cell in m["workloads"] and m["name"] not in ON_THE_CARD_ONLY:
            assert isinstance(value, float) and value >= 0, m["name"]
            assert line["metrics"][m["name"]]["value"] == value, m["name"]
        else:
            assert value is None, m["name"]
            assert m["name"] not in line["metrics"]
    got = line["metrics"]
    assert got["entry.lp_parse_s"]["value"] > 0
    assert got["entry.solver_init_s"]["value"] >= got["entry.compile_s"]["value"]
    if mode == "optimize":
        assert got["optimize.enqueue_ms_per_step"]["value"] > 0
    if cell == "scp4.optimize-4gpu":
        assert got["parallel.collective_bytes_per_chunk"]["value"] > 0


def test_span_readers_read_nothing_without_the_programs_spans(monkeypatch):
    """As on a commit of the program that has no spans module."""
    import baryonyx_torch

    monkeypatch.delattr(baryonyx_torch, "spans")
    monkeypatch.setitem(sys.modules, "baryonyx_torch.spans", None)  # the import fails
    for m in NEW:
        for mode in ("optimize", "solve"):
            assert manifest.reader(m["name"])({"mode": mode, "trace": {"steps": 1}}) is None


def test_a_set_up_span_reads_its_mean_after_the_first_call_with_no_profiler(monkeypatch):
    from ilpbench import program_spans

    def totals(calls, total_s, first_s):
        return {"calls": calls, "total_s": total_s, "self_s": total_s, "n": 0, "first_s": first_s}

    snap = {"rest": {"entry.compile": totals(3, 1.5, 0.9), "entry.parse": totals(1, 0.2, 0.2)},
            "traced": {"entry.compile": totals(1, 0.3, 0.3), "entry.merge": totals(1, 0.1, 0.1)},
            "launches": {}}
    monkeypatch.setattr(program_spans, "snapshot", lambda: snap)
    assert program_spans.mean_s("entry.compile") == pytest.approx((1.5 - 0.9) / 2)
    assert program_spans.mean_s("entry.parse") == 0.2
    assert program_spans.mean_s("entry.merge") is None  # only under a profiler
    assert program_spans.mean_s("entry.population") is None
