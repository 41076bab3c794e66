"""Whole runs of each cell on the CPU at a tiny size (the look for a chip
skipped), first sound, then with the timed path broken underneath: each
fault a cell can have has to make ``correct`` false. And the control: the
reference's sweep in bfloat16 in the program's place has to fail. The
same for cells of Z configurations (generalised assignment), added as
data: the job rows enumerate or walk, the capacity rows take the DP or
walk; on the program's layout and on one with DP tables sized to the
rows' windows, and with routes that break their rules."""

from __future__ import annotations

import dataclasses
import json
import shutil

import pytest
import torch

import baryonyx_torch as bt
from baryonyx_torch.ops import psweep as pw
from baryonyx_torch.ops import zsweep as zs
from baryonyx_torch.solver import optimize as opt
from baryonyx_torch.solver import solve as sv
from ilpbench import run
from ilpbench.tests import card_z
from ilpbench.tests.tiny import (TWO_RANKS, Z_CARD, Z_CELLS, copy_benchmark, tiny_benchmark,
                                 z_cells)
from ilpbench.tests.window_layout import program_layout, window_tables

SEED = 2**31 + 41


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    torch.set_num_threads(2)
    return tiny_benchmark(tmp_path_factory.mktemp("bench"))


def _run(root, cell, **kw):
    return run.run(cell, SEED, 1.5, False, device_type="cpu", root=root, **kw)


@pytest.mark.parametrize("cell", ["scp4.optimize", "scp4.solve"] + Z_CELLS)
def test_sound_run_is_correct(root, cell):
    line = _run(root, cell)
    assert line["correct"], line["checks"]
    assert all(c["value"] == 0 for c in line["checks"].values())
    assert line["attempted"] >= 1 and line["failed"] == 0


def _stale(real):
    """A sweep that hands back the state it was given, unchanged."""
    def sweep(cp, x, P, pi, *a, **kw):
        S = kw.get("S")
        out = real(cp, x.clone(), P.clone(), pi.clone(), *a,
                   **dict(kw, S=None if S is None else S.clone()))
        return (x, P, pi, out[3] if S is None else S) + tuple(out[4:])
    return sweep


def _half_batch(real):
    """A sweep that leaves the second half of the replicas out."""
    def sweep(cp, x, P, pi, cost, sched, *a, **kw):
        sched = sched.clone()
        sched[:, sched.shape[1] // 2:] = False
        return real(cp, x, P, pi, cost, sched, *a, **kw)
    return sweep


def _altered(real):
    """An entry whose returned solution has one variable flipped."""
    def entry(*a, **kw):
        res = real(*a, **kw)
        v = res.solutions[-1].variables
        v[0] = 1 - v[0]
        return res
    return entry


@pytest.mark.parametrize("fault", ["stale", "half_batch"])
def test_fused_sweep_faults_are_caught(root, monkeypatch, fault):
    monkeypatch.setattr(pw, "psweep", {"stale": _stale, "half_batch": _half_batch}[fault](pw.psweep))
    line = _run(root, "scp4.optimize")
    assert not line["correct"] and line["checks"]["sweep_mismatch"]["value"] > 0


def test_general_sweep_left_unchanged_is_caught(root, monkeypatch):
    monkeypatch.setattr(sv, "sweep", _stale(sv.sweep))
    line = _run(root, "scp4.solve")
    assert not line["correct"] and line["checks"]["sweep_mismatch"]["value"] > 0


def _z_stale(real):
    """A Z sweep that hands back the x, P and pi it was given, unchanged."""
    def sweep(cp, x, P, pi, *a, **kw):
        return (x, P, pi) + tuple(real(cp, x.clone(), P.clone(), pi.clone(), *a, **kw)[3:])
    return sweep


def _z_perturbed(real):
    """A Z sweep whose multipliers come back off by a thousandth."""
    def sweep(*a, **kw):
        x, P, pi, *rest = real(*a, **kw)
        return (x, P, pi + 1e-3, *rest)
    return sweep


@pytest.mark.parametrize("fault", ["stale", "half_batch", "perturbed"])
@pytest.mark.parametrize("cell", Z_CELLS)
def test_z_sweep_faults_are_caught(root, monkeypatch, cell, fault):
    wrap = {"stale": _z_stale, "half_batch": _half_batch, "perturbed": _z_perturbed}[fault]
    monkeypatch.setattr(zs, "z_sweep", wrap(zs.z_sweep))
    line = _run(root, cell)
    assert not line["correct"] and line["checks"]["sweep_mismatch"]["value"] > 0


def _wrong_table(real, field):
    """A layout with a wrong factor (one slot of the row with the largest
    factor) or a wrong bound (that row's bmax)."""
    def compile_problem(*a, **kw):
        cp = real(*a, **kw)
        k = int(cp.row_factor.abs().amax(dim=1).argmax())
        t = getattr(cp, field).clone()
        if field == "row_factor":
            t[k, 0] += 1
        else:
            t[k] -= 1
        return dataclasses.replace(cp, **{field: t})
    return compile_problem


@pytest.mark.parametrize("field", ["row_factor", "bmax"])
@pytest.mark.parametrize("cell", Z_CELLS)
def test_a_wrong_z_table_is_caught(root, monkeypatch, cell, field):
    for module in (sv, opt):
        monkeypatch.setattr(module, "compile_problem", _wrong_table(module.compile_problem, field))
    line = _run(root, cell)
    assert not line["correct"] and line["checks"]["table_mismatch"]["value"] > 0


@pytest.mark.parametrize("cell", Z_CELLS)
def test_the_window_sized_layout_reads_0(root, cell):
    """The layout rule that sizes each DP table to its row's reachable
    window (``window_layout.py``; at 14 x 90 the capacity rows leave the
    walk for the DP): every check reads 0."""
    with program_layout(window_tables):
        line = _run(root, cell)
    assert line["correct"], line["checks"]
    assert all(c["value"] == 0 for c in line["checks"].values())


def _required_row_walks(cp):
    """The first DP row, which the DP must take, sent to the walk."""
    dp_row = cp.dp_row.clone()
    dp_row[int(torch.nonzero(dp_row)[0])] = False
    return dataclasses.replace(cp, dp_row=dp_row, z_needs_walk=True)


def _window_missed(cp):
    """Window-sized tables, the first DP row's starting one activity above
    its window."""
    cp = window_tables(cp)
    dp_lo = cp.dp_lo.clone()
    dp_lo[int(torch.nonzero(cp.dp_row)[0])] += 1
    return dataclasses.replace(cp, dp_lo=dp_lo)


def _walk_flag_flipped(cp):
    """``z_needs_walk`` the other way."""
    return dataclasses.replace(cp, z_needs_walk=not cp.z_needs_walk)


@pytest.mark.parametrize("fault, cells", [
    (_required_row_walks, ["gap5x30.optimize", "gap5x30.solve"]),
    (_window_missed, Z_CELLS),
    (_walk_flag_flipped, Z_CELLS),
])
def test_a_route_that_breaks_its_rules_is_caught(root, fault, cells):
    for cell in cells:
        with program_layout(fault):
            line = _run(root, cell)
        assert not line["correct"] and line["checks"]["table_mismatch"]["value"] > 0, cell


@pytest.fixture(scope="module")
def window_rule_root(root, tmp_path_factory):
    """The tiny benchmark with GAP 14 x 90 requiring the DP on every row
    whose window fits it (``"dp_required": "window"`` in its file)."""
    dst = tmp_path_factory.mktemp("window_rule") / "bench"
    shutil.copytree(root, dst)
    path = dst / "ilpbench" / "configs" / "gap14x90.json"
    path.write_text(json.dumps(dict(json.loads(path.read_text()), dp_required="window")))
    return dst


def _dp_able_row_walks(cp):
    """Window-sized tables, the first DP row sent to the walk."""
    return _required_row_walks(window_tables(cp))


@pytest.mark.parametrize("layout, sound", [
    (lambda cp: cp, False),  # the program's layout walks the 14 capacity rows
    (window_tables, True),
    (_dp_able_row_walks, False),
])
@pytest.mark.parametrize("cell", z_cells({"gap14x90": None}))
def test_a_dp_able_row_that_walks_is_caught_where_the_configuration_requires_the_dp(
        window_rule_root, cell, layout, sound):
    """At 14 x 90 no capacity row's whole span fits the DP, but each one's
    window does: under ``"dp_required": "window"`` a capacity row that walks
    is a table mismatch."""
    with program_layout(layout):
        line = _run(window_rule_root, cell)
    assert line["correct"] == sound, line["checks"]
    assert (line["checks"]["table_mismatch"]["value"] == 0) == sound


@pytest.mark.parametrize("cell", ["scp4.optimize", "scp4.solve"] + Z_CELLS)
def test_an_altered_answer_is_caught(root, monkeypatch, cell):
    entry = cell.rsplit(".", 1)[1]
    monkeypatch.setattr(bt, entry, _altered(getattr(bt, entry)))
    line = _run(root, cell)
    checks = line["checks"]
    assert not line["correct"]
    assert checks["infeasible_rows"]["value"] > 0 or checks["objective_err"]["value"] > 0


def _no_exchange(ev, state):
    return state.pop


def leave_out_the_exchange():
    opt.exchange_top_k = _no_exchange


def test_the_two_rank_cell_is_correct_and_catches_a_missing_exchange(root, monkeypatch):
    line = _run(root, TWO_RANKS)
    assert line["correct"], line["checks"]
    assert line["device"]["count"] == 2
    monkeypatch.setattr(opt, "exchange_top_k", opt.exchange_top_k)  # restored afterwards
    line = _run(root, TWO_RANKS, prepare=leave_out_the_exchange)
    assert not line["correct"] and line["checks"]["exchange_mismatch"]["value"] > 0


@pytest.mark.parametrize("cell", ["scp4.optimize", "scp4.solve"] + Z_CELLS)
def test_the_bfloat16_control_fails(root, cell):
    line = _run(root, cell, control=torch.bfloat16)
    assert not line["correct"] and line["checks"]["sweep_mismatch"]["value"] > 0


CARD_CELLS = [("scp4.optimize", "program"), ("scp4.solve", "program")] + [
    (c, layout) for c in z_cells(Z_CARD) for layout in ("program", "window")]


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: run with `python -m pytest -m gpu ilpbench/tests`")


@pytest.mark.gpu
@pytest.mark.parametrize("cell, layout", CARD_CELLS)
def test_the_bfloat16_control_fails_on_the_card_at_the_cells_size(cell, layout, tmp_path):
    """The scp4 cells at their own size (the solve cell added as data), and
    the Z cells at OR-Library's gapd sizes, added as data, on the
    program's layout and on the window-sized one."""
    _card()
    if cell.startswith("scp4."):
        line = run.run(cell, SEED, 3.0, False, control=torch.bfloat16,
                       root=copy_benchmark(tmp_path))
    else:
        line = card_z.run_cell(card_z.benchmark(tmp_path), cell, layout, SEED, 3.0, False,
                               control=torch.bfloat16)["line"]
    assert not line["correct"] and line["checks"]["sweep_mismatch"]["value"] > 0


@pytest.mark.gpu
@pytest.mark.parametrize("cell, layout", CARD_CELLS[2:])
def test_the_z_cells_read_0_on_the_card(cell, layout, tmp_path):
    """Traced, at gapd's sizes, on either layout: every check reads 0, and
    kernel B's least time is summed over as many DP calls as the trace
    shows it launched. In the window-sized layout gap20x200's 20 capacity
    rows take kernel B, on a table under 512 entries."""
    _card()
    rec = card_z.run_cell(card_z.benchmark(tmp_path), cell, layout, SEED, 3.0, True)
    line, mode = rec["line"], cell.rsplit(".", 1)[1]
    assert line["correct"], line["checks"]
    assert all(c["value"] == 0 for c in line["checks"].values())
    if rec["dp_rows"]:
        got = line["metrics"]
        assert got[f"dp_bound.calls.{mode}"]["value"] == got[f"kernel_b.launches.{mode}"]["value"]
        assert got[f"dp_bound.calls.{mode}"]["value"] > 0
    if cell.startswith("gap20x200.") and layout == "window":
        assert rec["dp_rows"] == 20 and rec["Wdp"] < 512
