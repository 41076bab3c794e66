"""Whole runs of each cell on the CPU at a tiny size (the look for a chip
skipped), first sound, then with the timed path broken underneath: each
fault a cell can have has to make ``correct`` false. And the control: the
reference's sweep in bfloat16 in the program's place has to fail. The
same for cells of Z configurations (generalised assignment), added as
data: the job rows enumerate or walk, the capacity rows take the DP or
walk."""

from __future__ import annotations

import dataclasses

import pytest
import torch

import baryonyx_torch as bt
from baryonyx_torch.ops import psweep as pw
from baryonyx_torch.ops import zsweep as zs
from baryonyx_torch.solver import optimize as opt
from baryonyx_torch.solver import solve as sv
from ilpbench import run
from ilpbench.tests.tiny import (TWO_RANKS, Z_CARD, Z_CELLS, card_z_benchmark, tiny_benchmark,
                                  z_cells)

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


@pytest.mark.gpu
@pytest.mark.parametrize("cell", ["scp4.optimize", "scp4.solve"] + z_cells(Z_CARD))
def test_the_bfloat16_control_fails_on_the_card_at_the_cells_size(cell, tmp_path):
    """The Z cells at OR-Library's gapd sizes, added as data."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: run with `python -m pytest -m gpu ilpbench/tests`")
    kw = {} if cell.startswith("scp4.") else {"root": card_z_benchmark(tmp_path)}
    line = run.run(cell, SEED, 3.0, False, control=torch.bfloat16, **kw)
    assert not line["correct"] and line["checks"]["sweep_mismatch"]["value"] > 0
