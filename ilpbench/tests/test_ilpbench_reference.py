"""The plain reference on its own: the generator copies against the
port's generators, the generalised assignment generator against its
published rules, the feasibility check and the Lagrangian bound against
brute force, the permutation, the frozen Z sweep against the program's
(on its own layout and on one with DP tables sized to the rows' windows)
and its bfloat16 control, the routes of both layouts, and kernel B's
least time."""

from __future__ import annotations

import itertools

import numpy as np
import pytest

import torch

from baryonyx_torch.generators import random_set_cover_lp
from baryonyx_torch.preprocess.fixing import unpreprocess
from ilpbench.generators import gap, set_cover
from ilpbench.reference import check, lagrangian, sweep_z, tables
from ilpbench.reference.instance import EQ, GE, LE, from_rows, permuted
from ilpbench.tests.window_layout import window_tables

SEEDS = [0, 7, 2**31 + 12345]


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("size", [(10, 40, 0.1), (30, 100, 0.05)])
def test_set_cover_text_is_the_ports(seed, size):
    m, n, density = size
    assert set_cover.generate(seed, m, n, density).lp == random_set_cover_lp(m, n, density, seed=seed)


def _random_instance(rng, m, n, senses):
    rows = []
    for _ in range(m):
        idx = np.sort(rng.choice(n, size=rng.integers(2, n), replace=False))
        rows.append((idx, np.ones(len(idx))))
    sense = [senses[int(rng.integers(len(senses)))] for _ in range(m)]
    rhs = [1.0 if s != LE else float(rng.integers(1, 3)) for s in sense]
    cost = rng.integers(1, 30, size=n)
    return from_rows([f"x{j}" for j in range(n)], cost, rows, sense, rhs)


def _brute(inst):
    best, feasible = np.inf, []
    for bits in itertools.product((0, 1), repeat=inst.n):
        x = np.array(bits)
        act = check.activities(inst, x.astype(float))
        ok = np.where(inst.sense == GE, act >= inst.rhs,
                      np.where(inst.sense == EQ, act == inst.rhs, act <= inst.rhs))
        assert check.violated_rows(inst, x) == int((~ok).sum())
        if ok.all():
            feasible.append(x)
            best = min(best, float(inst.cost @ x))
    return best, feasible


@pytest.mark.parametrize("case", range(6))
def test_feasibility_and_bound_against_brute_force(case):
    rng = np.random.default_rng(case)
    senses = [GE] if case % 2 == 0 else [EQ, GE, LE]
    inst = _random_instance(rng, 5, 10, senses)
    best, feasible = _brute(inst)
    if not feasible:
        pytest.skip("this draw has no feasible solution")
    inst.feasible_x = feasible[0]
    lb = lagrangian.lower_bound(inst, 300)
    assert lb <= best + 1e-9
    assert lb > -np.inf
    if case % 2 == 0:  # covers: the greedy is a cover, the bound is close
        assert check.violated_rows(inst, lagrangian.greedy_cover(inst)) == 0
        assert lb >= 0.5 * best


def test_bound_matches_the_lp_relaxation_on_a_cover():
    # scp 30x120 at seed 3: the LP relaxation's value, from HiGHS
    inst = set_cover.generate(3, 30, 120, 0.06)
    lb = lagrangian.lower_bound(inst, 2000)
    g = inst.cost @ lagrangian.greedy_cover(inst)
    assert 0.9 * g <= lb <= g


def test_an_answer_with_a_bad_bit_is_caught():
    inst = set_cover.generate(5, 20, 60, 0.1)
    x = lagrangian.greedy_cover(inst)
    assert check.violated_rows(inst, x) == 0
    assert check.violated_rows(inst, np.zeros_like(x)) == inst.m
    assert check.violated_rows(inst, np.full_like(x, 2)) == inst.m
    values = {name: int(v) for name, v in zip(inst.names, x)}
    y, missing = check.solution_vector(inst, values)
    assert missing == 0 and (y == x).all()
    del values[inst.names[0]]
    assert check.solution_vector(inst, values)[1] == 1


@pytest.mark.parametrize("seed", SEEDS)
def test_permutation_keeps_the_instance(seed):
    base = set_cover.generate(1, 30, 100, 0.08)
    p = permuted(base, seed)
    key = lambda inst: sorted(  # noqa: E731
        (tuple(sorted(inst.cost[idx].tolist())), int(s)) for (idx, _), s in zip(inst.rows(), inst.sense)
    )
    assert key(p) == key(base) and sorted(p.cost) == sorted(base.cost)
    assert check.violated_rows(p, p.feasible_x) == 0
    assert check.objective(p, p.feasible_x) == check.objective(base, base.feasible_x)
    assert lagrangian.lower_bound(p, 500) == pytest.approx(lagrangian.lower_bound(base, 500), rel=1e-6)


@pytest.mark.parametrize("seed", SEEDS)
def test_gap_keeps_to_type_d_and_the_port_parses_it(seed):
    import io

    import baryonyx_torch as bt

    m, n = 5, 40
    inst = gap.generate(seed, m, n)
    rows = list(inst.rows())
    assert inst.m == n + m and inst.n == m * n and inst.minimize
    a = np.array([val for _, val in rows[n:]])  # [m, n]: agent i's factor on job j
    assert a.min() >= 1 and a.max() <= 100 and (a == a.round()).all()
    c = inst.cost.reshape(m, n)
    e = c - (111 - a)
    assert e.min() >= -10 and e.max() <= 10
    assert (inst.rhs[n:] == np.floor(0.8 * a.sum(axis=1) / m)).all()
    assert (inst.sense[:n] == EQ).all() and (inst.rhs[:n] == 1).all()
    assert (inst.sense[n:] == LE).all()
    for j, (idx, val) in enumerate(rows[:n]):
        assert idx.tolist() == [i * n + j for i in range(m)] and (val == 1).all()
    raw = bt.make_problem(bt.make_context(0), io.StringIO(inst.lp))
    pb = unpreprocess(bt.make_context(0), raw)
    assert len(pb.vars.names) == inst.n
    assert (len(pb.equal_constraints), len(pb.less_constraints)) == (n, m)


def _program_layout(inst, layout="program"):
    """The program's compiled problem of ``inst`` (``layout`` "window": with
    its DP tables sized to the rows' windows) and its variable names."""
    import io

    import baryonyx_torch as bt
    from baryonyx_torch.ops.layout import compile_problem
    from baryonyx_torch.preprocess.merge import make_merged_constraints

    ctx = bt.make_context(0)
    pb = unpreprocess(ctx, bt.make_problem(ctx, io.StringIO(inst.lp)))
    cp = compile_problem(make_merged_constraints(ctx, pb), len(pb.vars.names), device="cpu")
    return (window_tables(cp) if layout == "window" else cp), pb.vars.names


def _tables(inst, cp, names):
    """The reference's tables with the program's routes, after holding the
    program's tables against them: both checks have to read 0."""
    ref, bad = tables.reference_tables(inst, names, cp.row_vars.numpy(),
                                       cp.r_size.numpy().astype(np.int64), cp.m_real, cp.n)
    program = {k: getattr(cp, k) for k in tables.Z_KEYS + ("row_factor", "bmin", "bmax", "is_eq",
                                                          "neg_count", "has_z", "Wdp",
                                                          "z_needs_walk")}
    program = {k: v.numpy() if isinstance(v, torch.Tensor) else v for k, v in program.items()}
    program["cost"] = torch.as_tensor(ref["cost"], dtype=torch.float32).numpy()
    assert bad == 0 and tables.held_against(ref, program, cp.m_real) == 0
    return tables.follow_routes(ref, program)


@pytest.mark.parametrize("layout", ["program", "window"])
@pytest.mark.parametrize("minimize", [True, False])
@pytest.mark.parametrize("R", [16, 1])  # optimize's replicas on the CPU; solve's one
@pytest.mark.parametrize("size", [(5, 30), (14, 90)])
def test_the_frozen_z_sweep_is_the_programs_bit_for_bit(size, R, minimize, layout):
    """On each route (5 x 30: the job rows enumerate, the capacity rows
    take the DP; 14 x 90: every row walks in the program's layout, the
    capacity rows take the DP in the window-sized one), from a random
    state with a random schedule and order, and after the program's own
    sweep."""
    from baryonyx_torch.ops import zsweep as zs

    inst = permuted(gap.generate(0, *size), 11)  # the instances of tiny.py
    cp, names = _program_layout(inst, layout)
    ref = _tables(inst, cp, names)
    routes = {"enum": ref["enum_row"].any(), "dp": ref["dp_row"].any(), "walk": ref["walk"].any()}
    assert routes == ({"enum": True, "dp": True, "walk": False} if size == (5, 30)
                      else {"enum": False, "dp": layout == "window", "walk": True})

    g = torch.Generator().manual_seed(R + size[0])
    live = cp.row_mask[:, :, None]
    x = (torch.rand((cp.n, R), generator=g) < 0.2).to(torch.int32)
    P = torch.where(live, torch.randn((cp.m, cp.Kr, R), generator=g) * 0.05, 0.0)
    pi = torch.randn((cp.m, R), generator=g) * 0.05
    sched = torch.rand((cp.m, R), generator=g) < 0.7
    order = torch.randperm(cp.m, generator=g).to(torch.int32)
    cost = torch.as_tensor(ref["cost"], dtype=torch.float32)
    kappa, delta, theta, amp = 0.2, 0.01, 0.6, 0.05
    gen = torch.Generator().manual_seed(5)
    st = dict(x=x, P=P, pi=pi, sched=sched, order=order, kappa=kappa, delta=delta, theta=theta,
              amp=amp, minimize=minimize, block_size=8, gen_state=gen.get_state())
    for _ in range(2):  # a sweep from the random state, then one after the program's
        want = sweep_z.z_sweep(tables.on_device(ref, torch.float32, "cpu"), st)
        got = zs.z_sweep(cp, st["x"].clone(), st["P"].clone(), st["pi"].clone(), cost, sched,
                         order, kappa, delta, theta, gen, amp, minimize=minimize, block_size=8)
        for a, b in zip(want, got[:4]):
            assert tables.mismatches(a, b) == 0
        st.update(x=got[0], P=got[1], pi=got[2], gen_state=gen.get_state())
    control = sweep_z.z_sweep(tables.on_device(ref, torch.bfloat16, "cpu"), st, torch.bfloat16)
    got = zs.z_sweep(cp, st["x"].clone(), st["P"].clone(), st["pi"].clone(), cost, sched, order,
                     kappa, delta, theta, gen, amp, minimize=minimize, block_size=8)
    assert sum(tables.mismatches(a, b) for a, b in zip(control, got[:4])) > 0


@pytest.mark.parametrize("size", [(14, 90), (20, 200)])
def test_the_window_layout_sends_the_capacity_rows_to_the_dp(size):
    """GAP type D's capacity rows walk in the program's layout (their span,
    sum_j a_ij + 1, passes 4,096) and take the DP in the window-sized one,
    on tables of b_i + 1 entries; the job rows walk in both. Both layouts'
    tables read 0."""
    m, n = size
    inst = permuted(gap.generate(0, m, n), 11)
    b = inst.rhs[inst.sense == LE]
    for layout in ("program", "window"):
        cp, names = _program_layout(inst, layout)
        ref = _tables(inst, cp, names)
        capacity = ref["r_size"] == n
        assert capacity.sum() == m and ref["walk"][ref["r_size"] == m].all()
        assert sorted(ref["win_w"][capacity]) == sorted(b + 1)
        if layout == "program":
            assert not ref["dp_row"].any() and cp.Wdp == 0
        else:
            assert ref["dp_row"][capacity].all() and cp.Wdp == tables.bucket(int(b.max()) + 1, 8)
    if size == (20, 200):
        assert cp.Wdp < 512


def _block_of_gap5x30(layout):
    """One block of GAP 5 x 30: its 5 capacity rows (DP rows) and 3 job
    rows, with the reference's tables at the layout's routes."""
    inst = permuted(gap.generate(0, 5, 30), 11)
    cp, names = _program_layout(inst, layout)
    ref = _tables(inst, cp, names)
    rows = np.concatenate([np.flatnonzero(ref["dp_row"]), np.flatnonzero(ref["enum_row"])[:3]])
    return inst, cp, ref, torch.as_tensor(rows, dtype=torch.int32)


@pytest.mark.parametrize("R, itemsize", [(512, 4), (1, 8)])
def test_dpselect_bound_is_a_hand_count(R, itemsize):
    """Kernel B's least time on one block of GAP 5 x 30: each capacity
    row's window is [0, b_i] (its factors are positive with gcd 1), its
    slots are the 30 jobs."""
    from ilpbench.roofline import PEAKS, dpselect_bound

    kind = "NVIDIA H100 80GB HBM3"
    inst, cp, ref, rows = _block_of_gap5x30("program")
    b = inst.rhs[inst.sense == LE]
    assert len(b) == 5 and int(ref["dp_row"][rows.long()].sum()) == 5
    ops = R * sum((bi + 1) * (1 + 5 * 30 + 4) + 2 * 30 for bi in b)
    nbytes = 5 * 8 + 5 * ((itemsize + 1) * 30 * R + 5 * 30 + 12)
    got = dpselect_bound(ref, rows, R, itemsize, kind)
    assert (got["ops"], got["bytes"]) == (ops, nbytes)
    rate = PEAKS[kind]["f32_ops_per_s"] * 4 / itemsize
    assert got["ms"] == max(ops / rate, nbytes / PEAKS[kind]["hbm_bytes_per_s"]) * 1e3


def test_dpselect_bound_is_the_same_on_the_whole_span_and_on_the_window():
    """The program's table spans sum_j a_ij + 1 activities, the window-sized
    one b_i + 1: the least time of the same block is the same."""
    from ilpbench.roofline import dpselect_bound

    kind = "NVIDIA H100 80GB HBM3"
    _, span_cp, span_ref, rows = _block_of_gap5x30("program")
    _, win_cp, win_ref, win_rows = _block_of_gap5x30("window")
    assert win_cp.Wdp < span_cp.Wdp and (rows == win_rows).all()
    for R, itemsize in ((512, 4), (1, 8)):
        assert (dpselect_bound(span_ref, rows, R, itemsize, kind)
                == dpselect_bound(win_ref, rows, R, itemsize, kind))
