"""The plain reference on its own: the generator copies against the
port's generators, the generalised assignment generator against its
published rules, the feasibility check and the Lagrangian bound against
brute force, the permutation, the frozen Z sweep against the program's
and its bfloat16 control, and kernel B's least time."""

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


def _program_layout(inst):
    """The program's compiled problem of ``inst`` and its variable names."""
    import io

    import baryonyx_torch as bt
    from baryonyx_torch.ops.layout import compile_problem
    from baryonyx_torch.preprocess.merge import make_merged_constraints

    ctx = bt.make_context(0)
    pb = unpreprocess(ctx, bt.make_problem(ctx, io.StringIO(inst.lp)))
    cp = compile_problem(make_merged_constraints(ctx, pb), len(pb.vars.names), device="cpu")
    return cp, pb.vars.names


@pytest.mark.parametrize("minimize", [True, False])
@pytest.mark.parametrize("R", [16, 1])  # optimize's replicas on the CPU; solve's one
@pytest.mark.parametrize("size", [(5, 30), (14, 90)])
def test_the_frozen_z_sweep_is_the_programs_bit_for_bit(size, R, minimize):
    """On each route (5 x 30: the job rows enumerate, the capacity rows
    take the DP; 14 x 90: every row walks), from a random state with a
    random schedule and order, and after the program's own sweep."""
    from baryonyx_torch.ops import zsweep as zs

    inst = permuted(gap.generate(0, *size), 11)  # the instances of tiny.py
    cp, names = _program_layout(inst)
    ref, bad = tables.reference_tables(inst, names, cp.row_vars.numpy(),
                                       cp.r_size.numpy().astype(np.int64), cp.m_real, cp.n)
    program = {k: getattr(cp, k) for k in tables.Z_KEYS + ("row_factor", "bmin", "bmax", "is_eq",
                                                          "neg_count", "has_z", "Wdp",
                                                          "z_needs_walk")}
    program = {k: v.numpy() if isinstance(v, torch.Tensor) else v for k, v in program.items()}
    program["cost"] = torch.as_tensor(ref["cost"], dtype=torch.float32).numpy()
    assert bad == 0 and tables.held_against(ref, program, cp.m_real) == 0
    routes = {"enum": ref["enum_row"].any(), "dp": ref["dp_row"].any(), "walk": ref["walk"].any()}
    assert routes == ({"enum": True, "dp": True, "walk": False} if size == (5, 30)
                      else {"enum": False, "dp": False, "walk": True})

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


def test_dpselect_bound_is_chip_smokes_dp_bound():
    """``roofline.dpselect_bound`` against ``dp_bound`` as the program's
    ``chip_smoke.py`` defines it (read from its source), on one block of a
    layout with DP rows."""
    import ast
    from types import SimpleNamespace

    from ilpbench import manifest
    from ilpbench.roofline import PEAKS, dpselect_bound

    src = (manifest.ROOT / "chip_smoke.py").read_text()
    node = next(n for n in ast.walk(ast.parse(src))
                if isinstance(n, ast.FunctionDef) and n.name == "dp_bound")
    kind = "NVIDIA H100 80GB HBM3"
    rates = {"HBM_BYTES_PER_S": PEAKS[kind]["hbm_bytes_per_s"],
             "F32_OPS_PER_S": PEAKS[kind]["f32_ops_per_s"]}
    scope = dict(rates)
    exec(compile(ast.Module([node], []), "chip_smoke.py", "exec"), scope)
    inst = permuted(gap.generate(0, 5, 30), 11)
    cp, names = _program_layout(inst)
    ref, _ = tables.reference_tables(inst, names, cp.row_vars.numpy(),
                                     cp.r_size.numpy().astype(np.int64), cp.m_real, cp.n)
    rows = torch.nonzero(cp.dp_row).flatten()[:8].to(torch.int32)
    rows = torch.cat([rows, torch.arange(8 - rows.numel(), dtype=torch.int32)])  # non-DP rows too
    cp_like = SimpleNamespace(Wdp=ref["Wdp"], Kr=cp.Kr, dp_row=torch.as_tensor(ref["dp_row"]))
    for R, itemsize, rate in ((512, 4, rates["F32_OPS_PER_S"]), (1, 8, rates["F32_OPS_PER_S"] / 2)):
        ms, by = scope["dp_bound"](cp_like, rows, R, itemsize, rate)
        got = dpselect_bound(ref, rows, R, itemsize, kind)
        assert (got["ms"], got["by"]) == (ms, by)
