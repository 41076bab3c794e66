"""The plain reference on its own: the generator copies against the
port's generators, the feasibility check and the Lagrangian bound against
brute force, the permutation, and the control in bfloat16."""

from __future__ import annotations

import itertools

import numpy as np
import pytest

from baryonyx_torch.generators import random_set_cover_lp
from ilpbench.generators import set_cover
from ilpbench.reference import check, lagrangian
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
