"""The Lagrangian lower bound of a 0-1 program min c x, A x (>=, =, <=) b,
by subgradient optimisation with a fixed number of iterations.

L(u) = u b + sum_j min(0, c_j - (u A)_j), with u >= 0 on >= rows, u <= 0
on <= rows and u free on = rows; every L(u) is a lower bound. Steps follow
Held and Karp: lambda (UB - L(u)) / |g|^2 along the subgradient
g = b - A x(u), lambda halved after ``patience`` iterations without a
better bound. UB is the reference's own: a greedy cover where every row
is a unit-factor cover row, else the instance's known feasible solution.
The result depends on the instance alone."""

from __future__ import annotations

import numpy as np

from ilpbench.reference.check import violated_rows
from ilpbench.reference.instance import GE, LE, Instance


def _col_sums(inst: Instance, u: np.ndarray) -> np.ndarray:
    """(u A)_j."""
    rows = np.repeat(np.arange(inst.m), np.diff(inst.row_ptr))
    return np.bincount(inst.row_idx, weights=u[rows] * inst.row_val, minlength=inst.n)


def greedy_cover(inst: Instance) -> np.ndarray:
    """Chvatal's greedy for a cover (every row >= 1 over unit factors):
    take the column of least cost per newly covered row until all rows
    are covered, then drop columns that no row needs, costliest first."""
    cols = [[] for _ in range(inst.n)]
    for i, (idx, _) in enumerate(inst.rows()):
        for j in idx:
            cols[j].append(i)
    covered = np.zeros(inst.m, dtype=bool)
    x = np.zeros(inst.n, dtype=np.int64)
    while not covered.all():
        gain = np.array([sum(not covered[i] for i in c) for c in cols], dtype=np.float64)
        ratio = np.where(gain > 0, inst.cost / np.maximum(gain, 1), np.inf)
        j = int(np.argmin(ratio))
        x[j] = 1
        covered[cols[j]] = True
    count = np.zeros(inst.m, dtype=np.int64)
    for j in np.flatnonzero(x):
        count[cols[j]] += 1
    for j in sorted(np.flatnonzero(x), key=lambda j: -inst.cost[j]):
        if all(count[i] > 1 for i in cols[j]):
            x[j] = 0
            count[cols[j]] -= 1
    return x


def upper_bound(inst: Instance) -> float:
    cover = (
        (inst.sense == GE).all() and (inst.rhs == 1).all() and (inst.row_val == 1).all()
    )
    x = greedy_cover(inst) if cover else inst.feasible_x
    if x is None or violated_rows(inst, x):
        raise ValueError("lagrangian: the instance has no known feasible solution")
    return float(inst.cost @ x)


def lower_bound(inst: Instance, iterations: int, patience: int = 30) -> float:
    """The best L(u) over ``iterations`` subgradient steps."""
    if not inst.minimize:
        raise ValueError("lagrangian: minimisation only")
    ub = upper_bound(inst)
    c = inst.cost
    # start: each row's cheapest column cost shared over the column's rows
    ncol = np.maximum(np.bincount(inst.row_idx, minlength=inst.n), 1)
    share = c / ncol
    u = np.array([share[idx].min() if len(idx) else 0.0 for idx, _ in inst.rows()])
    u = np.where(inst.sense == LE, -u, u)
    rows = np.repeat(np.arange(inst.m), np.diff(inst.row_ptr))
    lam, best, since = 2.0, -np.inf, 0
    for _ in range(iterations):
        red = c - _col_sums(inst, u)
        x = (red < 0).astype(np.float64)
        value = float(u @ inst.rhs + np.minimum(red, 0.0).sum())
        if best == -np.inf or value > best + 1e-9 * abs(best):
            best, since = value, 0
        else:
            since += 1
            if since >= patience:
                lam, since = lam / 2, 0
        g = inst.rhs - np.bincount(rows, weights=inst.row_val * x[inst.row_idx], minlength=inst.m)
        g = np.where((inst.sense == GE) & (u <= 0) & (g < 0), 0.0, g)
        g = np.where((inst.sense == LE) & (u >= 0) & (g > 0), 0.0, g)
        norm = float(g @ g)
        if norm == 0:
            break  # x(u) is feasible and complementary: L(u) is the optimum
        u = u + lam * (ub - value) / norm * g
        u = np.where(inst.sense == GE, np.maximum(u, 0.0), u)
        u = np.where(inst.sense == LE, np.minimum(u, 0.0), u)
    return best
