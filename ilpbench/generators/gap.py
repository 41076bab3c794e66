"""OR-Library generalised assignment, type D (Chu and Beasley 1997, "A
genetic algorithm for the generalised assignment problem"; OR-Library's
gapd set): m agents, n jobs, variable x_ij (agent i does job j),

    minimize  sum_ij c_ij x_ij
    s.t.      sum_i x_ij = 1           for every job j    (n rows, m unit factors)
              sum_j a_ij x_ij <= b_i   for every agent i  (m rows, n factors)

with a_ij uniform on the integers 1..100, c_ij = 111 - a_ij + e_ij with
e_ij uniform on the integers -10..10, and b_i = 0.8 sum_j a_ij / m rounded
down to an integer (the paper states no rounding; the capacity must be a
whole number, and down keeps the rows as tight as the rule allows). The
draws come from ``numpy.random.default_rng(seed)``."""

from __future__ import annotations

import numpy as np

from ilpbench.reference.instance import EQ, LE, Instance, from_rows

A_RANGE = (1, 100)
E_RANGE = (-10, 10)
C_BASE = 111
TIGHTNESS = 0.8


def generate(seed: int, m: int, n: int) -> Instance:
    rng = np.random.default_rng(seed)
    a = rng.integers(A_RANGE[0], A_RANGE[1] + 1, size=(m, n))
    c = C_BASE - a + rng.integers(E_RANGE[0], E_RANGE[1] + 1, size=(m, n))
    b = np.floor(TIGHTNESS * a.sum(axis=1) / m).astype(np.int64)
    var = np.arange(m * n).reshape(m, n)  # x_ij is variable i * n + j
    rows = [(var[:, j], np.ones(m)) for j in range(n)]
    rows += [(var[i], a[i].astype(np.float64)) for i in range(m)]
    return from_rows(
        [f"x{i}_{j}" for i in range(m) for j in range(n)], c.reshape(-1), rows,
        [EQ] * n + [LE] * m, np.concatenate([np.ones(n), b]),
    )
