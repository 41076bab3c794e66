"""OR-Library-style set covering (Beasley): minimize c x subject to
A x >= 1, A in {0, 1}, each row taking each column with probability
``density``, at least 2 columns a row, integer costs in ``cost_range``.

The LP text is the port's ``random_set_cover_lp`` for the same arguments,
character for character (the same draws of ``random.Random(seed)``)."""

from __future__ import annotations

import random

from ilpbench.reference.instance import GE, Instance, from_rows

TINY_ARGS = {"m": 40, "n": 200, "density": 0.05}  # the CPU tests' size (tests/tiny.py)


def generate(seed: int, m: int, n: int, density: float, cost_range=(1, 100)) -> Instance:
    rng = random.Random(seed)
    rows = [[] for _ in range(m)]
    for k in range(m):
        for j in range(n):
            if rng.random() < density:
                rows[k].append(j)
        while len(rows[k]) < 2:
            j = rng.randrange(n)
            if j not in rows[k]:
                rows[k].append(j)
    costs = [rng.randint(*cost_range) for _ in range(n)]
    return from_rows(
        [f"x{j}" for j in range(n)], costs,
        [(sorted(r), [1.0] * len(r)) for r in rows], [GE] * m, [1.0] * m,
        feasible_x=[1] * n,
    )
