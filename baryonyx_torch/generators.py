"""Problem generators used as test and benchmark fixtures.

``n_queens_lp`` mirrors the reference's streaming n-queens LP generator
(reference: lib/include/baryonyx/core-test:31-115). The random SCP / SPP /
assignment generators stand in for the OR-Library benchmark instances,
which the reference fetches over the network (reference:
benchmarks/download.sh) and therefore cannot ship here.
"""

from __future__ import annotations

import random
from typing import List, Optional


def n_queens_lp(n: int, costs: Optional[List[float]] = None) -> str:
    """n-queens as a 0-1 LP: n² binaries, one-per-row/column equalities,
    at-most-one per diagonal (reference: core-test:31-115). ``costs``
    optionally assigns one objective coefficient per cell, matching the
    randomized-cost regression tests (reference: lib/test/optimize.cpp:89-166)."""
    if n < 3:
        raise ValueError("n_queens needs n >= 3")

    def var(i: int, j: int) -> str:
        return f"x_{i}_{j}"

    out: List[str] = ["minimize"]
    if costs is None:
        out.append(" + ".join(var(i, j) for i in range(n) for j in range(n)))
    else:
        assert len(costs) == n * n
        out.append(
            " ".join(
                f"+ {costs[i * n + j]} {var(i, j)}" for i in range(n) for j in range(n)
            )
        )
    out.append("subject to")
    for i in range(n):
        out.append(" + ".join(var(i, j) for j in range(n)) + " = 1")
    for j in range(n):
        out.append(" + ".join(var(i, j) for i in range(n)) + " = 1")

    diags: List[List[str]] = []
    # down-right diagonals
    for d in range(1, n - 1):
        diags.append([var(d + t, t) for t in range(n - d)])
    for d in range(0, n - 1):
        diags.append([var(t, d + t) for t in range(n - d)])
    # up-right diagonals
    for d in range(1, n):
        diags.append([var(d - t, t) for t in range(d + 1)])
    for d in range(1, n - 1):
        diags.append([var(n - 1 - t, d + t) for t in range(n - d)])
    for cells in diags:
        if len(cells) > 1:
            out.append(" + ".join(cells) + " <= 1")

    out.append("binary")
    out.append(" ".join(var(i, j) for i in range(n) for j in range(n)))
    out.append("end")
    return "\n".join(out) + "\n"


def random_set_cover_lp(
    m: int,
    n: int,
    density: float = 0.1,
    cost_range=(1, 100),
    seed: int = 0,
) -> str:
    """OR-Library-style set covering: minimize c·x s.t. Ax >= 1, A in {0,1}.

    Every row gets at least 2 covering columns and every column covers at
    least one row, so the instance is feasible (x = 1 is always a cover).
    """
    rng = random.Random(seed)
    rows: List[List[int]] = [[] for _ in range(m)]
    for k in range(m):
        for j in range(n):
            if rng.random() < density:
                rows[k].append(j)
        while len(rows[k]) < 2:
            j = rng.randrange(n)
            if j not in rows[k]:
                rows[k].append(j)
    costs = [rng.randint(*cost_range) for _ in range(n)]

    out = ["minimize"]
    out.append(" ".join(f"+ {costs[j]} x{j}" for j in range(n)))
    out.append("subject to")
    for k in range(m):
        out.append("c%d: " % k + " + ".join(f"x{j}" for j in sorted(rows[k])) + " >= 1")
    out.append("binary")
    out.append(" ".join(f"x{j}" for j in range(n)))
    out.append("end")
    return "\n".join(out) + "\n"


def random_set_partition_lp(
    m: int,
    n_blocks: int,
    block_size: int = 3,
    cost_range=(1, 100),
    extra_columns: int = 0,
    seed: int = 0,
) -> str:
    """Set partitioning: minimize c·x s.t. Ax = 1 per row.

    Built feasible by construction: ``n_blocks`` disjoint columns exactly
    partition the m rows, then ``extra_columns`` random overlapping columns
    are added as decoys (like SPP crew-scheduling instances).
    """
    rng = random.Random(seed)
    elements = list(range(m))
    rng.shuffle(elements)
    cols: List[List[int]] = []
    # partition columns
    chunk = max(1, m // n_blocks)
    i = 0
    while i < m:
        cols.append(sorted(elements[i : i + chunk]))
        i += chunk
    # decoy columns
    for _ in range(extra_columns):
        size = rng.randint(1, max(1, block_size))
        cols.append(sorted(rng.sample(range(m), min(size, m))))
    costs = [rng.randint(*cost_range) for _ in cols]

    out = ["minimize"]
    out.append(" ".join(f"+ {costs[j]} x{j}" for j in range(len(cols))))
    out.append("subject to")
    for k in range(m):
        members = [j for j, col in enumerate(cols) if k in col]
        out.append("c%d: " % k + " + ".join(f"x{j}" for j in members) + " = 1")
    out.append("binary")
    out.append(" ".join(f"x{j}" for j in range(len(cols))))
    out.append("end")
    return "\n".join(out) + "\n"


def random_assignment_lp(n: int, cost_range=(1, 100), seed: int = 0) -> str:
    """n×n assignment problem: each agent/task exactly one match."""
    rng = random.Random(seed)

    def var(i: int, j: int) -> str:
        return f"a{i}_{j}"

    out = ["minimize"]
    out.append(
        " ".join(
            f"+ {rng.randint(*cost_range)} {var(i, j)}"
            for i in range(n)
            for j in range(n)
        )
    )
    out.append("subject to")
    for i in range(n):
        out.append(" + ".join(var(i, j) for j in range(n)) + " = 1")
    for j in range(n):
        out.append(" + ".join(var(i, j) for i in range(n)) + " = 1")
    out.append("binary")
    out.append(" ".join(var(i, j) for i in range(n) for j in range(n)))
    out.append("end")
    return "\n".join(out) + "\n"


def random_knapsack_101_lp(
    n: int, m: int = 4, cost_range=(1, 50), seed: int = 0
) -> str:
    """Inequality instance with ±1 coefficients (exercises the 101 kernel):
    maximize c·x subject to mixed-sign rows with slack bounds."""
    rng = random.Random(seed)
    out = ["maximize"]
    out.append(" ".join(f"+ {rng.randint(*cost_range)} x{j}" for j in range(n)))
    out.append("subject to")
    for k in range(m):
        terms = []
        npos = 0
        for j in rng.sample(range(n), max(2, n // 2)):
            if rng.random() < 0.3:
                terms.append(f"- x{j}")
            else:
                terms.append(f"+ x{j}")
                npos += 1
        rhs = max(1, npos // 2)
        out.append(" ".join(terms) + f" <= {rhs}")
    out.append("binary")
    out.append(" ".join(f"x{j}" for j in range(n)))
    out.append("end")
    return "\n".join(out) + "\n"


def contradiction_cover_lp(groups: int, group_size: int = 20, seed: int = 0) -> str:
    """Deliberately infeasible cover pairs, used by the head-to-head
    throughput treadmill (scripts/head_to_head.py).

    Per group of ``group_size`` variables: row A requires >= 60% of the
    group set, row B caps the same group minus its last variable at 25% —
    jointly unsatisfiable, so at least one of the pair is violated under
    every assignment and a solver sweeps forever (~50% sustained violation)
    instead of converging. Row lengths match SCP-class instances, making
    measured row-update throughput transferable. The reference has no such
    fixture; its solve loop has no other sustained-sweep regime to measure
    (it only processes violated rows and restarts from near-feasible
    population members: itm-optimizer-common.hpp:658-694).
    """
    rng = random.Random(seed)
    n = groups * group_size
    hi = max(2, int(group_size * 0.6))
    lo = max(1, int(group_size * 0.25))
    out = ["minimize"]
    out.append(" ".join(f"+ {1 + rng.randint(0, 6)} x{j}" for j in range(n)))
    out.append("subject to")
    for g in range(groups):
        vs = [f"x{group_size * g + i}" for i in range(group_size)]
        out.append(f"ca{g}: " + " + ".join(vs) + f" >= {hi}")
        out.append(f"cb{g}: " + " + ".join(vs[:-1]) + f" <= {lo}")
    out.append("binary")
    out.append(" ".join(f"x{j}" for j in range(n)))
    out.append("end")
    return "\n".join(out) + "\n"


def bus_driver_scheduling_lp(
    pieces: int = 60,
    shifts_per_piece: int = 12,
    max_run: int = 5,
    seed: int = 0,
) -> str:
    """csplib022-class bus-driver scheduling: unit-cost set partitioning
    where each column (shift) covers a contiguous run of work pieces and
    the objective counts shifts (reference suite:
    benchmarks/csplib022.csv:1-13 — c1..t2, `min #shifts`, long sparse
    rows: every piece appears in many candidate shifts).

    Feasible by construction: a chain of disjoint runs covers [0, pieces)
    exactly; the rest are random overlapping runs (the realistic column
    pool a crew-scheduling column generator would emit).
    """
    rng = random.Random(seed)
    cols: List[List[int]] = []
    i = 0
    while i < pieces:
        run = rng.randint(2, max_run)
        cols.append(list(range(i, min(i + run, pieces))))
        i += run
    target_cols = pieces * shifts_per_piece // ((2 + max_run) // 2)
    while len(cols) < target_cols:
        start = rng.randrange(pieces)
        run = rng.randint(2, max_run)
        cols.append(list(range(start, min(start + run, pieces))))
    out = ["minimize"]
    out.append(" ".join(f"+ x{j}" for j in range(len(cols))))
    out.append("subject to")
    for k in range(pieces):
        members = [j for j, col in enumerate(cols) if k in col]
        out.append("c%d: " % k + " + ".join(f"x{j}" for j in members) + " = 1")
    out.append("binary")
    out.append(" ".join(f"x{j}" for j in range(len(cols))))
    out.append("end")
    return "\n".join(out) + "\n"


def telebus_crew_lp(
    requests: int = 80,
    tours_per_request: int = 10,
    max_tour: int = 4,
    cost_range=(20_000, 900_000),
    seed: int = 0,
) -> str:
    """telebus-class dial-a-ride crew scheduling: set partitioning with
    large integer costs (reference suite: benchmarks/telebus.csv:1-29 —
    t04xx/t17xx/v04xx/v16xx, costs in the 1e5-1e7 range, `min cost`).

    Columns are candidate vehicle tours serving 1..max_tour requests;
    tour cost grows superlinearly with tour span (detour effect), so the
    optimum balances consolidation against detours. Feasible by
    construction (a disjoint tour cover exists).
    """
    rng = random.Random(seed)
    cols: List[List[int]] = []
    ids = list(range(requests))
    rng.shuffle(ids)
    i = 0
    while i < requests:
        size = rng.randint(1, max_tour)
        cols.append(sorted(ids[i : i + size]))
        i += size
    target = requests * tours_per_request // ((1 + max_tour) // 2 + 1)
    while len(cols) < target:
        size = rng.randint(1, max_tour)
        cols.append(sorted(rng.sample(range(requests), min(size, requests))))
    lo, hi = cost_range
    costs = []
    for col in cols:
        base = rng.randint(lo, lo * 3)
        detour = int((len(col) ** 1.3) * rng.randint(lo // 4, hi // (2 * max_tour)))
        costs.append(min(base + detour, hi))
    out = ["minimize"]
    out.append(" ".join(f"+ {costs[j]} x{j}" for j in range(len(cols))))
    out.append("subject to")
    for k in range(requests):
        members = [j for j, col in enumerate(cols) if k in col]
        out.append("c%d: " % k + " + ".join(f"x{j}" for j in members) + " = 1")
    out.append("binary")
    out.append(" ".join(f"x{j}" for j in range(len(cols))))
    out.append("end")
    return "\n".join(out) + "\n"


def random_qsap_lp(
    groups: int,
    choices: int,
    quad_per_var: int = 8,
    lin_range=(-50, 50),
    quad_range=(-30, 30),
    seed: int = 0,
) -> str:
    """Quadratic semi-assignment: pick one choice per group, with random
    quadratic couplings BETWEEN groups (QAP-family objective; reference
    quadratic tests: lib/test/optimize.cpp:55-87, cost machinery
    itm-common.hpp:1150-1440).

    Deliberately UNFOLDABLE by preprocess/products.py: the quadratic
    terms couple choice variables directly (no marginal-grid product
    linearization pattern), so the solver must run its quadratic kernel
    (the CQ matmul in ops/psweep.py / per-slot gathers in ops/sweep.py)
    rather than the exact product-fold route — the at-scale quadratic
    evidence VERDICT r4 item 3 asks for. n = groups * choices variables.
    """
    rng = random.Random(seed)
    n = groups * choices

    def var(g: int, c: int) -> str:
        return f"x{g}_{c}"

    lin = []
    for g in range(groups):
        for c in range(choices):
            f = rng.randint(*lin_range)
            if f:
                lin.append(f"{'+' if f > 0 else '-'} {abs(f)} {var(g, c)}")
    quad = []
    for g in range(groups):
        for c in range(choices):
            for _ in range(max(0, quad_per_var) // 2):
                g2 = rng.randrange(groups)
                if g2 == g:
                    continue
                c2 = rng.randrange(choices)
                q = rng.randint(*quad_range)
                if q:
                    # LP quadratic block convention: [ 2q a*b ] / 2.
                    # NOTE: `a*b` attached, no spaces — the reference
                    # parser mis-tokenizes `a * b` inside multi-term
                    # brackets (creates a phantom real variable), so the
                    # generated files use the form its own tests use
                    # (io.cpp:312-320)
                    quad.append(
                        f"{'+' if q > 0 else '-'} {2 * abs(q)} "
                        f"{var(g, c)}*{var(g2, c2)}"
                    )
    out = ["minimize", "obj: " + " ".join(lin)
           + " + [ " + " ".join(quad) + " ] / 2"]
    out.append("subject to")
    for g in range(groups):
        out.append(
            f"g{g}: " + " + ".join(var(g, c) for c in range(choices)) + " = 1"
        )
    out.append("binary")
    out.append(" ".join(var(g, c) for g in range(groups) for c in range(choices)))
    out.append("end")
    return "\n".join(out) + "\n"


def random_z_multiknapsack_lp(
    m: int,
    n: int,
    row_len=(6, 24),
    coeff_range=(1, 5),
    slack: int = 3,
    cost_range=(1, 100),
    seed: int = 0,
) -> str:
    """General-integer-coefficient (Z-class) instance: mixed-sign rows
    with |a| in ``coeff_range``, row lengths spanning the exact-enum
    (<= 12 vars) and DP regimes of ops/zsweep.py (reference solver:
    lib/src/itm-solver-inequalities-Z.cpp:32-565). Feasible by
    construction: bounds brace a random reference assignment."""
    rng = random.Random(seed)
    x0 = [rng.randint(0, 1) for _ in range(n)]
    out = ["minimize"]
    out.append(" ".join(f"+ {rng.randint(*cost_range)} x{j}" for j in range(n)))
    out.append("subject to")
    for k in range(m):
        length = rng.randint(*row_len)
        idx = rng.sample(range(n), length)
        coefs = [
            rng.randint(*coeff_range) * (1 if rng.random() < 0.6 else -1)
            for _ in idx
        ]
        act = sum(c * x0[j] for c, j in zip(coefs, idx))
        lhs = " ".join(
            f"{'+' if c > 0 else '-'} {abs(c)} x{j}" for c, j in zip(coefs, idx)
        )
        if rng.random() < 0.5:
            out.append(f"c{k}: {lhs} <= {act + rng.randint(0, slack)}")
        else:
            out.append(f"c{k}: {lhs} >= {act - rng.randint(0, slack)}")
    out.append("binary")
    out.append(" ".join(f"x{j}" for j in range(n)))
    out.append("end")
    return "\n".join(out) + "\n"


def contradiction_z_lp(groups: int, group_size: int = 20, seed: int = 0) -> str:
    """Z-coefficient treadmill (throughput measurement): per group, a
    coefficient-2 demand row and a conflicting cap over the same group
    minus its last variable — jointly unsatisfiable, so solvers sweep
    forever (the Z analogue of contradiction_cover_lp; reference Z
    solver: lib/src/itm-solver-inequalities-Z.cpp)."""
    rng = random.Random(seed)
    hi = max(2, int(group_size * 0.6))
    lo = max(1, int(group_size * 0.25))
    out = ["minimize"]
    n = groups * group_size
    out.append(" ".join(f"+ {rng.randint(1, 50)} x{j}" for j in range(n)))
    out.append("subject to")
    for g in range(groups):
        base = g * group_size
        full = [f"2 x{base + t}" for t in range(group_size)]
        sub = [f"2 x{base + t}" for t in range(group_size - 1)]
        out.append(f"a{g}: " + " + ".join(full) + f" >= {2 * hi}")
        out.append(f"b{g}: " + " + ".join(sub) + f" <= {2 * lo}")
    out.append("binary")
    out.append(" ".join(f"x{j}" for j in range(n)))
    out.append("end")
    return "\n".join(out) + "\n"
