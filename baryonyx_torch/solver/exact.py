"""Exact enumeration for tiny problems.

After preprocessing (variable fixing + product folding) some instances
collapse to a handful of free variables — QAP small4 becomes a 16-var
assignment polytope (preprocess/products.py). For n <= EXACT_N_MAX the
full 2^n enumeration is one chunked numpy matmul: exact, deterministic
and instant, where any restart heuristic (ours or the reference's
thread pool) only finds the optimum with luck. No reference analogue —
the reference always runs its dual-descent loop (itm.hpp:94-203).
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

from baryonyx_torch.core.model import ObjectiveType, Problem
from baryonyx_torch.preprocess.merge import MergedConstraint

EXACT_N_MAX = 20
_CHUNK = 1 << 16


def exact_enumerate(
    pb: Problem, constraints: List[MergedConstraint], n: int
) -> Optional[Tuple[np.ndarray, float]]:
    """Optimal assignment of an n <= EXACT_N_MAX problem, or None when the
    instance is infeasible (callers fall through to the heuristic, which
    reports remaining-constraint counts the way the reference does)."""
    if n > EXACT_N_MAX or n <= 0:
        return None
    m = len(constraints)
    A = np.zeros((m, n), np.int64)
    bmin = np.empty(m, np.int64)
    bmax = np.empty(m, np.int64)
    for k, cst in enumerate(constraints):
        for el in cst.elements:
            A[k, el.variable_index] += el.factor
        bmin[k], bmax[k] = cst.min, cst.max

    c = np.zeros(n, np.float64)
    for el in pb.objective.elements:
        c[el.variable_index] += el.factor
    qa = np.array([q.variable_index_a for q in pb.objective.qelements], np.int64)
    qb = np.array([q.variable_index_b for q in pb.objective.qelements], np.int64)
    qf = np.array([q.factor for q in pb.objective.qelements], np.float64)

    minimize = pb.type == ObjectiveType.minimize
    best_val = np.inf
    best_bits: Optional[np.ndarray] = None
    total = 1 << n
    shifts = np.arange(n, dtype=np.uint64)
    for start in range(0, total, _CHUNK):
        idx = np.arange(start, min(start + _CHUNK, total), dtype=np.uint64)
        bits = ((idx[:, None] >> shifts) & 1).astype(np.int64)  # [C, n]
        act = bits @ A.T
        feas = ((act >= bmin) & (act <= bmax)).all(axis=1)
        if not feas.any():
            continue
        fb = bits[feas]
        vals = fb @ c
        if len(qf):
            vals = vals + (fb[:, qa] * fb[:, qb]) @ qf
        score = vals if minimize else -vals
        i = int(np.argmin(score))
        if score[i] < best_val:
            best_val = float(score[i])
            best_bits = fb[i]
    if best_bits is None:
        return None
    value = best_val if minimize else -best_val
    return best_bits.astype(np.int32), value + pb.objective.value
