"""Every row of a solution, and its objective, from the instance's own
arrays."""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

from ilpbench.reference.instance import EQ, GE, LE, Instance


def activities(inst: Instance, x: np.ndarray) -> np.ndarray:
    """A x, row by row, in float64."""
    prod = inst.row_val * x[inst.row_idx]
    return np.add.reduceat(prod, inst.row_ptr[:-1]) if len(prod) else np.zeros(inst.m)


def violated_rows(inst: Instance, x: np.ndarray) -> int:
    """Rows of the instance that x leaves unsatisfied; an x that is not
    0/1 violates every row."""
    x = np.asarray(x)
    if x.shape != (inst.n,) or not np.isin(x, (0, 1)).all():
        return inst.m
    if not set(np.unique(inst.sense).tolist()) <= {GE, EQ, LE}:
        raise ValueError("check: a row sense other than >=, = or <=")
    act = activities(inst, x.astype(np.float64))
    bad = np.where(
        inst.sense == GE, act < inst.rhs,
        np.where(inst.sense == EQ, act != inst.rhs, act > inst.rhs),
    )
    return int(bad.sum())


def objective(inst: Instance, x: np.ndarray) -> float:
    return float(inst.cost @ np.asarray(x, dtype=np.float64))


def solution_vector(inst: Instance, values: Dict[str, int]) -> Tuple[np.ndarray, int]:
    """The 0/1 vector of a solution given by variable name, and how many
    of the instance's variables it leaves out (each set to 0)."""
    x = np.zeros(inst.n, dtype=np.int64)
    missing = 0
    for j, name in enumerate(inst.names):
        v = values.get(name)
        if v is None:
            missing += 1
        else:
            x[j] = int(v)
    return x, missing
