"""The sweep's row and cost tables, worked out from the instance in the
program's layout, and how far the program's own tables differ.

The layout is the program's: which variable each column holds (its
name), which row each row holds and which variable sits in each slot
(``row_vars``), since the kept sweep state (P, x, S) is laid out so. The
values are the instance's: each slot's factor, each row's bounds, each
column's normalised cost (the default ``loo`` norm: c / max c over the
program's variables). Rows with factors other than +1 are not worked out
here and count as mismatches."""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

from ilpbench.reference.instance import EQ, GE, Instance


def reference_tables(
    inst: Instance, col_names: List[str], row_vars: np.ndarray, r_size: np.ndarray,
    m_real: int, n_cols: int,
) -> Tuple[Dict[str, np.ndarray], int]:
    """(tables, mismatches against the instance's own rows and columns).
    ``col_names``: the program's variable of each column; ``row_vars``
    [m, Kr] and ``r_size`` [m]: its slot layout; ``n_cols``: its padded
    column count."""
    index = {name: j for j, name in enumerate(inst.names)}
    by_set: Dict[frozenset, List[int]] = {}
    for i, (idx, _) in enumerate(inst.rows()):
        by_set.setdefault(frozenset(idx.tolist()), []).append(i)
    m, Kr = row_vars.shape
    factor = np.zeros((m, Kr), dtype=np.float64)
    bmin = np.zeros(m, dtype=np.int64)
    bmax = np.zeros(m, dtype=np.int64)
    is_eq = np.zeros(m, dtype=bool)
    mismatch = sum(name not in index for name in col_names)
    cols = np.array([index.get(name, -1) for name in col_names], dtype=np.int64)
    matched = set()
    rows = list(inst.rows())
    for k in range(m_real):
        vars_k = cols[row_vars[k, : r_size[k]]]
        hits = by_set.get(frozenset(vars_k.tolist()), [])
        if len(vars_k) != len(set(vars_k.tolist())) or not hits or (vars_k < 0).any():
            mismatch += 1
            continue
        i = hits[0]
        matched.update(hits)
        idx, val = rows[i]
        a = dict(zip(idx.tolist(), val.tolist()))
        factor[k, : r_size[k]] = [a[j] for j in vars_k]
        if not all(a[j] == 1 for j in vars_k) or inst.sense[i] not in (GE, EQ):
            mismatch += 1
            continue
        b = int(inst.rhs[i])
        bmin[k] = max(b, 0)
        bmax[k] = b if inst.sense[i] == EQ else len(vars_k)
        is_eq[k] = inst.sense[i] == EQ
    mismatch += inst.m - len(matched)
    c = np.zeros(n_cols, dtype=np.float64)
    known = cols >= 0
    c[: len(cols)][known] = inst.cost[cols[known]]
    real = c[: len(cols)]
    c[: len(cols)] = real / real.max()
    tables = dict(
        row_vars=row_vars, row_factor=factor, r_size=r_size, bmin=bmin, bmax=bmax,
        is_eq=is_eq, neg_count=(factor < 0).sum(axis=1), cost=c,
        unit=bool((factor[:m_real][np.arange(Kr)[None, :] < r_size[:m_real, None]] == 1).all()),
    )
    return tables, int(mismatch)


def held_against(tables: Dict[str, np.ndarray], program: Dict[str, np.ndarray], m_real: int) -> int:
    """Entries of the program's tables (real rows; every column's cost in
    float32) that differ from the reference's."""
    bad = 0
    live = np.arange(tables["row_vars"].shape[1])[None, :] < tables["r_size"][:m_real, None]
    bad += int(((tables["row_factor"][:m_real] != program["row_factor"][:m_real]) & live).sum())
    for key in ("bmin", "bmax", "is_eq", "neg_count"):
        bad += int((np.asarray(tables[key][:m_real]) != np.asarray(program[key][:m_real])).sum())
    ref_cost = torch.as_tensor(tables["cost"], dtype=torch.float32).numpy()
    bad += int((ref_cost != program["cost"]).sum())
    return bad


def on_device(tables: Dict[str, np.ndarray], dtype, device) -> Dict[str, object]:
    t = dict(tables)
    t["row_vars"] = torch.as_tensor(tables["row_vars"], dtype=torch.int64, device=device)
    t["row_factor"] = torch.as_tensor(tables["row_factor"], dtype=dtype, device=device)
    t["cost"] = torch.as_tensor(tables["cost"], dtype=torch.float32, device=device).to(dtype)
    for key in ("r_size", "bmin", "bmax", "neg_count"):
        t[key] = torch.as_tensor(np.asarray(tables[key], np.int64), device=device)
    t["is_eq"] = torch.as_tensor(tables["is_eq"], device=device)
    return t


def mismatches(a: torch.Tensor, b: torch.Tensor) -> int:
    """Entries that differ, NaN equal to NaN; every entry when the shapes
    differ."""
    if a.shape != b.shape:
        return max(a.numel(), b.numel())
    a, b = a.cpu(), b.cpu()
    if a.is_floating_point() or b.is_floating_point():
        a, b = a.double(), b.double()
        same = (a == b) | (torch.isnan(a) & torch.isnan(b))
    else:
        same = a == b
    return int((~same).sum())
