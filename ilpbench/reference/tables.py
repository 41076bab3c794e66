"""The sweep's row and cost tables, worked out from the instance in the
program's layout, and how far the program's own tables differ.

The layout is the program's: which variable each column holds (its
name), which row each row holds and which variable sits in each slot
(``row_vars``), since the kept sweep state (P, x, S) is laid out so. The
values are the instance's: each slot's factor, each row's bounds clamped
to the row's reach (the ``bmin``/``bmax`` rule of the program's layout:
an equality keeps its right-hand side; an inequality's missing side is
the sum of its negative or of its positive factors, and its given side is
clamped to that range), each column's normalised cost (the default ``loo``
norm: c / max c over the program's variables).

An instance with an integer factor |a| > 1 (a Z instance) also gets the Z
sweep's tables: rows of up to ``Z_ENUM_MAX`` variables enumerate their
feasible assignments (bit s of an assignment is slot s, in the order of
the integers 0 .. 2^L - 1); longer rows with a factor |a| > 1 take the
knapsack DP over their activity scaled by the factors' gcd, where the
scaled span fits ``DP_W_MAX``; every other row walks."""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import numpy as np
import torch

from ilpbench.reference.instance import EQ, GE, LE, Instance

Z_ENUM_MAX = 12  # rows of up to this many variables enumerate
DP_W_MAX = 4096  # the widest scaled activity span the DP takes
Z_KEYS = ("enum_row", "assign_bits", "assign_valid", "dp_row", "dp_fac", "dp_lo", "dp_blo",
          "dp_bhi")


def bucket(x: int, mult: int) -> int:
    """A size rounded up as the program's layout rounds its table sizes:
    to a multiple of ``mult`` up to 4 * mult, then to an eighth of its
    magnitude."""
    x = max(x, 1)
    gran = mult if x <= 4 * mult else max(mult, 2 ** (x.bit_length() - 4))
    return -(-x // gran) * gran


def _bounds(a: np.ndarray, senses: List[int], rhs: List[float]) -> Tuple[int, int, bool]:
    """(bmin, bmax, is_eq) of one row whose instance rows (same factors)
    have ``senses`` and ``rhs``: their intersection, clamped to the row's
    reach where it is an inequality."""
    lo, hi = int(a[a < 0].sum()), int(a[a > 0].sum())
    want_lo, want_hi = None, None
    for s, b in zip(senses, rhs):
        b = int(b)
        if s in (GE, EQ):
            want_lo = b if want_lo is None else max(want_lo, b)
        if s in (LE, EQ):
            want_hi = b if want_hi is None else min(want_hi, b)
    if want_lo is not None and want_lo == want_hi:
        return want_lo, want_hi, True
    return (max(lo, want_lo) if want_lo is not None else lo,
            min(hi, want_hi) if want_hi is not None else hi, False)


def reference_tables(
    inst: Instance, col_names: List[str], row_vars: np.ndarray, r_size: np.ndarray,
    m_real: int, n_cols: int,
) -> Tuple[Dict[str, np.ndarray], int]:
    """(tables, mismatches against the instance's own rows and columns).
    ``col_names``: the program's variable of each column; ``row_vars``
    [m, Kr] and ``r_size`` [m]: its slot layout; ``n_cols``: its padded
    column count."""
    index = {name: j for j, name in enumerate(inst.names)}
    rows = list(inst.rows())
    by_set: Dict[frozenset, List[int]] = {}
    for i, (idx, _) in enumerate(rows):
        by_set.setdefault(frozenset(idx.tolist()), []).append(i)
    m, Kr = row_vars.shape
    factor = np.zeros((m, Kr), dtype=np.float64)
    bmin = np.zeros(m, dtype=np.int64)
    bmax = np.zeros(m, dtype=np.int64)
    is_eq = np.zeros(m, dtype=bool)
    mismatch = sum(name not in index for name in col_names)
    cols = np.array([index.get(name, -1) for name in col_names], dtype=np.int64)
    matched = set()
    real = np.zeros(m, dtype=bool)
    for k in range(m_real):
        vars_k = cols[row_vars[k, : r_size[k]]]
        hits = by_set.get(frozenset(vars_k.tolist()), [])
        if len(vars_k) != len(set(vars_k.tolist())) or not hits or (vars_k < 0).any():
            mismatch += 1
            continue
        a = dict(zip(*(v.tolist() for v in rows[hits[0]])))
        same = [i for i in hits if dict(zip(*(v.tolist() for v in rows[i]))) == a]
        matched.update(same)
        factor[k, : r_size[k]] = [a[j] for j in vars_k]
        bmin[k], bmax[k], is_eq[k] = _bounds(
            factor[k, : r_size[k]], [inst.sense[i] for i in same], [inst.rhs[i] for i in same])
        real[k] = True
    mismatch += inst.m - len(matched)
    c = np.zeros(n_cols, dtype=np.float64)
    known = cols >= 0
    c[: len(cols)][known] = inst.cost[cols[known]]
    c[: len(cols)] = c[: len(cols)] / c[: len(cols)].max()
    live = np.arange(Kr)[None, :] < r_size[:, None]
    tables = dict(
        row_vars=row_vars, row_factor=factor, r_size=r_size, bmin=bmin, bmax=bmax,
        is_eq=is_eq, neg_count=(factor < 0).sum(axis=1), cost=c,
        unit=bool((factor[:m_real][live[:m_real]] == 1).all()),
        has_z=bool((np.abs(factor) > 1).any()),
    )
    if tables["has_z"]:
        tables.update(z_tables(factor, r_size, bmin, bmax, real))
    return tables, int(mismatch)


def z_tables(factor: np.ndarray, r_size: np.ndarray, bmin: np.ndarray, bmax: np.ndarray,
             real: np.ndarray) -> Dict[str, object]:
    """The Z sweep's tables of the rows ``real`` marks (the others stay
    empty): enumerated assignments, DP rows, which rows walk."""
    m, Kr = factor.shape
    enum_row = np.zeros(m, dtype=bool)
    dp_row = np.zeros(m, dtype=bool)
    dp_fac = np.zeros((m, Kr), dtype=np.int64)
    dp_lo = np.zeros(m, dtype=np.int64)
    dp_blo = np.zeros(m, dtype=np.int64)
    dp_bhi = np.zeros(m, dtype=np.int64)
    feasible: Dict[int, np.ndarray] = {}
    span_max = 0
    for k in np.flatnonzero(real):
        L = int(r_size[k])
        a = factor[k, :L].astype(np.int64)
        if L <= Z_ENUM_MAX:
            bits = (np.arange(2**L)[:, None] >> np.arange(L)[None, :]) & 1
            act = bits @ a
            feasible[k] = bits[(act >= bmin[k]) & (act <= bmax[k])]
            enum_row[k] = True
        elif (np.abs(a) > 1).any():
            g = math.gcd(*np.abs(a).tolist())
            span = (int(a[a > 0].sum()) - int(a[a < 0].sum())) // g + 1
            if span <= DP_W_MAX:
                dp_row[k] = True
                dp_fac[k, :L] = a // g
                dp_lo[k] = int(a[a < 0].sum()) // g
                dp_blo[k] = -(-int(bmin[k]) // g)
                dp_bhi[k] = int(bmax[k]) // g
                span_max = max(span_max, span)
    amax = bucket(max((len(f) for f in feasible.values()), default=1) or 1, 16)
    assign_bits = np.zeros((m, amax, Kr), dtype=np.int8)
    assign_valid = np.zeros((m, amax), dtype=bool)
    for k, f in feasible.items():
        assign_bits[k, : len(f), : f.shape[1]] = f
        assign_valid[k, : len(f)] = True
    walk = real & ~enum_row & ~dp_row
    return dict(
        enum_row=enum_row, assign_bits=assign_bits, assign_valid=assign_valid, dp_row=dp_row,
        dp_fac=dp_fac, dp_lo=dp_lo, dp_blo=dp_blo, dp_bhi=dp_bhi,
        Wdp=bucket(span_max, 8) if span_max else 0, walk=walk, z_needs_walk=bool(walk.any()),
    )


def _differ(a, b) -> int:
    """Entries of ``a`` and ``b`` that differ; every entry when their
    shapes differ."""
    a, b = np.asarray(a), np.asarray(b)
    if a.shape != b.shape:
        return max(a.size, b.size)
    return int((a != b).sum())


def held_against(tables: Dict[str, np.ndarray], program: Dict[str, np.ndarray], m_real: int) -> int:
    """Entries of the program's tables (real rows; every column's cost in
    float32; with a Z instance, the Z sweep's tables and sizes) that
    differ from the reference's."""
    bad = 0
    live = np.arange(tables["row_vars"].shape[1])[None, :] < tables["r_size"][:m_real, None]
    bad += int(((tables["row_factor"][:m_real] != program["row_factor"][:m_real]) & live).sum())
    for key in ("bmin", "bmax", "is_eq", "neg_count"):
        bad += _differ(tables[key][:m_real], program[key][:m_real])
    ref_cost = torch.as_tensor(tables["cost"], dtype=torch.float32).numpy()
    bad += _differ(ref_cost, program["cost"])
    bad += int(tables["has_z"] != bool(program["has_z"]))
    if tables["has_z"] and program["has_z"]:
        for key in Z_KEYS:
            if program.get(key) is None:  # the program has no table of this kind
                bad += int(np.asarray(tables[key][:m_real]).astype(bool).any())
            else:
                bad += _differ(tables[key][:m_real], np.asarray(program[key])[:m_real])
        for key in ("Wdp", "z_needs_walk"):
            bad += int(tables[key] != program[key])
    return bad


def on_device(tables: Dict[str, np.ndarray], dtype, device) -> Dict[str, object]:
    t = dict(tables)
    t["row_vars"] = torch.as_tensor(tables["row_vars"], dtype=torch.int64, device=device)
    t["row_factor"] = torch.as_tensor(tables["row_factor"], dtype=dtype, device=device)
    t["cost"] = torch.as_tensor(tables["cost"], dtype=torch.float32, device=device).to(dtype)
    for key in ("r_size", "bmin", "bmax", "neg_count", "dp_fac", "dp_lo", "dp_blo", "dp_bhi"):
        if key in tables:
            t[key] = torch.as_tensor(np.asarray(tables[key], np.int64), device=device)
    for key in ("is_eq", "enum_row", "assign_valid", "dp_row", "assign_bits"):
        if key in tables:
            t[key] = torch.as_tensor(tables[key], device=device)
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
