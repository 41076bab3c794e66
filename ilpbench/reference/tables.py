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
the integers 0 .. 2^L - 1). A longer row with a factor |a| > 1 gets its
factors and bounds scaled by the factors' gcd and its reachable window:
with N and Pz the sums of its scaled negative and positive factors and
[blo, bhi] its scaled bounds, the activities [max(N, blo - Pz), min(Pz,
bhi - N)]. A prefix of a chosen set whose activity ends in [blo, bhi] lies
in that window (the rest of the set adds between N and Pz), so a knapsack
DP over any table that covers the window chooses what it chooses over the
whole span, bit for bit. The DP may take such a row where its window fits
``DP_W_MAX``, and must take it where its whole span does (``"span"``, the
program's first rule) or, where the configuration's ``"dp_required"`` is
``"window"``, where its window does. Which rows the program sends to the DP is its own choice
within those rules (``held_against``); the reference replays the choice
(``follow_routes``), and every other long row walks."""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import numpy as np
import torch

from ilpbench.reference.instance import EQ, GE, LE, Instance

Z_ENUM_MAX = 12  # rows of up to this many variables enumerate
DP_W_MAX = 4096  # the widest scaled activity span the DP takes
# the program's Z tables, which the sweep probe keeps
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
    m_real: int, n_cols: int, dp_rule: str = "span",
) -> Tuple[Dict[str, np.ndarray], int]:
    """(tables, mismatches against the instance's own rows and columns).
    ``col_names``: the program's variable of each column; ``row_vars``
    [m, Kr] and ``r_size`` [m]: its slot layout; ``n_cols``: its padded
    column count; ``dp_rule``: the configuration's ``"dp_required"``, the
    rule for the rows the DP must take (``z_tables``)."""
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
        tables.update(z_tables(factor, r_size, bmin, bmax, real, dp_rule))
    return tables, int(mismatch)


def z_tables(factor: np.ndarray, r_size: np.ndarray, bmin: np.ndarray, bmax: np.ndarray,
             real: np.ndarray, dp_rule: str = "span") -> Dict[str, object]:
    """The Z sweep's tables of the rows ``real`` marks (the others stay
    empty): enumerated assignments; the long rows (``long_row``); for each
    long row with a factor |a| > 1 its gcd-scaled factors and bounds, its
    window's first activity and width (``win_lo``, ``win_w``), whether the
    DP may take it (``dp_able``) and whether it must (``dp_required``: by
    the ``dp_rule`` ``"span"``, where its whole span fits ``DP_W_MAX``; by
    ``"window"``, wherever it may)."""
    if dp_rule not in ("span", "window"):
        raise ValueError(f"dp_required is 'span' or 'window', not {dp_rule!r}")
    m, Kr = factor.shape
    enum_row = np.zeros(m, dtype=bool)
    dp_able = np.zeros(m, dtype=bool)
    dp_required = np.zeros(m, dtype=bool)
    dp_fac = np.zeros((m, Kr), dtype=np.int64)
    dp_blo, dp_bhi, win_lo, win_w = (np.zeros(m, dtype=np.int64) for _ in range(4))
    feasible: Dict[int, np.ndarray] = {}
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
            dp_fac[k, :L] = a // g
            neg, pos = int(dp_fac[k][dp_fac[k] < 0].sum()), int(dp_fac[k][dp_fac[k] > 0].sum())
            dp_blo[k] = -(-int(bmin[k]) // g)
            dp_bhi[k] = int(bmax[k]) // g
            win_lo[k] = max(neg, dp_blo[k] - pos)
            win_w[k] = max(0, min(pos, dp_bhi[k] - neg) - win_lo[k] + 1)
            dp_able[k] = 1 <= win_w[k] <= DP_W_MAX
            dp_required[k] = (dp_able[k] if dp_rule == "window"
                              else pos - neg + 1 <= DP_W_MAX)
    amax = bucket(max((len(f) for f in feasible.values()), default=1) or 1, 16)
    assign_bits = np.zeros((m, amax, Kr), dtype=np.int8)
    assign_valid = np.zeros((m, amax), dtype=bool)
    for k, f in feasible.items():
        assign_bits[k, : len(f), : f.shape[1]] = f
        assign_valid[k, : len(f)] = True
    return dict(
        enum_row=enum_row, assign_bits=assign_bits, assign_valid=assign_valid,
        long_row=real & ~enum_row, dp_fac=dp_fac, dp_blo=dp_blo, dp_bhi=dp_bhi, win_lo=win_lo,
        win_w=win_w, dp_able=dp_able, dp_required=dp_required,
    )


def _program_dp_rows(program: Dict[str, object], m: int) -> np.ndarray:
    """The rows the program sends to the DP (none where it has no DP
    table)."""
    if program.get("dp_row") is None or not int(program.get("Wdp", 0)):
        return np.zeros(m, dtype=bool)
    return np.asarray(program["dp_row"]).astype(bool)[:m]


def follow_routes(tables: Dict[str, object], program: Dict[str, object]) -> Dict[str, object]:
    """The Z tables with the program's routes, which the reference
    sweep replays: the program's DP rows among the rows that have a window
    (``dp_row``), every other long row walking (``walk``), and the
    program's ``z_needs_walk`` (whether the sweep draws the walk's noise).
    ``held_against`` holds the routes to their rules."""
    if not tables["has_z"]:
        return tables
    t = dict(tables)
    t["dp_row"] = _program_dp_rows(program, len(t["win_w"])) & (t["win_w"] > 0)
    t["walk"] = t["long_row"] & ~t["dp_row"]
    t["z_needs_walk"] = bool(program["z_needs_walk"])
    return t


def _differ(a, b) -> int:
    """Entries of ``a`` and ``b`` that differ; every entry when their
    shapes differ."""
    a, b = np.asarray(a), np.asarray(b)
    if a.shape != b.shape:
        return max(a.size, b.size)
    return int((a != b).sum())


def held_against(tables: Dict[str, np.ndarray], program: Dict[str, np.ndarray], m_real: int) -> int:
    """Entries of the program's tables (real rows; every column's cost in
    float32; with a Z instance, the Z sweep's tables) that differ from the
    reference's, and, with a Z instance, each breach of the routes' rules:
    a row the DP must take that the program walks, or one it may not take
    that the program sends to it; a DP row whose table (``dp_lo`` and the
    next ``Wdp`` activities) leaves out part of its window; a
    ``z_needs_walk`` that is not "some row walks"."""
    bad = 0
    live = np.arange(tables["row_vars"].shape[1])[None, :] < tables["r_size"][:m_real, None]
    bad += int(((tables["row_factor"][:m_real] != program["row_factor"][:m_real]) & live).sum())
    for key in ("bmin", "bmax", "is_eq", "neg_count"):
        bad += _differ(tables[key][:m_real], program[key][:m_real])
    ref_cost = torch.as_tensor(tables["cost"], dtype=torch.float32).numpy()
    bad += _differ(ref_cost, program["cost"])
    bad += int(tables["has_z"] != bool(program["has_z"]))
    if not (tables["has_z"] and program["has_z"]):
        return bad
    for key in ("enum_row", "assign_bits", "assign_valid"):
        if program.get(key) is None:  # the program has no table of this kind
            bad += int(np.asarray(tables[key][:m_real]).astype(bool).any())
        else:
            bad += _differ(tables[key][:m_real], np.asarray(program[key])[:m_real])
    dp = _program_dp_rows(program, m_real)
    for key in ("dp_fac", "dp_blo", "dp_bhi"):  # exact on the program's DP rows, 0 elsewhere
        want = tables[key][:m_real] * (dp[:, None] if tables[key].ndim == 2 else dp)
        got = program.get(key)
        bad += _differ(want, np.zeros_like(want) if got is None else np.asarray(got)[:m_real])
    bad += int((tables["dp_required"][:m_real] & ~dp).sum())
    bad += int((dp & ~tables["dp_able"][:m_real]).sum())
    if dp.any():
        lo = np.asarray(program["dp_lo"])[:m_real].astype(np.int64)
        first, width = tables["win_lo"][:m_real], tables["win_w"][:m_real]
        bad += int((dp & ((lo > first) | (lo + int(program["Wdp"]) < first + width))).sum())
    walks = bool((tables["long_row"][:m_real] & ~dp).any())
    return bad + int(walks != bool(program["z_needs_walk"]))


def on_device(tables: Dict[str, np.ndarray], dtype, device) -> Dict[str, object]:
    t = dict(tables)
    t["row_vars"] = torch.as_tensor(tables["row_vars"], dtype=torch.int64, device=device)
    t["row_factor"] = torch.as_tensor(tables["row_factor"], dtype=dtype, device=device)
    t["cost"] = torch.as_tensor(tables["cost"], dtype=torch.float32, device=device).to(dtype)
    for key in ("r_size", "bmin", "bmax", "neg_count", "dp_fac", "dp_blo", "dp_bhi", "win_lo",
                "win_w"):
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
