"""Padded constraint-matrix layout on the device.

The reference stores the constraint matrix twice — CSR-like rows and
CSC-like columns sharing per-element ids so the preference matrix P is
addressable from both views (reference: lib/src/sparse-matrix.hpp:86-206).

Here the element id (k, s) is the position in a padded row matrix, P lives
as a dense ``[m, Kr, R]`` tensor, and the column view holds, per variable,
the (row, slot) coordinates of every element that touches it.

``compile_problem`` is numpy until its last step, which moves every array
onto one torch device.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, List, Optional

import numpy as np
import torch

from baryonyx_torch.core.errors import InfeasibleConstraintError
from baryonyx_torch.device import DeviceLike, resolve_device
from baryonyx_torch.preprocess.merge import MergedConstraint

_INT_MIN = -(2**31)
_INT_MAX = 2**31 - 1


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclasses.dataclass(frozen=True)
class CompiledProblem:
    """Padded device tensors for one problem instance.

    Shapes: ``m`` constraints × up to ``Kr`` variables per row; ``n``
    variables × up to ``Kc`` rows per column. Padded row slots carry
    ``row_mask == False`` and variable index 0; padded column slots carry
    ``col_mask == False`` and (row, slot) = (0, 0).
    """

    # row view [m, Kr]
    row_vars: torch.Tensor  # int32: variable index per element
    row_factor: torch.Tensor  # float: a_kj
    row_mask: torch.Tensor  # bool
    # column view [n, Kc]
    col_rows: torch.Tensor  # int32: row index per element
    col_slots: torch.Tensor  # int32: row-slot per element
    col_mask: torch.Tensor  # bool
    # per-row data [m]
    bmin: torch.Tensor  # int32: clamped lower bound
    bmax: torch.Tensor  # int32: clamped upper bound
    neg_count: torch.Tensor  # int32: number of negative factors (c_size)
    r_size: torch.Tensor  # int32: row length
    is_eq: torch.Tensor  # bool: merged min == max

    # Z-problem extras (None for pure 0/1 and ±1 problems): all feasible
    # assignments of each enumerable row (reference:
    # exhaustive_solver::build_constraints, exhaustive-solver.hpp:111-167)
    assign_bits: Optional[torch.Tensor]  # int8[m, Amax, Kr]
    assign_valid: Optional[torch.Tensor]  # bool[m, Amax]
    enum_row: Optional[torch.Tensor]  # bool[m]
    # long-ℤ-row exact DP data (gcd-scaled factors and bounds)
    dp_row: Optional[torch.Tensor]  # bool[m]
    dp_lo: Optional[torch.Tensor]  # int32[m] — scaled min activity
    dp_fac: Optional[torch.Tensor]  # int32[m, Kr] — gcd-scaled factors
    dp_blo: Optional[torch.Tensor]  # int32[m] — scaled lower bound (ceil)
    dp_bhi: Optional[torch.Tensor]  # int32[m] — scaled upper bound (floor)

    # quadratic-objective extras (None for linear objectives)
    quad_var: Optional[torch.Tensor]  # int32[n, Qmax] — the other variable
    quad_fac: Optional[torch.Tensor]  # f[n, Qmax] — raw factor
    quad_mask: Optional[torch.Tensor]  # bool[n, Qmax]

    # dense factor matrix [m, n] for matmul activities (None when large)
    dense_A: Optional[torch.Tensor]

    # static metadata (m, n, Kr, Kc are BUCKETED sizes; *_real are the
    # instance's true counts)
    m: int
    n: int
    Kr: int
    Kc: int
    has_z: bool
    Amax: int = 0
    Wdp: int = 0
    m_real: int = 0
    n_real: int = 0
    has_quad: bool = False
    Qmax: int = 0
    # reduction-based selection coverage: the k-of-n selection reads only
    # ranks {selected, selected+1}; when those lie within J_bot of the
    # bottom or J_top of the top of the sorted order for every row, the
    # sweep needs no sort (see ops/psweep.py)
    J_bot: int = 0
    J_top: int = 0
    sel_reduction_ok: bool = False
    # every factor is exactly +1 (the pure 0/1-coefficient class)
    all_unit_pos: bool = False
    # Z problems: does any real row fall to the greedy prefix walk?
    z_needs_walk: bool = True

    def tensor_fields(self) -> List[str]:
        return [
            f.name for f in dataclasses.fields(self)
            if isinstance(getattr(self, f.name), torch.Tensor)
        ]

    @property
    def device(self) -> torch.device:
        return self.row_vars.device

    def to(self, device: DeviceLike) -> "CompiledProblem":
        dev = torch.device(device)
        return dataclasses.replace(
            self, **{k: getattr(self, k).to(dev) for k in self.tensor_fields()}
        )


Z_ENUM_MAX = 12  # rows up to this length get exact enumeration
DP_W_MAX = 4096  # max activity span a long-ℤ row may have for the DP


def _bucket(x: int, mult: int, minimum: int = 0) -> int:
    """Round up to a bucket boundary so instances of similar size share
    shapes: multiples of `mult` below 4*mult, then 1/8-of-magnitude
    granularity (<= 12.5% padding waste)."""
    x = max(x, minimum, 1)
    if x <= 4 * mult:
        return _round_up(x, mult)
    gran = max(mult, 2 ** (x.bit_length() - 4))
    return _round_up(x, gran)


def compile_problem(
    constraints: List[MergedConstraint],
    n_variables: int,
    dtype: Any = torch.float32,
    qelements=None,
    min_m: int = 0,
    min_kr: int = 0,
    min_kc: int = 0,
    device: DeviceLike = None,
) -> CompiledProblem:
    """Build the padded row/column views from merged constraints.

    Bound clamping mirrors the solver constructors: for a row with
    ``min != max``, the feasible activity interval is intersected with
    [sum of negative factors, sum of positive factors]
    (reference: itm-solver-inequalities-101.cpp:117-125,
    itm-solver-inequalities-01.cpp:97-106).

    All dimensions round up to shared bucket sizes (padded rows have
    bounds [0,0] and are never violated or scheduled; padded variables
    have zero cost and appear in no row).
    """
    dev = resolve_device(device)
    m_real = len(constraints)
    n_real = n_variables
    if m_real == 0:
        raise ValueError("cannot compile a problem with no constraints")

    m = max(_bucket(m_real, 64), min_m)
    n = _bucket(n_real, 128)
    Kr = max(_bucket(max(len(c.elements) for c in constraints), 8), min_kr)
    col_count = np.zeros(n, dtype=np.int64)
    for c in constraints:
        for el in c.elements:
            col_count[el.variable_index] += 1
    Kc = max(_bucket(int(col_count.max()) if n_real else 1, 8), min_kc)

    row_vars = np.zeros((m, Kr), dtype=np.int32)
    row_factor = np.zeros((m, Kr), dtype=np.float64)
    row_mask = np.zeros((m, Kr), dtype=bool)
    col_rows = np.zeros((n, Kc), dtype=np.int32)
    col_slots = np.zeros((n, Kc), dtype=np.int32)
    col_mask = np.zeros((n, Kc), dtype=bool)
    bmin = np.zeros(m, dtype=np.int32)
    bmax = np.zeros(m, dtype=np.int32)
    neg_count = np.zeros(m, dtype=np.int32)
    r_size = np.zeros(m, dtype=np.int32)
    is_eq = np.zeros(m, dtype=bool)

    col_fill = np.zeros(n, dtype=np.int64)
    has_z = False
    all_unit_pos = True

    for k, cst in enumerate(constraints):
        nneg = 0
        possum = negsum = 0
        for s, el in enumerate(cst.elements):
            row_vars[k, s] = el.variable_index
            row_factor[k, s] = el.factor
            row_mask[k, s] = True
            if abs(el.factor) > 1:
                has_z = True
            if el.factor != 1:
                all_unit_pos = False
            if el.factor > 0:
                possum += el.factor
            elif el.factor < 0:
                nneg += 1
                negsum += el.factor
            j = el.variable_index
            col_rows[j, col_fill[j]] = k
            col_slots[j, col_fill[j]] = s
            col_mask[j, col_fill[j]] = True
            col_fill[j] += 1

        r_size[k] = len(cst.elements)
        neg_count[k] = nneg
        if cst.min == cst.max:
            is_eq[k] = True
            bmin[k] = bmax[k] = cst.min
        else:
            lo = negsum  # sum of negative factors = minimum activity
            hi = possum  # sum of positive factors = maximum activity
            bmin[k] = max(lo, cst.min) if cst.min != _INT_MIN else lo
            bmax[k] = min(hi, cst.max) if cst.max != _INT_MAX else hi
            if bmin[k] > bmax[k]:
                raise ValueError(f"constraint {cst.id}: empty bound interval")

    def tens(a, dt=None):
        return torch.as_tensor(a, dtype=dt).to(dev)

    assign_bits = assign_valid = enum_row = None
    dp_row = dp_lo = dp_fac = dp_blo = dp_bhi = None
    Amax = 0
    Wdp = 0
    z_needs_walk = True
    if has_z:
        # exact per-row subsolvers: enumerate all feasible assignments of
        # rows up to Z_ENUM_MAX variables; longer rows with ℤ factors get
        # the gcd-scaled DP over factor sums when the span fits, the
        # greedy walk otherwise
        enum_row_np = np.zeros(m, dtype=bool)
        dp_row_np = np.zeros(m, dtype=bool)
        dp_lo_np = np.zeros(m, dtype=np.int32)
        dp_fac_np = np.zeros((m, Kr), dtype=np.int32)
        dp_blo_np = np.zeros(m, dtype=np.int32)
        dp_bhi_np = np.zeros(m, dtype=np.int32)

        per_row: List[np.ndarray] = []
        for k, cst in enumerate(constraints):
            L = len(cst.elements)
            row_has_z = any(abs(el.factor) > 1 for el in cst.elements)
            if L > Z_ENUM_MAX:
                if row_has_z:
                    g = 0
                    for el in cst.elements:
                        g = math.gcd(g, abs(el.factor))
                    g = max(g, 1)
                    negsum = sum(el.factor for el in cst.elements if el.factor < 0)
                    possum = sum(el.factor for el in cst.elements if el.factor > 0)
                    span = (int(possum) - int(negsum)) // g + 1
                    blo = -(-int(bmin[k]) // g)  # ceil
                    bhi = int(bmax[k]) // g  # floor
                    if blo > bhi:
                        raise InfeasibleConstraintError(
                            str(cst.id),
                            f"no feasible activity (multiples of {g} in "
                            f"[{bmin[k]}, {bmax[k]}])",
                        )
                    if span <= DP_W_MAX:
                        dp_row_np[k] = True
                        dp_lo_np[k] = int(negsum) // g
                        dp_blo_np[k] = blo
                        dp_bhi_np[k] = bhi
                        for s, el in enumerate(cst.elements):
                            dp_fac_np[k, s] = el.factor // g
                        Wdp = max(Wdp, span)
                per_row.append(np.zeros((0, Kr), dtype=np.int8))
                continue
            factors = np.array([el.factor for el in cst.elements])
            bits = (
                (np.arange(2**L)[:, None] >> np.arange(L)[None, :]) & 1
            ).astype(np.int8)
            act = bits @ factors
            feas = bits[(act >= bmin[k]) & (act <= bmax[k])]
            if feas.shape[0] == 0:
                raise InfeasibleConstraintError(
                    str(cst.id), "no feasible assignment"
                )
            padded = np.zeros((feas.shape[0], Kr), dtype=np.int8)
            padded[:, :L] = feas
            per_row.append(padded)
            enum_row_np[k] = True
        Amax = _bucket(max((a.shape[0] for a in per_row), default=1) or 1, 16)
        ab = np.zeros((m, Amax, Kr), dtype=np.int8)
        av = np.zeros((m, Amax), dtype=bool)
        for k, a in enumerate(per_row):
            ab[k, : a.shape[0]] = a
            av[k, : a.shape[0]] = True
        assign_bits = tens(ab)
        assign_valid = tens(av)
        enum_row = tens(enum_row_np)
        z_needs_walk = any(
            not enum_row_np[k] and not dp_row_np[k]
            for k in range(len(constraints))
        )
        if Wdp:
            Wdp = _bucket(Wdp, 8)
            dp_row = tens(dp_row_np)
            dp_lo = tens(dp_lo_np)
            dp_fac = tens(dp_fac_np)
            dp_blo = tens(dp_blo_np)
            dp_bhi = tens(dp_bhi_np)

    # dense A for matmul activities — worth it while m*n stays modest
    dense_A = None
    if m * n <= 1 << 25:  # <= 128 MB f32
        dA = np.zeros((m, n), dtype=np.float64)
        for k, cst in enumerate(constraints):
            for el in cst.elements:
                dA[k, el.variable_index] = el.factor
        dense_A = tens(dA, dtype)

    # Static rank-coverage analysis for sort-free selection: collect every
    # (rank, row_size) selection-key read the sweep can make, then choose
    # one (J_bot, J_top) register split covering all of them. Rank r reads
    # bots[r] when r < J_bot, else tops[rs-1-r].
    rank_reads: List[tuple] = []  # (rank, row_size)
    for k in range(m_real):
        rs = int(r_size[k])
        cs = int(neg_count[k])
        if is_eq[k]:
            ke = min(int(bmin[k]) + cs, rs) - 1
            if ke >= 0:
                rank_reads.append((ke, rs))
                if ke + 1 < rs:  # ke+1 == rs is case_all: only ke read
                    rank_reads.append((ke + 1, rs))
        else:
            lo = int(bmin[k]) + cs
            hi = min(int(bmax[k]) + cs, rs)
            if lo >= 1:
                rank_reads.append((lo - 1, rs))
                if lo < rs:
                    rank_reads.append((lo, rs))
            if hi >= 1:
                rank_reads.append((hi - 1, rs))
                if hi < rs:
                    rank_reads.append((hi, rs))
    # minimal (J_bot >= 2, J_top >= 1) split with J_bot + J_top <= 8:
    # rank r of an rs-slot row is covered iff r < J_bot or J_top >= rs-r
    bot_need, top_need, best_total = 2, 1, None
    for jb in range(2, 9):
        jt = 1
        for r, rs in rank_reads:
            if r >= jb:
                jt = max(jt, rs - r)
        if jb + jt <= 8 and (best_total is None or jb + jt < best_total):
            bot_need, top_need, best_total = jb, jt, jb + jt
    sel_reduction_ok = best_total is not None

    quad_var = quad_fac = quad_mask = None
    has_quad = bool(qelements)
    Qmax = 0
    if has_quad:
        # per-variable quadratic neighbor lists: c(j, x) adds f_q * x[other]
        # for every term touching j; squares use other == j
        # (reference: quadratic_cost_type, itm-common.hpp:1392-1421)
        neigh: List[List[tuple]] = [[] for _ in range(n)]
        for q in qelements:
            a_i, b_i, f = q.variable_index_a, q.variable_index_b, q.factor
            if a_i == b_i:
                neigh[a_i].append((a_i, f))
            else:
                neigh[a_i].append((b_i, f))
                neigh[b_i].append((a_i, f))
        Qmax = _bucket(max((len(v) for v in neigh), default=1) or 1, 4)
        qv = np.zeros((n, Qmax), dtype=np.int32)
        qf = np.zeros((n, Qmax), dtype=np.float64)
        qm = np.zeros((n, Qmax), dtype=bool)
        for j, terms in enumerate(neigh):
            for t, (other, f) in enumerate(terms):
                qv[j, t] = other
                qf[j, t] = f
                qm[j, t] = True
        quad_var = tens(qv)
        quad_fac = tens(qf, dtype)
        quad_mask = tens(qm)

    return CompiledProblem(
        row_vars=tens(row_vars),
        row_factor=tens(row_factor, dtype),
        row_mask=tens(row_mask),
        col_rows=tens(col_rows),
        col_slots=tens(col_slots),
        col_mask=tens(col_mask),
        bmin=tens(bmin),
        bmax=tens(bmax),
        neg_count=tens(neg_count),
        r_size=tens(r_size),
        is_eq=tens(is_eq),
        assign_bits=assign_bits,
        assign_valid=assign_valid,
        enum_row=enum_row,
        dp_row=dp_row,
        dp_lo=dp_lo,
        dp_fac=dp_fac,
        dp_blo=dp_blo,
        dp_bhi=dp_bhi,
        Wdp=Wdp,
        quad_var=quad_var,
        quad_fac=quad_fac,
        quad_mask=quad_mask,
        dense_A=dense_A,
        m=m,
        n=n,
        Kr=Kr,
        Kc=Kc,
        has_z=has_z,
        Amax=Amax,
        m_real=m_real,
        n_real=n_real,
        has_quad=has_quad,
        Qmax=Qmax,
        J_bot=bot_need,
        J_top=top_need,
        sel_reduction_ok=sel_reduction_ok,
        all_unit_pos=all_unit_pos,
        z_needs_walk=z_needs_walk,
    )
