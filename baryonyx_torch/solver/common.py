"""Shared solver machinery: cost vectors, normalization, delta, init
policies, the dual bound and the constraint-ordering schedules.

reference: lib/src/itm-common.hpp — default_cost_type (:1000-1148),
normalize_costs (:967-998), compute_delta (:917-933), init policies
(:255-374), compute_order (:627-915).

Everything but ``make_order`` is host-side numpy.
"""

from __future__ import annotations

import time
from typing import List, Optional, Tuple

import numpy as np
import torch

from baryonyx_torch.core.model import Problem
from baryonyx_torch.core.params import (
    ConstraintOrder,
    CostNormType,
    InitPolicyType,
    SolverParameters,
)
from baryonyx_torch.core.result import Result
from baryonyx_torch.ops.layout import CompiledProblem
from baryonyx_torch.ops.sweep import activities
from baryonyx_torch.preprocess.merge import MergedConstraint


def build_cost_vector(pb: Problem, n: int) -> np.ndarray:
    """Dense linear cost accumulation (reference: itm-common.hpp:1006-1016).
    Always float64 on host; cast to the solver dtype after normalization
    (SURVEY.md section 7 hard part (e))."""
    c = np.zeros(n, dtype=np.float64)
    for el in pb.objective.elements:
        c[el.variable_index] += el.factor
    return c


def normalize_costs(
    c: np.ndarray, norm: CostNormType, rng: np.random.Generator
) -> np.ndarray:
    """reference: itm-common.hpp:967-998 + the norm members :1025-1125.

    Quirks preserved: l2 divides by the sum of squares (no sqrt,
    :1105-1115); loo divides by the signed maximum element (:1117-1125);
    the divide is skipped when the divisor is 0/inf/nan/subnormal."""
    c = c.copy()

    def _div(v, d):
        return v / d if np.isfinite(d) and d != 0 and abs(d) >= 2.3e-308 else v

    if norm == CostNormType.none:
        return c
    if norm == CostNormType.l1:
        return _div(c, np.sum(np.abs(c)))
    if norm == CostNormType.l2:
        return _div(c, np.sum(c * c))
    if norm == CostNormType.loo:
        return _div(c, np.max(c)) if c.size else c
    # random: make all values distinct by spreading equal runs over a random
    # epsilon interval, then loo-normalize (reference: :1025-1082)
    order = np.argsort(c, kind="stable")
    sorted_c = c[order]
    out = sorted_c.copy()
    i = 0
    nvals = len(sorted_c)
    while i < nvals:
        j = i
        while j < nvals and sorted_c[j] == sorted_c[i]:
            j += 1
        if j - i > 1:
            lo = sorted_c[i]
            hi = sorted_c[j] if j < nvals else lo + 1.0
            out[i:j] = rng.uniform(lo, hi, size=j - i)
        i = j
    c[order] = out
    return _div(c, np.max(c)) if c.size else c


def normalize_costs_quad(
    c: np.ndarray,
    qfac: np.ndarray,
    norm: CostNormType,
    rng: np.random.Generator,
) -> Tuple[np.ndarray, np.ndarray]:
    """Normalize linear + quadratic factors by a shared divisor
    (reference: quadratic_cost_type::make_*_norm — e.g. loo takes the max
    over both element sets and divides both, itm-common.hpp:1384-1400)."""

    def _apply(div):
        if np.isfinite(div) and div != 0:
            return c / div, qfac / div
        return c.copy(), qfac.copy()

    flat = qfac[qfac != 0]
    if norm == CostNormType.none:
        return c.copy(), qfac.copy()
    if norm == CostNormType.l1:
        return _apply(np.sum(np.abs(c)) + np.sum(np.abs(flat)))
    if norm == CostNormType.l2:
        return _apply(np.sum(c * c) + np.sum(flat * flat))
    # random + loo both end in a loo-style divide
    div = max(np.max(c) if c.size else 0.0, np.max(flat) if flat.size else 0.0)
    return _apply(div)


def min_abs_nonzero(c: np.ndarray) -> float:
    """reference: default_cost_type::min (itm-common.hpp:1084-1094)."""
    nz = np.abs(c[c != 0])
    return float(nz.min()) if nz.size else float(np.finfo(np.float64).max)


def compute_delta(c_norm: np.ndarray, theta: float) -> float:
    """delta auto = min|c| - theta * min|c| (reference: itm-common.hpp:917-933)."""
    mini = min_abs_nonzero(c_norm)
    return mini - theta * mini


def objective_value(pb: Problem, x: np.ndarray) -> float:
    """True objective from the original costs
    (reference: default_cost_type::results, itm-common.hpp:1137-1145)."""
    v = pb.objective.value
    for el in pb.objective.elements:
        v += el.factor * int(x[el.variable_index])
    for q in pb.objective.qelements:
        v += q.factor * int(x[q.variable_index_a]) * int(x[q.variable_index_b])
    return float(v)


# ---------------------------------------------------------------------------
# init policies (host-side, per solve; reference: itm-common.hpp:255-374)
# ---------------------------------------------------------------------------


def init_bastert(c: np.ndarray, minimize: bool, value_if_0: int = 0) -> np.ndarray:
    """x_i = [c_i < 0] for minimize, [c_i > 0] for maximize, value_if_0 at 0
    (reference: init_with_bastert + init_x, itm-common.hpp:202-267)."""
    if minimize:
        x = np.where(c < 0, 1, np.where(c == 0, value_if_0, 0))
    else:
        x = np.where(c > 0, 1, np.where(c == 0, value_if_0, 0))
    return x.astype(np.int32)


def init_random(n: int, p: float, rng: np.random.Generator) -> np.ndarray:
    """reference: init_with_random, itm-common.hpp:269-282."""
    return (rng.random(n) < p).astype(np.int32)


def init_pre_solve(
    c: np.ndarray,
    constraints: List[MergedConstraint],
    minimize: bool,
    rng: np.random.Generator,
    init_random_prob: float,
    optimistic: bool,
    x_out: Optional[np.ndarray] = None,
) -> np.ndarray:
    """Per-constraint greedy fill (reference: init_with_pre_solve,
    itm-common.hpp:284-374): for each constraint (chosen with probability
    ``init_random_prob``), sort its variables by original cost and set the
    smallest (pessimistic) or largest (optimistic) prefix whose factor sum
    satisfies the [min, max] bounds."""
    n = len(c)
    x = np.zeros(n, np.int32) if x_out is None else x_out
    for cst in constraints:
        if rng.random() >= init_random_prob:
            continue
        items = [(float(c[el.variable_index]), el.factor, el.variable_index) for el in cst.elements]
        rng.shuffle(items)
        items.sort(key=lambda t: t[0], reverse=not minimize)
        r_size = len(items)
        if not optimistic:
            best = -2
            ssum = 0
            for i in range(-1, r_size):
                if cst.min <= ssum <= cst.max:
                    best = i
                    break
                if i + 1 < r_size:
                    ssum += items[i + 1][1]
        else:
            best = -2
            ssum = 0
            for i in range(-1, r_size):
                if cst.min <= ssum <= cst.max:
                    best = i
                if best != -2 and i + 1 < r_size:
                    nxt = items[i + 1][0]
                    if (nxt > 0) if minimize else (nxt < 0):
                        break
                if i + 1 < r_size:
                    ssum += items[i + 1][1]
        for i in range(r_size):
            x[items[i][2]] = 1 if i <= best else 0
    return x


def initial_x(
    params: SolverParameters,
    c_orig: np.ndarray,
    constraints: List[MergedConstraint],
    minimize: bool,
    rng: np.random.Generator,
) -> np.ndarray:
    """Solve-mode initialization: policy then Bernoulli(init_policy_random)
    bit inversion (reference: itm-solver-common.hpp:99-123)."""
    if params.init_policy == InitPolicyType.bastert:
        x = init_bastert(c_orig, minimize)
    elif params.init_policy == InitPolicyType.pessimistic_solve:
        x = init_pre_solve(c_orig, constraints, minimize, rng, 1.0, optimistic=False)
    else:
        x = init_pre_solve(c_orig, constraints, minimize, rng, 1.0, optimistic=True)
    flip = rng.random(len(x)) < params.init_policy_random
    return np.where(flip, 1 - x, x).astype(np.int32)


def dual_bound(
    cp, pi: np.ndarray, c_norm: np.ndarray, minimize: bool
) -> float:
    """Lagrangian dual bound: lb = sum_k pi_k b_k + sum_j min(0, c_j -
    sum_k a_kj pi_k), using the row lower bounds for minimize (upper for
    maximize) — reference: bounds_printer, itm-common.hpp:501-625."""
    rv = cp.row_vars.cpu().numpy()
    rf = cp.row_factor.cpu().numpy()
    rm = cp.row_mask.cpu().numpy()
    b = (cp.bmin if minimize else cp.bmax).cpu().numpy().astype(np.float64)
    n = cp.n
    # one O(nnz) bincount instead of a per-row Python loop — this runs on
    # the 1 Hz progress path, where an O(m) loop stalls 7-20k-row
    # instances (VERDICT r3)
    mr = cp.m_real
    mask = rm[:mr]
    idx = rv[:mr][mask]
    w = (rf[:mr] * np.asarray(pi[:mr], dtype=np.float64)[:, None])[mask]
    sum_a_pi = np.bincount(idx, weights=w, minlength=n)[:n]
    resid = c_norm[: len(sum_a_pi)] - sum_a_pi
    lb = float(np.dot(pi[: cp.m_real], b[: cp.m_real]))
    if minimize:
        lb += float(np.minimum(0.0, resid).sum())
    else:
        lb += float(np.maximum(0.0, resid).sum())
    return lb


# ---------------------------------------------------------------------------
# constraint-ordering schedules (reference: compute_order,
# itm-common.hpp:627-915) — on the device, one permutation per sweep
# ---------------------------------------------------------------------------

# pi_sign_change: the reference's policy is a random shuffle over ALL rows
# whose pi-sign tracking never affects behavior (itm-common.hpp:864-870);
# a random permutation plus process-all-rows scheduling is exact.

# numeric codes carried in device state for the `cycle` policy
ORDER_CODES = {
    ConstraintOrder.none: 0,
    ConstraintOrder.reversing: 1,
    ConstraintOrder.random_sorting: 2,
    ConstraintOrder.infeasibility_decr: 3,
    ConstraintOrder.infeasibility_incr: 4,
    ConstraintOrder.lagrangian_decr: 5,
    ConstraintOrder.lagrangian_incr: 6,
    ConstraintOrder.pi_sign_change: 7,
}
N_CYCLE_STATES = 8


def make_order(
    cp: CompiledProblem,
    order_code: torch.Tensor,
    x: torch.Tensor,
    pi: torch.Tensor,
    gen: torch.Generator,
    m_pad: int,
    static_policy: "Optional[ConstraintOrder]" = None,
) -> torch.Tensor:
    """Row-processing permutation for one sweep, int32[m_pad], padded with
    the sentinel ``m``. The schedule is shared across the replica axis;
    the state-dependent policies (infeasibility/lagrangian sorts)
    aggregate their keys over replicas.

    ``static_policy``: when the policy is known and is not ``cycle``, only
    that policy's inputs are computed and ``order_code`` is not read (it
    may be None). Otherwise every policy's order is built and
    ``order_code`` (a device int tensor) picks one, with no host sync."""
    m = cp.m
    dev = cp.device
    iota = torch.arange(m, dtype=torch.int32, device=dev)

    def by_key(k, descending=False):
        k = -k if descending else k
        return torch.argsort(k, stable=True).to(torch.int32)

    def excess_key():
        act = activities(cp, x)  # [m] or [m, R]
        bmin = cp.bmin.to(act.dtype)
        bmax = cp.bmax.to(act.dtype)
        if act.ndim == 2:
            bmin, bmax = bmin[:, None], bmax[:, None]
        excess = torch.maximum(bmin - act, act - bmax)
        if excess.ndim == 2:
            excess = excess.mean(dim=1)
        return excess

    def pi_key():
        return pi.mean(dim=1) if pi.ndim == 2 else pi

    def shuffled():
        return torch.randperm(m, generator=gen, device=dev).to(torch.int32)

    if static_policy is not None and static_policy != ConstraintOrder.cycle:
        order = {
            ConstraintOrder.none: lambda: iota,
            ConstraintOrder.reversing: lambda: iota.flip(0),
            ConstraintOrder.random_sorting: shuffled,
            ConstraintOrder.infeasibility_decr: lambda: by_key(
                excess_key(), descending=True
            ),
            ConstraintOrder.infeasibility_incr: lambda: by_key(excess_key()),
            ConstraintOrder.lagrangian_decr: lambda: by_key(
                pi_key(), descending=True
            ),
            ConstraintOrder.lagrangian_incr: lambda: by_key(pi_key()),
            ConstraintOrder.pi_sign_change: shuffled,
        }[static_policy]()
    else:
        excess = excess_key()
        pim = pi_key()
        shuf = shuffled()
        branches = torch.stack(
            [
                iota,  # none
                iota.flip(0),  # reversing
                shuf,  # random_sorting
                by_key(excess, descending=True),  # infeasibility_decr
                by_key(excess),  # infeasibility_incr
                by_key(pim, descending=True),  # lagrangian_decr
                by_key(pim),  # lagrangian_incr
                shuf,  # pi_sign_change (processes all rows)
            ]
        )
        # index_select: indexing by a 0-dim tensor would read it on the host
        order = branches.index_select(0, order_code.long().reshape(1))[0]
    pad = torch.full((m_pad - m,), m, dtype=torch.int32, device=dev)
    return torch.cat([order, pad])


def finalize(ret: Result, pb: Problem, n_constraints: int, t0: float) -> None:
    """Fill the result's bookkeeping fields (the JAX package's
    solver/solve.py:_finalize)."""
    if len(pb.derived_vars) and "product-fold" not in ret.method:
        ret.method += "+product-fold"
    ret.variable_name = list(pb.vars.names)
    ret.affected_vars = pb.affected_vars
    ret.derived_vars = pb.derived_vars
    ret.variables = len(pb.vars.values)
    ret.constraints = n_constraints
    ret.duration = time.monotonic() - t0
