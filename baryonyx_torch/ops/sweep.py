"""Row activities, violation masks and merged column sums.

All solver state carries a trailing replica axis R (the multi-start axis
that replaces the reference's thread pool): ``x[n, R]``, ``P[m, Kr, R]``,
``pi[m, R]``. Row and column indices are shared across replicas.

The reference's column walks (sum of a*pi and a*P over every row touching
a variable — reference: itm-solver-equalities-101.cpp:161-195) become one
merged column-sum tensor ``S[n, R]``, recomputed exactly by
``column_sums`` and updated incrementally inside the sweeps.

``sweep`` is the general sweep in plain PyTorch ops: every 0/1 and ±1
instance, float32 or float64, any replica count, with the full sort where
the sort-free selection does not cover a row, the random solver and the
quadratic cost terms. The fused kernel (ops/psweep.py) covers a subset of
it faster; the callers choose between the two.

Per-row update (reference: itm-common.hpp:382-467 ``affect``), for rows in
blocks of ``block_size`` (Jacobi inside a block, sequential across blocks;
``block_size=1`` is the reference's sequencing):
1. decay preferences  P[k, :] *= theta
2. reduced costs      r_s = c[j] - S[j] (own-row decay corrected),
   sign-flipped where a_kj < 0
3. sub-resolution tie noise on the key (reference: the shuffle of equal
   runs, calculator_sort, itm-common.hpp:117-148); a zero reduced cost
   becomes a coin-flip-signed perturbation (reference: stop_iterating)
4. select: equalities take the first bk + c_size entries; inequalities
   walk [bkmin + c_size, min(bkmax + c_size, r_size)] and stop at the first
   blocking-sign reduced cost, i.e. selected + 1 = clip(cnt, lo, hi) with
   cnt the count of nonpositive keys
5. affect: chosen slots set their variable (negative factors invert) and
   get P += d, the rest the opposite; the middle case moves pi_k by the
   mean of the straddling reduced costs; d = delta + kappa/(1-kappa) * gap

x-write conflicts inside a block resolve in favor of the later row in
block order, as sequential last-writer-wins would.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from baryonyx_torch.ops.layout import CompiledProblem


def activities(cp: CompiledProblem, x: torch.Tensor) -> torch.Tensor:
    """Row activities A x. x: [n] or [n, R] → [m] or [m, R].

    One matmul against the dense factor matrix when the layout has one,
    else a gather over the padded rows."""
    if cp.dense_A is not None and x.ndim == 2:
        return cp.dense_A @ x.to(cp.dense_A.dtype)
    xg = x[cp.row_vars.long()].to(cp.row_factor.dtype)  # [m, Kr] or [m, Kr, R]
    a = cp.row_factor
    mask = cp.row_mask
    if x.ndim == 2:
        a = a[:, :, None]
        mask = mask[:, :, None]
    return torch.where(mask, a * xg, 0.0).sum(dim=1)


def violated_mask(cp: CompiledProblem, x: torch.Tensor) -> torch.Tensor:
    """Rows whose activity falls outside [bmin, bmax]
    (reference: is_valid_constraint, itm-common.hpp:76-115).
    x: [n] → [m]; x: [n, R] → [m, R]."""
    act = activities(cp, x)
    bmin = cp.bmin.to(act.dtype)
    bmax = cp.bmax.to(act.dtype)
    if x.ndim == 2:
        bmin = bmin[:, None]
        bmax = bmax[:, None]
    return (act < bmin) | (act > bmax)


def add_rows_(S: torch.Tensor, idx: torch.Tensor, vals: torch.Tensor) -> torch.Tensor:
    """S[idx[i]] += vals[i] for every i, in the same order on every run.
    ``index_add_`` does that on the CPU; on CUDA it adds with atomics,
    whose order, and so the last bits of a sum, change from run to run,
    and a solve run from one seed could then find a feasible solution or
    not. There the sort-based ``index_put_(accumulate=True)`` adds instead:
    a seed gives one result, as in the JAX package."""
    if S.device.type == "cuda":
        return S.index_put_((idx,), vals, accumulate=True)
    return S.index_add_(0, idx, vals)


def column_sums(
    cp: CompiledProblem, P: torch.Tensor, pi: torch.Tensor
) -> torch.Tensor:
    """Exact S[j] = sum_k a_kj (pi_k + P[k, s(k,j)]) over the column view,
    one column slot after another. The layout fills each column's slots in
    ascending row order, so every device adds the terms in the order of a
    scatter over the row view in ascending element order, bit for bit,
    with no sort and no atomics. Padded column slots are dropped by
    ``where``: a non-finite P in a padded row slot never reaches S.
    P: [m, Kr, R], pi: [m, R] → [n, R]."""
    R = pi.shape[-1]
    Pf = P.reshape(-1, R)
    rows = cp.col_rows.t().long().contiguous()  # [Kc, n]
    flat = rows * cp.Kr + cp.col_slots.t().long()
    fac = cp.row_factor.reshape(-1)[flat][:, :, None]  # [Kc, n, 1]
    mask = cp.col_mask.t().contiguous()[:, :, None]
    S = torch.zeros((cp.n, R), dtype=P.dtype, device=P.device)
    for c in range(cp.Kc):
        term = pi.index_select(0, rows[c]) + Pf.index_select(0, flat[c])
        S += torch.where(mask[c], fac[c] * term, 0.0)
    return S


def write_rows(
    P: torch.Tensor,  # [m, ...] (updated in place)
    rows_c: torch.Tensor,  # int[B] row indices, sentinels clamped to m - 1
    row_ok: torch.Tensor,  # bool[B] false on sentinel rows
    new_rows: torch.Tensor,  # [B, ...]
    has_sentinels: bool,
) -> None:
    """P[rows_c] = new_rows for the real rows of a block. Sentinel rows
    clamp onto row m - 1 and would write back its block-entry value: they
    take the real row's new value when it is in the block too, so that the
    duplicate writes agree."""
    if has_sentinels:
        B = rows_c.shape[0]
        same = (rows_c[:, None] == rows_c[None, :]) & row_ok[None, :]
        owner = torch.where(
            same.any(dim=1),
            same.to(torch.int8).argmax(dim=1),
            torch.arange(B, device=rows_c.device),
        )
        new_rows = new_rows[owner]
    P.index_copy_(0, rows_c.long(), new_rows)


def block_costs(
    cp: CompiledProblem,
    cost: torch.Tensor,  # f[n]
    quad_fac: Optional[torch.Tensor],  # f[n, Qmax] normalized factors
    gvars: torch.Tensor,  # int64[B, Kr] variables of a block's slots
    x: torch.Tensor,  # int32[n, R]
) -> torch.Tensor:
    """c(j, x) for the slots of a row block: the linear cost plus the
    quadratic terms of the neighbors that are set (reference:
    quadratic_cost_type::operator(), itm-common.hpp:1404-1416).
    → [B, Kr, 1], or [B, Kr, R] with quadratic factors."""
    cx = cost[gvars][:, :, None]
    if cp.has_quad and quad_fac is not None:
        qx = x[cp.quad_var[gvars].long()].to(cost.dtype)  # [B, Kr, Q, R]
        qf = torch.where(cp.quad_mask[gvars], quad_fac[gvars], 0.0)
        cx = cx + (qf[..., None] * qx).sum(dim=2)
    return cx


class SweepNoise(NamedTuple):
    """Caller-drawn random numbers of one sweep, uniform in [0, 1), one
    [B, Kr, R] slab per row block: ``tie`` perturbs the sort keys,
    ``costs`` replaces the reduced costs under the random solver."""

    tie: torch.Tensor  # f[n_blocks, B, Kr, R]
    costs: Optional[torch.Tensor] = None  # f[n_blocks, B, Kr, R]


def _extremes(keys: torch.Tensor, J: int, largest: bool) -> list:
    """The J smallest (largest) keys along dim 1, one tensor [B, R] per
    rank. Rank semantics: equal keys each keep their own rank, so exact
    ties give a zero gap between neighbouring ranks as a sorted array
    does. Ranks past the row's length hold +inf (-inf)."""
    Kr = keys.shape[1]
    if J > Kr:
        fill = float("-inf") if largest else float("inf")
        pad = keys.new_full((keys.shape[0], J - Kr, keys.shape[2]), fill)
        keys = torch.cat([keys, pad], dim=1)
    vals = torch.topk(keys, J, dim=1, largest=largest).values
    return list(vals.unbind(dim=1))


def _pick(stack: list, idx: torch.Tensor) -> torch.Tensor:
    """stack[idx] per (row, replica); an index outside [0, len - 2] picks
    the last entry."""
    acc = stack[-1]
    for j in range(len(stack) - 2, -1, -1):
        acc = torch.where(idx == j, stack[j], acc)
    return acc


def sweep(
    cp: CompiledProblem,
    x: torch.Tensor,  # int32[n, R]
    P: torch.Tensor,  # f[m, Kr, R] (updated in place)
    pi: torch.Tensor,  # f[m, R] (updated in place)
    cost: torch.Tensor,  # f[n]
    sched: torch.Tensor,  # bool[m, R] — which (row, replica) to process
    order: torch.Tensor,  # int32[mp], mp % block_size == 0, sentinel m
    kappa,  # f[R] or scalar
    delta,
    theta,
    gen: Optional[torch.Generator],  # the sweep's random stream
    obj_amp,  # f[R] or scalar — 0 disables the push amplification
    n_rows=None,
    minimize: bool = True,
    block_size: int = 8,
    random_solver: bool = False,
    quad_fac: Optional[torch.Tensor] = None,  # f[n, Qmax] normalized factors
    S: Optional[torch.Tensor] = None,  # carried merged column sums f[n, R]
    S_fresh: Optional[bool] = None,  # the carried sums are still exact
    noise: Optional[SweepNoise] = None,
) -> Tuple:
    """One full pass over the scheduled rows for all replicas. Returns
    (x, P, pi, S, new_violated [m, R], remaining [R]).

    ``random_solver=True`` replaces the computed reduced costs with uniform
    noise, turning selection into a randomized greedy fill (reference:
    random-solver.cpp:32-340, CLI ``--random``).

    ``n_rows``: when the caller compacts the scheduled rows (union over
    replicas) to the front of ``order``, the number of them. An int is
    used as it is; a tensor is read once at entry (one host sync); None
    walks every block of ``order``. All three give the same result: an
    unscheduled (row, replica) pair changes nothing — its P row keeps its
    bits, its pi moves by 0, it adds nothing to S and writes no x — even
    where its P holds a non-finite value.

    The merged column sums S are updated incrementally; callers may carry
    them across sweeps (P and pi change only in here) and pass
    ``S_fresh=False`` now and then to force the exact recompute that
    bounds the drift. P and pi are updated in place; x and S come back as
    new tensors. The S updates go through ``add_rows_``, which adds in the
    same order on every run.

    The random numbers (tie noise; the random solver's costs) are drawn
    from ``gen`` block by block, or taken from ``noise``."""
    m, n, Kr = cp.m, cp.n, cp.Kr
    B = block_size
    mp = order.shape[0]
    if mp % B:
        raise ValueError(f"sweep: order length {mp} is not a multiple of {B}")
    if cp.has_z:
        raise ValueError("sweep: rows with integer factors go to z_sweep")
    dev = P.device
    dtype = P.dtype
    R = pi.shape[-1]
    n_blocks = mp // B
    if n_rows is not None:
        n_blocks = min((int(n_rows) + B - 1) // B, n_blocks)

    def vec(v):
        return torch.as_tensor(v, dtype=dtype, device=dev)

    theta, delta, kappa, amp = vec(theta), vec(delta), vec(kappa), vec(obj_amp)
    kp = kappa / (1 - kappa)
    inf = float("inf")

    if S is None or not S_fresh:
        S = column_sums(cp, P, pi)
    # row n takes what padded slots and sentinel rows scatter
    S = torch.cat([S, S.new_zeros((1, R))])
    order = order.to(device=dev, dtype=torch.int32)
    has_sentinels = mp > m
    prio2 = 2 * torch.arange(B, device=dev)[:, None, None]

    for b in range(n_blocks):
        rows = order[b * B:(b + 1) * B]
        row_ok = rows < m  # [B]
        rl = torch.clamp(rows, max=m - 1).long()
        valid = sched[rl] & row_ok[:, None]  # [B, R]

        vars0 = cp.row_vars[rl]  # [B, Kr]
        a3 = cp.row_factor[rl][:, :, None]  # [B, Kr, 1]
        mask = cp.row_mask[rl]  # [B, Kr]
        live = mask[:, :, None]
        P_rows = P[rl]  # [B, Kr, R]

        gvars = torch.where(mask, vars0, 0).long()
        cx = block_costs(cp, cost, quad_fac, gvars, x)

        # own-row decay correction: the reference decays P[k, :] *= theta
        # before the column walk; S still holds the un-decayed values
        Sg = S[gvars] + a3 * (theta - 1) * P_rows
        P_dec = theta * P_rows

        r = cx - Sg
        r = torch.where(a3 < 0, -r, r)
        r = r + amp * cx
        if random_solver:
            if noise is not None:
                r = noise.costs[b].to(dtype) - 0.5
            else:
                r = torch.rand((B, Kr, R), generator=gen, device=dev, dtype=dtype) - 0.5

        # with all keys distinct, "sorted rank <= selected" is a threshold
        # test against the (selected + 1)-th smallest key. eps is one
        # maximum over the block and every replica.
        if noise is not None:
            tb = noise.tie[b].to(dtype)
        else:
            tb = torch.rand((B, Kr, R), generator=gen, device=dev, dtype=dtype)
        eps = 1e-6 * (1 + torch.where(live, r, 0.0).abs().max())
        r = r + (tb - 0.5) * eps
        # sv: ascending-selection space (negated for maximize); padded
        # slots sort to the end as +inf
        sv = torch.where(live, r if minimize else -r, inf)

        r_size = cp.r_size[rl].long()[:, None]  # [B, 1]
        c_size = cp.neg_count[rl].long()[:, None]
        bkmin = cp.bmin[rl].long()[:, None]
        bkmax = cp.bmax[rl].long()[:, None]
        is_eq = cp.is_eq[rl][:, None]

        lo = bkmin + c_size
        hi = torch.minimum(bkmax + c_size, r_size)
        sel_eq = torch.minimum(lo, r_size) - 1
        cnt = (sv <= 0).sum(dim=1)  # [B, R]
        sel_ineq = torch.minimum(torch.maximum(cnt, lo), hi) - 1
        selected = torch.where(is_eq, sel_eq, sel_ineq)  # [B, R]

        if cp.sel_reduction_ok:
            # sort-free order statistics (see CompiledProblem.J_bot)
            bots = _extremes(sv, cp.J_bot, largest=False)
            tops = _extremes(torch.where(live, sv, -inf), cp.J_top, largest=True)
            # boundary ranks cnt - 1 / cnt: largest nonpositive, smallest
            # positive
            mx_np = torch.where(sv <= 0, sv, -inf).amax(dim=1)
            mn_p = torch.where(sv > 0, sv, inf).amin(dim=1)
            unclipped = (~is_eq) & (selected + 1 == cnt)
            bot_ok = (selected >= 0) & (selected < cp.J_bot)
            sv_sel = torch.where(
                unclipped,
                mx_np,
                torch.where(
                    bot_ok, _pick(bots, selected), _pick(tops, r_size - 1 - selected)
                ),
            )
            sv_sel1 = torch.where(
                unclipped,
                mn_p,
                torch.where(
                    selected + 1 < cp.J_bot,
                    _pick(bots, selected + 1),
                    _pick(tops, r_size - 2 - selected),
                ),
            )
            sv0 = bots[0]
        else:
            # full sort (deep rank needs, e.g. rows whose equality
            # right-hand side sits mid-row)
            svs = torch.sort(sv, dim=1).values
            selc = selected.clamp(0, Kr - 1)[:, None, :]
            selc1 = (selected + 1).clamp(0, Kr - 1)[:, None, :]
            sv_sel = svs.gather(1, selc)[:, 0]
            sv_sel1 = svs.gather(1, selc1)[:, 0]
            sv0 = svs[:, 0]
        if minimize:
            Rs_sel, Rs_sel1, Rs0 = sv_sel, sv_sel1, sv0
        else:
            Rs_sel, Rs_sel1, Rs0 = -sv_sel, -sv_sel1, -sv0
        thr = torch.where(selected < 0, -inf, sv_sel)[:, None, :]

        case_none = selected < 0
        case_all = selected + 1 >= r_size
        d = delta + kp * torch.where(
            case_none,
            Rs0 * 0.5,
            torch.where(case_all, Rs_sel * 1.5, Rs_sel1 - Rs_sel),
        )
        dpi = torch.where(case_none | case_all, 0.0, (Rs_sel + Rs_sel1) * 0.5)

        # membership by threshold: a slot is chosen iff its (noised,
        # distinct) key is among the selected + 1 smallest
        s = torch.where(sv <= thr, 1.0, -1.0).to(dtype)
        new_P = P_dec + s * torch.sign(a3) * d[:, None, :]
        bits = (s * a3 > 0).to(torch.int64)

        vmask = valid[:, None, :] & live  # [B, Kr, R]
        new_P = torch.where(vmask, new_P, P_rows)
        dpi = torch.where(valid, dpi, 0.0)

        write_rows(P, rl, row_ok, new_P, has_sentinels)
        pi.index_add_(0, rl, dpi)  # dpi is 0 on sentinel rows

        # incremental column sums (row-local updates); nothing from a pair
        # that is not scheduled
        sidx = torch.where(mask & row_ok[:, None], vars0, n).reshape(-1).long()
        upd = torch.where(vmask, a3 * (dpi[:, None, :] + new_P - P_rows), 0.0)
        add_rows_(S, sidx, upd.reshape(-1, R))

        # priority scatter: the later row of the block wins conflicting x
        # writes
        enc = torch.where(vmask, prio2 + bits, -1)
        tmp = torch.full((n + 1, R), -1, dtype=torch.int64, device=dev)
        tmp.scatter_reduce_(
            0, sidx[:, None].expand(-1, R), enc.reshape(-1, R), reduce="amax"
        )
        x = torch.where(tmp[:n] >= 0, (tmp[:n] & 1).to(x.dtype), x)

    new_viol = violated_mask(cp, x)
    return x, P, pi, S[:n], new_viol, new_viol.sum(dim=0, dtype=torch.int32)
