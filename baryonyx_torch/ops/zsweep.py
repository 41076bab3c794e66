"""The sweep for general-integer (ℤ) rows: dispatcher, plain PyTorch
versions, and the CUDA wrapper of the knapsack DP selector.

Problems with integer factors |a| > 1 take another row solver than the
0/1 and ±1 sweep (reference: solver_inequalities_Zcoeff,
itm-solver-inequalities-Z.cpp):

- reduced costs use |a| and fold pi and P together,
  r_j = c_j - sum_k |a_kj| (pi_k + P[k, s]), with no sign flip
  (reference: compute_reduced_costs, :253-293);
- each row is solved exactly: rows of up to Z_ENUM_MAX variables by
  scoring every feasible assignment (one batched matmul per block,
  reference: exhaustive_solver), long ℤ rows by a 0-1 knapsack DP over the
  gcd-scaled activity (``dp_select``, the hand-written kernel
  csrc/dpselect.cu; the reference's branch-and-bound,
  branch-and-bound-solver.hpp:450-533, finds the same optimum), long ±1
  rows by the greedy prefix walk (``_walk_select``, reference:
  select_variables_101, :308-325);
- the update (reference: local_affect, :346-439) uses the constant
  d = kappa/(1-kappa) + delta, always moves pi_k, and repairs P where a
  variable's recomputed reduced cost disagrees with its assignment.

Rows are processed in blocks of B (Jacobi within a block, sequential
across blocks), replicas on the trailing axis R, as in ops/psweep.py.

``dp_select`` sends CUDA tensors to the kernel (or raises) and CPU tensors
to ``dp_select_reference``, the plain version with the kernel's
arithmetic, in float32 or float64 (the kernel's double instance). Nothing
falls back. ``dp_launch_plan`` says how the kernel is launched for a shape
and score type.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Tuple

import torch

from baryonyx_torch.ops.layout import CompiledProblem
from baryonyx_torch.ops.psweep import SMEM_MAX, SMEM_STATIC, THREADS_MAX
from baryonyx_torch.ops.sweep import (
    add_rows_,
    block_costs,
    violated_mask,
    write_rows,
)

DP_BIG = 1e30  # the float32 DP's finite "infinity": every sum it enters stays finite


def dp_big(dtype: torch.dtype) -> float:
    """The DP's "infinity" for a score type: DP_BIG in float32, as the JAX
    package's Pallas kernel (its float32 route); +inf in float64, as the
    JAX package's ``_dp_select`` (its float64 route). A finite 1e30 in
    float64 is not out of reach: its ulp is about 1.4e14, so once reduced
    costs pass about 3e29 (a maximizing Z run's duals grow about 20x per
    sweep) an unreachable activity takes a finite score and can win."""
    return float("inf") if dtype == torch.float64 else DP_BIG


def _vec(v, device, dtype) -> torch.Tensor:
    """A scalar or per-replica hyperparameter as a tensor of the state's
    type."""
    return torch.as_tensor(v, dtype=dtype, device=device)


# ---------------------------------------------------------------------------
# knapsack DP selector (kernel B)
# ---------------------------------------------------------------------------


def dp_select_reference(
    cp: CompiledProblem,
    rows_c: torch.Tensor,  # int32[B]
    r: torch.Tensor,  # f32 or f64 [B, Kr, R] reduced costs
    mask: torch.Tensor,  # bool[B, Kr]
    minimize: bool,
) -> torch.Tensor:
    """Exact 0-1 selection for long ℤ rows, in plain PyTorch ops: per (row,
    replica) the set minimizing (maximizing) sum_{s chosen} r_s subject to
    the row's bounds, by a DP over the gcd-scaled activity w (table width
    W = cp.Wdp, offset dp_lo). f[w] is the best score at activity w; the
    chosen set rides along as 32-bit mask words (bit s in word s // 32).

    Per slot s: cand = f[w - a_s] + rq_s (big = ``dp_big(r.dtype)`` where
    w - a_s leaves the table), taken on strict cand < f; masked slots have
    rq = big. The answer is the lowest w in [wlo, whi] with the least f.
    The same single add and strict compare as the kernel, in r's type. A
    row that is no DP row gets an all-zero set (the sweep discards it).
    Returns bool[B, Kr, R]."""
    B, Kr, R = r.shape
    W = cp.Wdp
    nw = (Kr + 31) // 32
    dev = r.device
    big = dp_big(r.dtype)
    rows = rows_c.long()
    is_dp = cp.dp_row[rows]
    if not bool(is_dp.any()):
        # a block without a DP row (padding rows among them) chooses
        # nothing: skip the table (one host read)
        return torch.zeros((B, Kr, R), dtype=torch.bool, device=dev)
    rq = r if minimize else -r
    rq = torch.where(mask[:, :, None], rq, big)

    a = cp.dp_fac[rows].long()  # [B, Kr] (0 on non-DP rows: harmless)
    lo = cp.dp_lo[rows].long()  # [B]
    wlo = cp.dp_blo[rows].long() - lo
    whi = cp.dp_bhi[rows].long() - lo
    wi = torch.arange(W, device=dev)
    f = torch.where(
        (wi[None, :] == -lo[:, None])[:, :, None],
        torch.zeros((), dtype=r.dtype, device=dev),
        torch.full((), big, dtype=r.dtype, device=dev),
    ).expand(B, W, R).contiguous()
    msk = torch.zeros((nw, B, W, R), dtype=torch.int64, device=dev)
    for s in range(Kr):
        src = wi[None, :] - a[:, s, None]  # [B, W]
        ok = ((src >= 0) & (src < W))[:, :, None]
        idx = src.clamp(0, W - 1)[:, :, None].expand(B, W, R)
        fsh = torch.where(ok, f.gather(1, idx), big)
        cand = fsh + rq[:, s, None, :]
        take = cand < f
        word, bit = divmod(s, 32)
        new_msk = []
        for t in range(nw):
            msh = torch.where(ok, msk[t].gather(1, idx), 0)
            if t == word:
                msh = msh | (1 << bit)
            new_msk.append(torch.where(take, msh, msk[t]))
        msk = torch.stack(new_msk)
        f = torch.where(take, cand, f)

    in_range = (wi[None, :] >= wlo[:, None]) & (wi[None, :] <= whi[:, None])
    f = torch.where(in_range[:, :, None], f, big)
    fmin = f.amin(dim=1, keepdim=True)
    wbest = torch.where(f == fmin, wi[None, :, None], W).amin(dim=1)  # [B, R]
    words = msk.gather(2, wbest[None, :, None, :].expand(nw, B, 1, R))[:, :, 0]
    s_iota = torch.arange(Kr, device=dev)
    bits = (words[s_iota // 32] >> (s_iota % 32)[:, None, None]) & 1  # [Kr, B, R]
    return (bits.permute(1, 0, 2) > 0) & is_dp[:, None, None]


class DPPlan(NamedTuple):
    """How csrc/dpselect.cu is launched for one shape.

    ``variant`` "shared": one CUDA block owns one row of the block and
    ``G`` replicas, with ``T`` lanes striding over the table's W entries
    (``G * T`` threads) and the table in ``smem_bytes`` of shared memory.
    ``variant`` "device_table": one thread per (row, replica), 32 replicas
    per CUDA block, the table in a device-memory scratch."""

    variant: str
    G: int
    T: int
    smem_bytes: int  # dynamic shared memory

    @property
    def threads(self) -> int:
        return self.G * self.T

    def grid(self, R: int, B: int) -> Tuple[int, int]:
        return (R // self.G, B)


DEVICE_TABLE = DPPlan("device_table", 32, 1, 0)
DP_ENTRIES = 3  # table entries per thread and slot the plan aims at
DP_LANES_MAX = 128  # lanes over w: more warps make the slots' barriers dearer


def _dp_smem_bytes(W: int, Kr: int, G: int, T: int, itemsize: int = 4) -> int:
    """Dynamic shared memory of the "shared" variant at scores of
    ``itemsize`` bytes (4: float32, 8: float64): two f tables [W][G], the
    staged reduced costs [Kr][G] and the argmin's scores in that type; the
    take words [W][G], the row's factors and live flags [Kr], the argmin's
    w and the chosen words in 4 bytes."""
    nw = (Kr + 31) // 32
    nwarps = G * T // 32
    return itemsize * (2 * W * G + Kr * G + nwarps * G) + 4 * (
        nw * W * G + 2 * Kr + nwarps * G + nw * G
    )


def dp_plan(W: int, Kr: int, G: int, T: int, itemsize: int = 4) -> DPPlan:
    """The "shared" plan with these choices at scores of ``itemsize``
    bytes; ValueError if the card or the kernel cannot take it."""
    if G < 1 or 32 % G or T < 1 or (G * T) % 32 or G * T > THREADS_MAX:
        raise ValueError(f"dpselect plan: bad G {G} or T {T}")
    if itemsize not in (4, 8):
        raise ValueError(f"dpselect plan: scores of {itemsize} bytes")
    nbytes = _dp_smem_bytes(W, Kr, G, T, itemsize)
    if nbytes + SMEM_STATIC > SMEM_MAX:
        raise ValueError(f"dpselect plan: {nbytes} bytes of shared memory")
    return DPPlan("shared", G, T, nbytes)


def dp_launch_plan(W: int, Kr: int, R: int, B: int, itemsize: int = 4) -> DPPlan:
    """The plan for a DP call on a table of W entries, rows of Kr slots, R
    replicas, B rows and scores of ``itemsize`` bytes: the largest group
    of replicas (8 at most, and a divisor of R) whose table fits shared
    memory, with a lane for every DP_ENTRIES entries of the table, up to
    DP_LANES_MAX lanes; the device_table variant when the table fits at no
    group size. (Measured at W 88 and W 2048, both score types, with
    baryonyx_torch/kernel_tune.py.)"""
    if W < 1 or Kr < 1 or R < 1 or B < 1:
        raise ValueError(f"dpselect plan: bad shape W {W} Kr {Kr} R {R} B {B}")
    for G in (8, 4, 2, 1):
        if R % G:
            continue
        step = 32 // G  # T in multiples of it makes whole warps
        want = -(-W // DP_ENTRIES)
        T = min(DP_LANES_MAX, THREADS_MAX // G, -(-want // step) * step)
        if _dp_smem_bytes(W, Kr, G, T, itemsize) + SMEM_STATIC <= SMEM_MAX:
            return dp_plan(W, Kr, G, T, itemsize)
    return DEVICE_TABLE


class CudaDPSelect:
    """ctypes binding of csrc/dpselect.cu; counts its launches."""

    def __init__(self) -> None:
        self.launches = 0
        self._fn = None

    def load(self):
        if self._fn is None:
            from baryonyx_torch.kernels import load

            fn = load("dpselect").dpselect_launch
            fn.argtypes = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 10 + [
                ctypes.c_void_p
            ]
            fn.restype = ctypes.c_int
            self._fn = fn
        return self._fn

    def __call__(
        self,
        cp: CompiledProblem,
        rows_c: torch.Tensor,
        r: torch.Tensor,
        mask: torch.Tensor,
        minimize: bool,
        plan: Optional[DPPlan] = None,
    ) -> torch.Tensor:
        """The selection on CUDA tensors, launched by ``plan`` (default:
        the shape's ``dp_launch_plan``); ``r`` float32, or float64 for the
        kernel's double instance."""
        dev = r.device
        B, Kr, R = r.shape
        m, W = cp.m, cp.Wdp
        if W < 1 or cp.dp_fac is None:
            raise ValueError("dpselect kernel: the problem has no DP rows")
        if not 1 <= B <= 65535 or R < 1:
            raise ValueError(f"dpselect kernel: bad shape {tuple(r.shape)}")
        if r.dtype not in (torch.float32, torch.float64):
            raise ValueError(f"dpselect kernel: no instance for {r.dtype}")
        itemsize = r.element_size()
        checks = [
            (rows_c, (B,), torch.int32),
            (r, (B, Kr, R), r.dtype),
            (mask, (B, Kr), torch.bool),
            (cp.dp_row, (m,), torch.bool),
            (cp.dp_fac, (m, Kr), torch.int32),
            (cp.dp_lo, (m,), torch.int32),
            (cp.dp_blo, (m,), torch.int32),
            (cp.dp_bhi, (m,), torch.int32),
        ]
        for t, shape, dtype in checks:
            if t.device != dev or t.dtype != dtype or tuple(t.shape) != shape:
                raise ValueError(
                    f"dpselect kernel: expected {dtype} {shape} on {dev}, got "
                    f"{t.dtype} {tuple(t.shape)} on {t.device}"
                )
            if not t.is_contiguous():
                raise ValueError("dpselect kernel: every tensor must be contiguous")
        if plan is None:
            plan = dp_launch_plan(W, Kr, R, B, itemsize)
        shared = plan.variant == "shared"
        f = words = None
        if not shared:
            nw = (Kr + 31) // 32
            f = torch.empty((B, W, R), dtype=r.dtype, device=dev)
            words = torch.empty((B, nw, W, R), dtype=torch.int32, device=dev)
        out = torch.empty((B, Kr, R), dtype=torch.bool, device=dev)
        fn = self.load()
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(
            rows_c.data_ptr(), r.data_ptr(), mask.data_ptr(),
            cp.dp_row.data_ptr(), cp.dp_fac.data_ptr(), cp.dp_lo.data_ptr(),
            cp.dp_blo.data_ptr(), cp.dp_bhi.data_ptr(),
            f.data_ptr() if f is not None else None,
            words.data_ptr() if words is not None else None,
            out.data_ptr(), B, Kr, R, W, int(minimize), int(shared), plan.G,
            plan.T, plan.smem_bytes, itemsize, stream,
        )
        if err != 0:
            raise RuntimeError(
                f"dpselect kernel launch failed: CUDA error {err} ({plan})"
            )
        self.launches += 1
        return out


dp_select_kernel = CudaDPSelect()


def dp_select(
    cp: CompiledProblem,
    rows_c: torch.Tensor,
    r: torch.Tensor,
    mask: torch.Tensor,
    minimize: bool,
) -> torch.Tensor:
    """The long-ℤ-row selection (see ``dp_select_reference``): CUDA tensors
    go to the hand-written kernel (or raise), CPU tensors to the plain
    version."""
    if r.device.type == "cuda":
        return dp_select_kernel(cp, rows_c, r, mask, minimize)
    if r.device.type == "cpu":
        return dp_select_reference(cp, rows_c, r, mask, minimize)
    raise NotImplementedError(f"dp_select: no kernel for {r.device}")


# ---------------------------------------------------------------------------
# greedy prefix walk for long ±1 rows
# ---------------------------------------------------------------------------


def _walk_select(
    cp: CompiledProblem,
    rows_c: torch.Tensor,  # int32[B]
    r_masked: torch.Tensor,  # f32[B, Kr, R], ±inf on padded slots
    a: torch.Tensor,  # f32[B, Kr] row factors
    tb: torch.Tensor,  # f32[B, Kr, R] tie-break noise in [0, 1)
    minimize: bool,
) -> torch.Tensor:
    """Greedy prefix walk (reference: select_variables_101,
    itm-solver-inequalities-Z.cpp:308-325): sort the reduced costs (ties
    broken by ``tb``, then by slot), take the longest feasible prefix
    before the first stop-sign element. Returns chosen bool[B, Kr, R]."""
    B, Kr, R = r_masked.shape
    dev = r_masked.device
    rows = rows_c.long()
    slots = torch.arange(Kr, device=dev)[None, :, None].expand(B, Kr, R)
    sortv = r_masked if minimize else -r_masked
    # lexicographic (sortv, tb) with stable ties: two stable sorts
    by_tb = torch.argsort(tb, dim=1, stable=True)
    by_v = torch.argsort(sortv.gather(1, by_tb), dim=1, stable=True)
    sslot = by_tb.gather(1, by_v)  # [B, Kr, R] slot at each sorted position
    sv = sortv.gather(1, sslot)
    rs_sorted = sv if minimize else -sv
    rank = torch.empty_like(sslot).scatter_(1, sslot, slots)
    f_sorted = a[:, :, None].expand(B, Kr, R).gather(1, sslot)
    prefix = torch.cumsum(f_sorted, dim=1)  # activity of prefix [0..i]
    bkmin = cp.bmin[rows][:, None, None].to(r_masked.dtype)
    bkmax = cp.bmax[rows][:, None, None].to(r_masked.dtype)
    in_len = slots < cp.r_size[rows].long()[:, None, None]
    feasible = (prefix >= bkmin) & (prefix <= bkmax) & in_len
    empty_feasible = ((bkmin <= 0) & (bkmax >= 0))[:, 0, :]  # [B, 1]
    stop = rs_sorted > 0 if minimize else rs_sorted < 0
    # first feasible position (or -1 when the empty prefix is feasible)
    anyf = feasible.any(dim=1)  # [B, R]
    firstf = feasible.to(torch.int8).argmax(dim=1)
    firstf = torch.where(
        empty_feasible, -1, torch.where(anyf, firstf, Kr)
    )
    # the walk breaks at the first stop-sign element after a feasible
    # prefix exists: cut = min { i : i > firstf and stop[i] }
    stop_after = stop & (slots > firstf[:, None, :])
    any_stop = stop_after.any(dim=1)
    cut = torch.where(
        any_stop, stop_after.to(torch.int8).argmax(dim=1) - 1, Kr - 1
    )
    # best = last feasible position <= cut (-1: select nothing)
    ok = feasible & (slots <= cut[:, None, :])
    best_walk = torch.where(
        ok.any(dim=1), (Kr - 1) - ok.flip(1).to(torch.int8).argmax(dim=1), -1
    )
    return rank <= best_walk[:, None, :]


# ---------------------------------------------------------------------------
# the sweep
# ---------------------------------------------------------------------------


def _column_sums_abs_ext(
    cp: CompiledProblem, P: torch.Tensor, pi: torch.Tensor
) -> torch.Tensor:
    """column_sums_abs with a trailing dropped row n, where padded slots
    land. → [n + 1, R]."""
    R = pi.shape[-1]
    absa = cp.row_factor.abs()[:, :, None]  # [m, Kr, 1]
    contrib = (absa * (pi[:, None, :] + P)).reshape(-1, R)
    idx = torch.where(cp.row_mask, cp.row_vars, cp.n).reshape(-1).long()
    S = torch.zeros((cp.n + 1, R), dtype=P.dtype, device=P.device)
    add_rows_(S, idx, contrib)
    return S


def column_sums_abs(
    cp: CompiledProblem, P: torch.Tensor, pi: torch.Tensor
) -> torch.Tensor:
    """S[j] = sum_k |a_kj| (pi_k + P[k, s(k, j)]) by one scatter-add over
    all elements; padded slots land in a dropped row n.
    P: [m, Kr, R], pi: [m, R] → [n, R]."""
    return _column_sums_abs_ext(cp, P, pi)[: cp.n]


def z_sweep(
    cp: CompiledProblem,
    x: torch.Tensor,  # int32[n, R]
    P: torch.Tensor,  # f32[m, Kr, R] (updated in place)
    pi: torch.Tensor,  # f32[m, R] (updated in place)
    cost: torch.Tensor,  # f32[n]
    sched: torch.Tensor,  # bool[m, R]
    order: torch.Tensor,  # int32[mp], mp % block_size == 0, sentinel m
    kappa,  # f32[R] or scalar
    delta,
    theta,
    gen: Optional[torch.Generator],  # the walk's tie-break noise stream
    obj_amp,  # f32[R] or scalar
    minimize: bool = True,
    block_size: int = 8,
    quad_fac: Optional[torch.Tensor] = None,  # f32[n, Qmax] normalized factors
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """One pass over the rows of ``order`` of a ℤ problem, for every
    replica. Returns (x, P, pi, new_violated [m, R], remaining [R]).
    ``quad_fac`` adds the quadratic cost terms of the set neighbors.

    Every block of ``order`` is processed: rows past the scheduled ones
    are unscheduled for every replica and change nothing, so the sweep
    needs no row count from the device (no host sync). P and pi are
    updated in place; x comes back as a new tensor. The walk's tie-break
    noise is drawn from ``gen`` (only instances with long ±1 rows walk)."""
    m, n, Kr = cp.m, cp.n, cp.Kr
    B = block_size
    mp = order.shape[0]
    if mp % B:
        raise ValueError(f"z_sweep: order length {mp} is not a multiple of {B}")
    dev = P.device
    dtype = P.dtype
    R = pi.shape[-1]
    theta = _vec(theta, dev, dtype)
    delta = _vec(delta, dev, dtype)
    kappa = _vec(kappa, dev, dtype)
    amp = _vec(obj_amp, dev, dtype)
    d_const = kappa / (1 - kappa) + delta  # [R] (reference: local_affect :361)
    big = float("inf") if minimize else float("-inf")
    inf = float("inf")

    S = _column_sums_abs_ext(cp, P, pi)  # [n + 1, R], row n dropped
    order = order.to(device=dev, dtype=torch.int32)
    iota_b = torch.arange(B, device=dev)

    for blk in range(mp // B):
        rows = order[blk * B:(blk + 1) * B]
        row_ok = rows < m
        rows_c = torch.clamp(rows, max=m - 1)
        rl = rows_c.long()
        valid = sched[rl] & row_ok[:, None]  # [B, R]

        vars0 = cp.row_vars[rl]  # [B, Kr]
        a = cp.row_factor[rl]
        a3 = a.abs()[:, :, None]
        mask = cp.row_mask[rl]
        P_rows = P[rl]  # [B, Kr, R]

        gvars = torch.where(mask, vars0, 0).long()
        cx = block_costs(cp, cost, quad_fac, gvars, x)  # [B, Kr, 1 or R]
        # own-row decay correction (P[k, :] *= theta before reduced costs)
        Sv = S[gvars] + a3 * (theta - 1) * P_rows
        P_dec = theta * P_rows
        r = cx - Sv
        r = r + amp * cx
        r_masked = torch.where(mask[:, :, None], r, big)

        # ---- enumeration path: score every feasible assignment
        bits8 = cp.assign_bits[rl]  # int8[B, Amax, Kr]
        scores = torch.bmm(
            bits8.to(dtype), torch.where(mask[:, :, None], r, 0.0)
        )  # [B, Amax, R]
        scores = torch.where(cp.assign_valid[rl][:, :, None], scores, big)
        best_a = scores.argmin(dim=1) if minimize else scores.argmax(dim=1)
        chosen = bits8.transpose(1, 2).gather(
            2, best_a[:, None, :].expand(B, Kr, R)
        ) > 0  # [B, Kr, R]: the bits of the best assignment

        # ---- greedy prefix walk for long ±1 rows
        if cp.z_needs_walk:
            tb = torch.rand((B, Kr, R), generator=gen, device=dev)
            chosen_walk = _walk_select(cp, rows_c, r_masked, a, tb, minimize)
            chosen = torch.where(
                cp.enum_row[rl][:, None, None], chosen, chosen_walk
            )
        # ---- exact DP for long ℤ rows (kernel B on the card)
        if cp.Wdp:
            chosen_dp = dp_select(cp, rows_c, r, mask, minimize)
            chosen = torch.where(cp.dp_row[rl][:, None, None], chosen_dp, chosen)
        chosen = chosen & mask[:, :, None]

        # ---- pi update (reference local_affect cases)
        nchosen = chosen.sum(dim=1, dtype=torch.int32)  # [B, R]
        case_none = nchosen == 0
        case_all = nchosen >= cp.r_size[rl][:, None]
        live = mask[:, :, None]
        if minimize:
            worst_chosen = torch.where(chosen, r, -inf).amax(dim=1)
            best_unchosen = torch.where(~chosen & live, r, inf).amin(dim=1)
            r0_all = torch.where(live, r, inf).amin(dim=1)
        else:
            worst_chosen = torch.where(chosen, r, inf).amin(dim=1)
            best_unchosen = torch.where(~chosen & live, r, -inf).amax(dim=1)
            r0_all = torch.where(live, r, -inf).amax(dim=1)
        dpi = torch.where(
            case_none,
            r0_all * 0.5,
            torch.where(
                case_all, worst_chosen * 1.5, (worst_chosen + best_unchosen) * 0.5
            ),
        )  # [B, R]
        dpi = torch.where(valid, dpi, 0.0)

        # ---- P update with repair (reference: local_compute_reduced_cost,
        # :296-307)
        sgn = torch.where(chosen, 1.0, -1.0)
        P1 = P_dec + sgn * d_const
        repair = r - a3 * (dpi[:, None, :] + sgn * d_const)
        fix_chosen = chosen & (repair >= 0)
        fix_unchosen = ~chosen & (repair <= 0)
        P2 = torch.where(
            fix_chosen,
            P1 - repair + d_const,
            torch.where(fix_unchosen, P1 + repair - d_const, P1),
        )
        vmask = valid[:, None, :] & live
        P2 = torch.where(vmask, P2, P_rows)

        write_rows(P, rows_c, row_ok, P2, mp > m)
        pi.index_add_(0, rl, dpi)  # dpi is 0 on sentinel rows

        sidx = torch.where(mask & row_ok[:, None], vars0, n).reshape(-1).long()
        # nothing from a pair that is not scheduled, whatever its P holds
        dS = torch.where(vmask, a3 * (dpi[:, None, :] + (P2 - P_rows)), 0.0)
        add_rows_(S, sidx, dS.reshape(-1, R))

        # x: the later row of the block wins (prio * 2 + bit, max-reduced)
        enc = torch.where(
            vmask, iota_b[:, None, None] * 2 + chosen.to(torch.int64), -1
        )
        tmp = torch.full((n + 1, R), -1, dtype=torch.int64, device=dev)
        tmp.scatter_reduce_(
            0, sidx[:, None].expand(-1, R), enc.reshape(-1, R), reduce="amax"
        )
        x = torch.where(tmp[:n] >= 0, (tmp[:n] & 1).to(x.dtype), x)

    new_viol = violated_mask(cp, x)
    return x, P, pi, new_viol, new_viol.sum(dim=0, dtype=torch.int32)
