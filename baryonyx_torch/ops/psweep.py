"""The fused Wedelin sweep: dispatcher, plain PyTorch version, CUDA wrapper.

One sweep processes the scheduled rows in blocks of ``Bb``: decisions for
all rows of a block are computed against the column sums as they stood at
block entry (Jacobi within the block), then applied row by row (later rows
win conflicting x writes), with strict sequencing across blocks
(reference per-row update: affect(), itm-common.hpp:382-467).

Per block:
  phase A, per row: gather S[j], reduced cost r_s, multiplicative tie
    noise, running order statistics (count of nonpositive keys, J_bot
    smallest, J_top largest, largest nonpositive, smallest positive);
    selection selected+1 = clip(cnt, lo, hi) for inequalities or the
    equality constant; the threshold key of the selected rank, d, dpi.
  phase B, per row: chosen = key <= threshold; P row update,
    S[j] += a*(dpi + dP), x[j] masked write, pi[k] += dpi.

Tie noise: sv*(1 + (u-1/2)*2e-6) + (u-1/2)*delta*1e-3, with u from a
splitmix counter hash of (seed pair, row, slot, replica) — the same hash
in the CUDA kernel and in the plain version, so the two agree bit for bit.

On CUDA tensors ``psweep`` launches the hand-written kernel
(csrc/psweep.cu) or raises; on CPU tensors it runs the plain version.
``psweep_reference`` runs the plain version on any device.
``launch_plan`` says how the kernel is launched for a shape: which variant,
how many replicas and slot lanes per CUDA block, how much shared memory.

The sweep updates ``P``, ``pi`` and ``S`` in place and returns a new ``x``
(callers read the pre-sweep ``x`` afterwards).
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Tuple

import torch

from baryonyx_torch.ops.layout import CompiledProblem
from baryonyx_torch.ops.sweep import column_sums, violated_mask

MAX_B = 16  # rows per block: the kernel keeps one (thr, d, dpi) per row
MAX_KR = 2048  # padded row-length ceiling of the fused path
# quadratic costs ride a dense [n, n] neighbor matrix: CQ = quad_mat @ x
QUAD_DENSE_MAX_N = 8192
WARP = 32  # R must be a multiple of it on CUDA

_M32 = 0xFFFFFFFF

# the card's limits for one CUDA block (H100)
SMEM_MAX = 232_448  # bytes of shared memory, static and dynamic together
SMEM_STATIC = 8192  # kept back for the kernels' static shared memory
THREADS_MAX = 1024
# csrc/psweep.cu, "group" variant
GROUP_THREADS_MAX = 512  # its __launch_bounds__ with the keys in shared memory
GROUP_THREADS_REGS = 256  # and with the keys in registers
NQ = 8  # slots per lane whose key, P and variable stay in registers
NSTAT = 11  # floats of one warp's order statistics in the merge stage


class SweepPlan(NamedTuple):
    """How csrc/psweep.cu is launched for one shape.

    ``variant`` "group": one CUDA block owns ``G`` replicas and has
    ``Bb * Wr`` warps, warp (b, wr) on row b of the row block; a row has
    ``Wr * 32 / G`` slot lanes, the CUDA block ``T`` of them, so
    ``G * T`` threads. ``key_storage`` says where a slot's key waits
    between phase A and phase B: "registers" (with its P value and
    variable index), or "shared" (a [Bb][Kr][G] tile). ``s_resident``:
    the group's S [n][G] stays in shared memory for the whole sweep.

    ``variant`` "replica_thread": one thread per replica, 32 per CUDA
    block, the keys in a [Bb, Kr, R] device-memory scratch
    (``key_storage`` "device")."""

    variant: str
    G: int
    T: int
    Wr: int
    smem_bytes: int  # dynamic shared memory
    key_storage: str
    s_resident: bool

    @property
    def threads(self) -> int:
        return self.G * self.T

    def grid(self, R: int) -> int:
        return R // self.G


REPLICA_THREAD = SweepPlan("replica_thread", WARP, 1, 0, 0, "device", False)


def group_plan(
    n: int, Kr: int, Bb: int, G: int, Wr: int, key_regs: bool,
    s_resident: bool = False,
) -> SweepPlan:
    """The "group" plan with these choices; ValueError if the card or the
    kernel cannot take it."""
    if G < 1 or WARP % G or Wr < 1 or not 1 <= Bb <= MAX_B:
        raise ValueError(f"psweep plan: bad G {G}, Wr {Wr} or Bb {Bb}")
    lanes_per_row = Wr * (WARP // G)
    threads = Bb * Wr * WARP
    if threads > (GROUP_THREADS_REGS if key_regs else GROUP_THREADS_MAX):
        raise ValueError(f"psweep plan: {threads} threads")
    if key_regs and Kr > NQ * lanes_per_row:
        raise ValueError("psweep plan: the row does not fit the register keys")
    nbytes = _group_smem_bytes(n, Kr, Bb, G, Wr, key_regs, s_resident)
    if nbytes + SMEM_STATIC > SMEM_MAX:
        raise ValueError(f"psweep plan: {nbytes} bytes of shared memory")
    return SweepPlan(
        "group", G, Bb * lanes_per_row, Wr, nbytes,
        "registers" if key_regs else "shared", s_resident,
    )


def _group_smem_bytes(n, Kr, Bb, G, Wr, key_regs, s_resident) -> int:
    """Dynamic shared memory of the "group" variant: the merge stage of
    the Wr warps of each row, the key tile, the resident S."""
    return 4 * (
        (Bb * Wr * NSTAT * G if Wr > 1 else 0)
        + (0 if key_regs else Bb * Kr * G)
        + (n * G if s_resident else 0)
    )


def launch_plan(n: int, Kr: int, R: int, Bb: int) -> SweepPlan:
    """The plan for a sweep over n variables, rows padded to Kr slots, R
    replicas and row blocks of Bb rows: every shape ``supports`` admits
    on CUDA gets one.

    Rows of up to NQ slots per lane keep their keys in registers: with 4
    replicas per CUDA block and one warp per row (8 slot lanes, no merge
    across warps) up to Kr 64, else with 8 replicas and as many warps per
    row as the row needs, while the CUDA block stays within 256 threads.
    Longer rows use the shared-memory tile at 8 or 4 replicas per CUDA
    block and as many warps per row as 512 threads allow; where the tile
    fits at neither, the replica_thread variant. S stays resident where
    it fits beside the rest. (Measured on scp200x1000 and scpnre500x5000
    with baryonyx_torch/kernel_tune.py.)"""
    if R % WARP or not 1 <= Bb <= MAX_B or Kr < 1 or n < 1:
        raise ValueError(f"psweep plan: bad shape n {n} Kr {Kr} R {R} Bb {Bb}")
    budget = SMEM_MAX - SMEM_STATIC
    choices = []
    wr_regs = GROUP_THREADS_REGS // (WARP * Bb)  # warps per row at most
    if wr_regs >= 1 and Kr <= NQ * (WARP // 4):
        choices.append((4, 1, True))
    wr = -(-Kr // (NQ * (WARP // 8)))
    if wr <= wr_regs:
        choices.append((8, wr, True))
    wr_tile = GROUP_THREADS_MAX // (WARP * Bb)
    choices += [(8, wr_tile, False), (4, wr_tile, False)]
    for G, Wr, key_regs in choices:
        base = _group_smem_bytes(n, Kr, Bb, G, Wr, key_regs, False)
        if base <= budget:
            s_resident = base + 4 * n * G <= budget
            return group_plan(n, Kr, Bb, G, Wr, key_regs, s_resident)
    return REPLICA_THREAD


def supports(cp: CompiledProblem, R: int, dtype, device) -> bool:
    """Static eligibility for the fused sweep."""
    if dtype != torch.float32:
        return False
    if cp.has_z or not cp.sel_reduction_ok or cp.Kr > MAX_KR:
        return False
    if cp.has_quad and cp.n > QUAD_DENSE_MAX_N:
        return False
    if torch.device(device).type == "cuda" and R % WARP:
        return False
    return True


class SweepInputs(NamedTuple):
    """Everything one sweep reads or writes, prepared on one device."""

    cp: CompiledProblem
    S: torch.Tensor  # f32[n, R] (updated in place)
    x: torch.Tensor  # int32[n, R] (fresh copy, updated in place)
    pi: torch.Tensor  # f32[m, R] (updated in place)
    P: torch.Tensor  # f32[m, Kr, R] (updated in place)
    sched: torch.Tensor  # bool[m, R]
    order: torch.Tensor  # int32[mp], mp % Bb == 0, sentinel m
    n_rows: torch.Tensor  # int32[1]
    cost: torch.Tensor  # f32[n]
    CQ: Optional[torch.Tensor]  # f32[n, R] quadratic sums at sweep entry
    kappa: torch.Tensor  # f32[R]
    amp: torch.Tensor  # f32[R]
    delta: torch.Tensor  # f32[R]
    theta: torch.Tensor  # f32[R]
    seed: torch.Tensor  # int32[2]
    minimize: bool
    Bb: int


def _vec(v, R: int, device) -> torch.Tensor:
    """A scalar or per-replica [R] hyperparameter as a contiguous f32[R]."""
    t = torch.as_tensor(v, dtype=torch.float32, device=device)
    return t.expand(R).contiguous()


def _prepare(
    cp, x, P, pi, cost, sched, order, kappa, delta, theta, seed, obj_amp,
    n_rows, minimize, block_size, quad_mat, S, S_fresh,
) -> SweepInputs:
    R = pi.shape[-1]
    dev = P.device
    if not supports(cp, R, P.dtype, dev):
        raise NotImplementedError(
            "the fused sweep does not cover this instance (float32 only, "
            "no Z rows, sort-free selection, Kr <= MAX_KR; R % 32 == 0 on "
            "CUDA); ops/sweep.py:sweep takes what this one does not"
        )
    if (quad_mat is not None) != cp.has_quad:
        raise ValueError("quad_mat must be given exactly for quadratic problems")
    Bb = max(1, min(block_size, MAX_B))
    if S is None or not S_fresh:
        S = column_sums(cp, P, pi)
    order = order.to(device=dev, dtype=torch.int32)
    if n_rows is None:
        n_rows = torch.full((1,), order.shape[0], dtype=torch.int32, device=dev)
    else:
        n_rows = torch.as_tensor(n_rows, device=dev).to(torch.int32).reshape(1)
    mp = order.shape[0]
    mp_pad = -(-mp // Bb) * Bb
    if mp_pad != mp:
        order = torch.cat(
            [order, torch.full((mp_pad - mp,), cp.m, dtype=torch.int32, device=dev)]
        )
    CQ = None
    if cp.has_quad:
        CQ = (quad_mat @ x.to(quad_mat.dtype)).to(torch.float32).contiguous()
    return SweepInputs(
        cp=cp,
        S=S.contiguous(),
        x=x.to(torch.int32).clone(memory_format=torch.contiguous_format),
        pi=pi,
        P=P,
        sched=sched.to(torch.bool).contiguous(),
        order=order.contiguous(),
        n_rows=n_rows,
        cost=cost.to(torch.float32).contiguous(),
        CQ=CQ,
        kappa=_vec(kappa, R, dev),
        amp=_vec(obj_amp, R, dev),
        delta=_vec(delta, R, dev),
        theta=_vec(theta, R, dev),
        seed=torch.as_tensor(seed, device=dev).to(torch.int32).reshape(2),
        minimize=minimize,
        Bb=Bb,
    )


def _finish(inp: SweepInputs) -> Tuple:
    new_viol = violated_mask(inp.cp, inp.x)
    remaining = new_viol.sum(dim=0, dtype=torch.int32)
    return inp.x, inp.P, inp.pi, inp.S, new_viol, remaining


# ---------------------------------------------------------------------------
# plain PyTorch version
# ---------------------------------------------------------------------------


def hash_uniform(
    seed_u: int, rows: torch.Tensor, slots: torch.Tensor, reps: torch.Tensor
) -> torch.Tensor:
    """u in [0, 1) for every (row, slot, replica): the kernel's splitmix
    counter hash in int64, masked to 32 bits after every add and multiply
    (the low 32 bits of a wrapped int64 product are exact).
    rows [L], slots [K], reps [R] → f32[L, K, R]."""
    h = (reps * 0x85EBCA6B) & _M32
    h = (h + seed_u) & _M32
    kk = (rows * 0xC2B2AE35) & _M32
    ss = (slots * 0x27D4EB2F) & _M32
    h = (h[None, None, :] + kk[:, None, None]) & _M32
    h = (h + ss[None, :, None]) & _M32
    h = h ^ (h >> 15)
    h = (h * 0x2C1B3C6D) & _M32
    h = h ^ (h >> 12)
    h = (h * 0x297A2D39) & _M32
    h = h ^ (h >> 15)
    return (h >> 8).to(torch.float32) * (2.0**-24)


def _pick(stack: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """The kernel's register pick: stack [L, J, R], idx [L, R]; an index
    in [0, J-2] selects that entry, anything else the last one."""
    J = stack.shape[1]
    acc = stack[:, J - 1]
    for j in range(J - 2, -1, -1):
        acc = torch.where(idx == j, stack[:, j], acc)
    return acc


def _sweep_plain(inp: SweepInputs) -> None:
    """One sweep in plain PyTorch ops, vectorised over R and over the
    slots of a block's rows, with a Python loop over blocks; phase B
    applies the rows one by one, in kernel order. Syncs with the host
    (it reads the order and the row lengths)."""
    cp = inp.cp
    m, Kr = cp.m, cp.Kr
    S, x, pi, P = inp.S, inp.x, inp.pi, inp.P
    R = S.shape[1]
    dev = S.device
    Bb = inp.Bb
    unit = cp.all_unit_pos
    minimize = inp.minimize
    theta, delta, amp = inp.theta, inp.delta, inp.amp
    kp = inp.kappa / (1.0 - inp.kappa)
    s0, s1 = [int(v) & _M32 for v in inp.seed.tolist()]
    seed_u = (s0 * 0x9E3779B9 + s1) & _M32
    order_h = inp.order.tolist()
    n_blocks = min((int(inp.n_rows.item()) + Bb - 1) // Bb, len(order_h) // Bb)
    rsz_h = cp.r_size.tolist()
    reps = torch.arange(R, dtype=torch.int64, device=dev)
    slots = torch.arange(Kr, dtype=torch.int64, device=dev)
    inf = float("inf")

    for blk in range(n_blocks):
        ks = [k for k in order_h[blk * Bb:(blk + 1) * Bb] if 0 <= k < m]
        if not ks:
            continue
        rows = torch.tensor(ks, dtype=torch.int64, device=dev)  # [L]

        # ---- phase A: decisions against block-entry S
        vars_ = cp.row_vars[rows].long()  # [L, Kr]
        rsz = cp.r_size[rows].long()  # [L]
        live = (slots[None, :] < rsz[:, None])[:, :, None]  # [L, Kr, 1]
        cj = inp.cost[vars_][:, :, None]
        if inp.CQ is not None:
            cj = cj + inp.CQ[vars_]
        Sj = S[vars_]  # [L, Kr, R]
        pr = P[rows]  # [L, Kr, R]
        if unit:
            r = cj - (Sj + (theta - 1.0) * pr)
        else:
            af = cp.row_factor[rows][:, :, None]
            r = cj - (Sj + af * (theta - 1.0) * pr)
            r = torch.where(af < 0, -r, r)
        r = r + amp * cj
        sv = r if minimize else -r
        u = hash_uniform(seed_u, rows, slots, reps)
        sv = sv * (1.0 + (u - 0.5) * 2e-6) + (u - 0.5) * (delta * 1e-3)

        cnt = ((sv <= 0) & live).sum(dim=1)  # [L, R]
        bots = torch.topk(
            torch.where(live, sv, inf), cp.J_bot, dim=1, largest=False
        ).values  # [L, J_bot, R] ascending
        tops = torch.topk(
            torch.where(live, sv, -inf), cp.J_top, dim=1, largest=True
        ).values  # [L, J_top, R] descending
        mx_np = torch.where(live & (sv <= 0), sv, -inf).amax(dim=1)
        mn_p = torch.where(live & (sv > 0), sv, inf).amin(dim=1)

        # ---- selection
        bmin = cp.bmin[rows].long()[:, None]
        bmax = cp.bmax[rows].long()[:, None]
        csz = cp.neg_count[rows].long()[:, None]
        iseq = cp.is_eq[rows][:, None]
        rs2 = rsz[:, None]
        lo = bmin + csz
        hi = torch.minimum(bmax + csz, rs2)
        sel_eq = torch.minimum(bmin + csz, rs2) - 1
        sel_ineq = torch.minimum(torch.maximum(cnt, lo), hi) - 1
        selected = torch.where(iseq, sel_eq, sel_ineq)  # [L, R]
        unclipped = (~iseq) & (selected + 1 == cnt)
        bot_ok = (selected >= 0) & (selected < cp.J_bot)
        sv_sel = torch.where(
            unclipped,
            mx_np,
            torch.where(
                bot_ok, _pick(bots, selected), _pick(tops, rs2 - 1 - selected)
            ),
        )
        sv_sel1 = torch.where(
            unclipped,
            mn_p,
            torch.where(
                selected + 1 < cp.J_bot,
                _pick(bots, selected + 1),
                _pick(tops, rs2 - 2 - selected),
            ),
        )
        if minimize:
            Rs_sel, Rs_sel1, Rs0 = sv_sel, sv_sel1, bots[:, 0]
        else:
            Rs_sel, Rs_sel1, Rs0 = -sv_sel, -sv_sel1, -bots[:, 0]
        case_none = selected < 0
        case_all = selected + 1 >= rs2
        d = delta + kp * torch.where(
            case_none,
            Rs0 * 0.5,
            torch.where(case_all, Rs_sel * 1.5, Rs_sel1 - Rs_sel),
        )
        dpi = torch.where(case_none | case_all, 0.0, (Rs_sel + Rs_sel1) * 0.5)
        valid = inp.sched[rows]  # [L, R]
        dpi = torch.where(valid, dpi, 0.0)
        thr = torch.where(case_none, -inf, sv_sel)

        # ---- phase B: row by row (later rows win x conflicts)
        for i, k in enumerate(ks):
            rs = rsz_h[k]
            v = vars_[i, :rs]
            p_i = pr[i, :rs]
            chosen = sv[i, :rs] <= thr[i]
            sgn = torch.where(chosen, 1.0, -1.0)
            if unit:
                new_p = theta * p_i + sgn * d[i]
            else:
                a_i = af[i, :rs]
                new_p = theta * p_i + (sgn * torch.where(a_i < 0, -1.0, 1.0)) * d[i]
            new_p = torch.where(valid[i], new_p, p_i)
            P[k, :rs] = new_p
            upd = (dpi[i] + new_p) - p_i
            if unit:
                bits = chosen
            else:
                upd = a_i * upd
                bits = sgn * a_i > 0
            # a pair that is not scheduled adds nothing, whatever its P
            # holds (the kernel skips it)
            S[v] = S[v] + torch.where(valid[i], upd, 0.0)
            x[v] = torch.where(valid[i], bits.to(torch.int32), x[v])
            pi[k] = pi[k] + dpi[i]


def psweep_reference(
    cp: CompiledProblem,
    x: torch.Tensor,
    P: torch.Tensor,
    pi: torch.Tensor,
    cost: torch.Tensor,
    sched: torch.Tensor,
    order: torch.Tensor,
    kappa,
    delta,
    theta,
    seed,
    obj_amp,
    n_rows=None,
    minimize: bool = True,
    block_size: int = 8,
    quad_mat: Optional[torch.Tensor] = None,
    S: Optional[torch.Tensor] = None,
    S_fresh: Optional[bool] = None,
) -> Tuple:
    """The plain PyTorch version of ``psweep``, on any device: same
    contract, same arithmetic, same tie noise."""
    inp = _prepare(
        cp, x, P, pi, cost, sched, order, kappa, delta, theta, seed, obj_amp,
        n_rows, minimize, block_size, quad_mat, S, S_fresh,
    )
    _sweep_plain(inp)
    return _finish(inp)


# ---------------------------------------------------------------------------
# CUDA kernel wrapper
# ---------------------------------------------------------------------------


class CudaSweep:
    """ctypes binding of csrc/psweep.cu; counts its launches."""

    def __init__(self) -> None:
        self.launches = 0
        self._fn = None

    def load(self):
        if self._fn is None:
            from baryonyx_torch.kernels import load

            fn = load("psweep").psweep_launch
            fn.argtypes = [ctypes.c_void_p] * 18 + [ctypes.c_int] * 16 + [
                ctypes.c_void_p
            ]
            fn.restype = ctypes.c_int
            self._fn = fn
        return self._fn

    def __call__(self, inp: SweepInputs, plan: Optional[SweepPlan] = None) -> None:
        """One sweep on CUDA tensors, launched by ``plan`` (default: the
        shape's ``launch_plan``)."""
        cp = inp.cp
        dev = inp.P.device
        R = inp.S.shape[1]
        m, n, Kr = cp.m, cp.n, cp.Kr
        rowmeta = cp.rowmeta()
        checks = [
            (inp.S, (n, R), torch.float32),
            (inp.x, (n, R), torch.int32),
            (inp.pi, (m, R), torch.float32),
            (inp.P, (m, Kr, R), torch.float32),
            (inp.sched, (m, R), torch.bool),
            (inp.order, (inp.order.shape[0],), torch.int32),
            (inp.n_rows, (1,), torch.int32),
            (rowmeta, (m, 5), torch.int32),
            (cp.row_vars, (m, Kr), torch.int32),
            (cp.row_factor, (m, Kr), torch.float32),
            (inp.cost, (n,), torch.float32),
            (inp.kappa, (R,), torch.float32),
            (inp.amp, (R,), torch.float32),
            (inp.delta, (R,), torch.float32),
            (inp.theta, (R,), torch.float32),
            (inp.seed, (2,), torch.int32),
        ]
        if inp.CQ is not None:
            checks.append((inp.CQ, (n, R), torch.float32))
        for t, shape, dtype in checks:
            if t.device != dev or t.dtype != dtype or tuple(t.shape) != shape:
                raise ValueError(
                    f"psweep kernel: expected {dtype} {shape} on {dev}, got "
                    f"{t.dtype} {tuple(t.shape)} on {t.device}"
                )
            if not t.is_contiguous():
                raise ValueError("psweep kernel: every tensor must be contiguous")
        if R % WARP or inp.order.shape[0] % inp.Bb or not 1 <= inp.Bb <= MAX_B:
            raise ValueError("psweep kernel: R % 32, mp % Bb or Bb out of range")
        if plan is None:
            plan = launch_plan(n, Kr, R, inp.Bb)
        group = plan.variant == "group"
        keys = None
        if not group:
            keys = torch.empty((inp.Bb, Kr, R), dtype=torch.float32, device=dev)
        fn = self.load()
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(
            inp.S.data_ptr(), inp.x.data_ptr(), inp.pi.data_ptr(),
            inp.P.data_ptr(), keys.data_ptr() if keys is not None else None,
            inp.sched.data_ptr(),
            inp.order.data_ptr(), inp.n_rows.data_ptr(), rowmeta.data_ptr(),
            cp.row_vars.data_ptr(), cp.row_factor.data_ptr(),
            inp.cost.data_ptr(),
            inp.CQ.data_ptr() if inp.CQ is not None else None,
            inp.kappa.data_ptr(), inp.amp.data_ptr(), inp.delta.data_ptr(),
            inp.theta.data_ptr(), inp.seed.data_ptr(),
            m, n, Kr, R, inp.order.shape[0], inp.Bb, cp.J_bot, cp.J_top,
            int(cp.all_unit_pos), int(inp.minimize), int(group), plan.G,
            plan.Wr, int(plan.key_storage == "registers"),
            int(plan.s_resident), plan.smem_bytes, stream,
        )
        if err != 0:
            raise RuntimeError(
                f"psweep kernel launch failed: CUDA error {err} ({plan})"
            )
        self.launches += 1


psweep_kernel = CudaSweep()


def psweep(
    cp: CompiledProblem,
    x: torch.Tensor,
    P: torch.Tensor,
    pi: torch.Tensor,
    cost: torch.Tensor,
    sched: torch.Tensor,
    order: torch.Tensor,
    kappa,
    delta,
    theta,
    seed,
    obj_amp,
    n_rows=None,
    minimize: bool = True,
    block_size: int = 8,
    quad_mat: Optional[torch.Tensor] = None,
    S: Optional[torch.Tensor] = None,
    S_fresh: Optional[bool] = None,
) -> Tuple:
    """One fused sweep. Returns (x, P, pi, S, new_violated [m, R],
    remaining [R]).

    x int32[n, R], P f32[m, Kr, R], pi f32[m, R], cost f32[n],
    sched bool[m, R], order int32[mp] (every row at most once, then the
    sentinel m), kappa/obj_amp f32[R],
    delta/theta scalars or f32[R], seed int32[2] (the tie-noise stream),
    n_rows: rows of ``order`` to process (a device tensor, default all).
    ``S`` carries the merged column sums across sweeps; it is recomputed
    exactly when absent or when ``S_fresh`` is false. Quadratic problems
    pass ``quad_mat`` (dense [n, n] normalized factors): the kernel reads
    c(j, x) = c_j + CQ[j] with CQ = quad_mat @ x at sweep entry.

    CUDA tensors go to the hand-written kernel (or raise), CPU tensors to
    the plain version."""
    inp = _prepare(
        cp, x, P, pi, cost, sched, order, kappa, delta, theta, seed, obj_amp,
        n_rows, minimize, block_size, quad_mat, S, S_fresh,
    )
    if inp.P.device.type == "cuda":
        psweep_kernel(inp)
    elif inp.P.device.type == "cpu":
        _sweep_plain(inp)
    else:
        raise NotImplementedError(f"psweep: no kernel for {inp.P.device}")
    return _finish(inp)
