"""Solve mode: a single kappa-annealed run to feasibility + push phase.

reference: lib/src/itm-solver-common.hpp:43-262 (solver_functor) and
:264-319 (solve_problem wrapper).

One replica (R = 1) steps sweep by sweep. The loop runs on the host: after
every sweep it reads one small packed tensor (remaining, kappa) and stops
at the first feasible sweep, at kappa > kappa_max or at the loop limit,
exactly where the reference's in-loop checks stop. Between chunks of
``chunk_size`` sweeps the host enforces the wall-clock limit and runs the
observers. The push phase (reference: :171-213) amplifies reduced costs by
the objective for one sweep per push round, then runs normal sweeps.

0/1 and ±1 instances go through ops/sweep.py:sweep, instances with integer
factors through ops/zsweep.py:z_sweep (whose long rows go to the knapsack
DP kernel on a CUDA device).
"""

from __future__ import annotations

import os
import time
from typing import NamedTuple, Optional

import numpy as np
import torch

from baryonyx_torch.core.context import Context
from baryonyx_torch.core.errors import InfeasibleConstraintError
from baryonyx_torch.core.model import ObjectiveType, Problem
from baryonyx_torch.core.params import (
    ConstraintOrder,
    FloatType,
    ObserverType,
    SolverParameters,
    SolverType,
)
from baryonyx_torch.core.result import Result, ResultStatus, Solution
from baryonyx_torch.device import DeviceLike, resolve_device
from baryonyx_torch.observer import make_observer
from baryonyx_torch.ops import zsweep as zs
from baryonyx_torch.ops.layout import CompiledProblem, compile_problem
from baryonyx_torch.ops.sweep import SweepNoise, sweep, violated_mask
from baryonyx_torch.preprocess.merge import make_merged_constraints
from baryonyx_torch.solver import common
from baryonyx_torch.solver.exact import exact_enumerate

INT_MAX = 2**31 - 1


class DeviceState(NamedTuple):
    """The solver's state. Solve mode runs a single replica, so the
    replica axis R is 1. What only the host loop reads is kept on the
    host."""

    x: torch.Tensor  # int32[n, 1]
    P: torch.Tensor  # f[m, Kr, 1]
    pi: torch.Tensor  # f[m, 1]
    S: torch.Tensor  # f[n, 1] — carried merged column sums (see ops/sweep.py)
    viol: torch.Tensor  # bool[m, 1]
    kappa: torch.Tensor  # f[1]
    loop: int  # global iteration counter
    remaining: torch.Tensor  # int32[1]
    best_x: torch.Tensor  # int32[n, 1]
    best_remaining: torch.Tensor  # int32[1]
    best_value: torch.Tensor  # f[1] (true objective, solver dtype)
    best_loop: torch.Tensor  # int32[1]
    order_code: int  # current policy, advanced by `cycle`
    gen: Optional[torch.Generator]  # the run's random stream, on the device
    stop_reason: int  # 0 running, 1 feasible, 2 kappa_max, 3 limit


STOP_RUNNING, STOP_FEASIBLE, STOP_KAPPA, STOP_LIMIT = 0, 1, 2, 3


def _m_pad(m: int, block: int) -> int:
    return ((m + block - 1) // block) * block


def make_initial_state(
    cp: CompiledProblem,
    x0: np.ndarray,
    params: SolverParameters,
    gen: Optional[torch.Generator],
    dtype: torch.dtype,
    order_code: int,
    minimize: bool,
) -> DeviceState:
    n, m = cp.n, cp.m
    dev = cp.device
    x = torch.as_tensor(np.asarray(x0, np.int32).reshape(n, 1), device=dev)
    viol = violated_mask(cp, x)  # [m, 1]
    return DeviceState(
        x=x,
        P=torch.zeros((m, cp.Kr, 1), dtype=dtype, device=dev),
        pi=torch.zeros((m, 1), dtype=dtype, device=dev),
        S=torch.zeros((n, 1), dtype=dtype, device=dev),
        viol=viol,
        kappa=torch.full((1,), params.kappa_min, dtype=dtype, device=dev),
        loop=0,
        remaining=viol.sum(dim=0, dtype=torch.int32),
        best_x=x,
        best_remaining=torch.full((1,), INT_MAX, dtype=torch.int32, device=dev),
        best_value=torch.full(
            (1,), float("inf") if minimize else float("-inf"), dtype=dtype,
            device=dev,
        ),
        best_loop=torch.zeros((1,), dtype=torch.int32, device=dev),
        order_code=order_code,
        gen=gen,
        stop_reason=STOP_RUNNING,
    )


def _step(
    cp: CompiledProblem,
    cost_norm: torch.Tensor,
    cost_orig: torch.Tensor,
    cost_constant: float,
    st: DeviceState,
    hp: dict,
    minimize: bool,
    block_size: int,
    push_amp: Optional[float],
    anneal_counter: Optional[int] = None,
    random_solver: bool = False,
    order_policy: Optional[ConstraintOrder] = None,
    noise: Optional[SweepNoise] = None,
) -> DeviceState:
    """One outer iteration: schedule, sweep, best-tracking, kappa anneal
    (reference: itm-solver-common.hpp:135-166). P and pi of ``st`` are
    updated in place. ``noise`` carries the sweep's random numbers when
    the caller draws them."""
    dtype = st.P.dtype
    dev = st.P.device
    m = cp.m
    mp = _m_pad(m, block_size)
    cycling = order_policy is None or order_policy == ConstraintOrder.cycle
    order = common.make_order(
        cp, torch.tensor(st.order_code, device=dev) if cycling else None,
        st.x, st.pi, st.gen, mp, static_policy=order_policy,
    )
    # The push sweep re-runs rows with objective-amplified reduced costs.
    # The reference only walks the previously-violated list, which is
    # empty right after feasibility; every row is processed instead, which
    # is what the reference's pi_sign_change policy does and what makes
    # the push improve the incumbent.
    process_all = (
        push_amp is not None
        or st.order_code == common.ORDER_CODES[ConstraintOrder.pi_sign_change]
    )
    eff_viol = torch.ones_like(st.viol) if process_all else st.viol  # [m, 1]

    # compact scheduled rows to the front, preserving policy order, so the
    # block loop runs ceil(remaining / B) steps
    sched_any = eff_viol.any(dim=1)  # [m]
    padded = torch.cat([sched_any, sched_any.new_zeros(1)])[
        order.long().clamp(max=m)
    ]
    order = order[torch.argsort((~padded).to(torch.int8), stable=True)]
    n_rows = padded.sum(dtype=torch.int32)

    amp = 0.0 if push_amp is None else push_amp
    kappa_eff = st.kappa if push_amp is None else st.kappa * hp["pushing_k_factor"]

    if cp.has_z:
        if random_solver:
            # the reference's dispatch has no random solver for Z problems
            # (itm.hpp:181-200 raises internal_error)
            raise NotImplementedError("random solver for Z problems")
        x, P, pi, viol, remaining = zs.z_sweep(
            cp, st.x, st.P, st.pi, cost_norm, eff_viol, order, kappa_eff,
            hp["delta"], hp["theta"], st.gen, amp, minimize=minimize,
            block_size=block_size, quad_fac=hp.get("quad_fac"),
        )
        S = st.S
    else:
        # carried column sums: recompute exactly every 16 sweeps to bound
        # float drift from the incremental updates
        x, P, pi, S, viol, remaining = sweep(
            cp, st.x, st.P, st.pi, cost_norm, eff_viol, order, kappa_eff,
            hp["delta"], hp["theta"], st.gen, amp, n_rows=n_rows,
            minimize=minimize, block_size=block_size,
            random_solver=random_solver, quad_fac=hp.get("quad_fac"),
            S=st.S, S_fresh=(st.loop % 16) != 0, noise=noise,
        )

    # best tracking (reference: store_if_better, :242-261)
    value = cost_orig @ x.to(dtype) + cost_constant  # [1]
    if "qa" in hp:
        xa = x[hp["qa"]].to(dtype)
        xb = x[hp["qb"]].to(dtype)
        value = value + hp["qfv"] @ (xa * xb)
    feasible = remaining == 0
    better_value = (value < st.best_value) if minimize else (value > st.best_value)
    # the first feasible x always wins over an infeasible best
    improves = torch.where(
        feasible,
        (st.best_remaining != 0) | better_value,
        remaining < st.best_remaining,
    )
    best_x = torch.where(improves, x, st.best_x)
    best_remaining = torch.where(improves, remaining, st.best_remaining)
    best_value = torch.where(improves & feasible, value, st.best_value)
    best_loop = torch.where(improves, st.loop, st.best_loop).to(torch.int32)

    # kappa annealing after warmup w (reference: :152-155); the push phase
    # anneals on its own inner counter (reference: :196-200) and the push
    # sweep itself never anneals
    kappa = st.kappa
    if anneal_counter is not None and anneal_counter > hp["w"]:
        kappa = torch.where(
            feasible,
            st.kappa,
            st.kappa
            + hp["kappa_step"]
            * torch.pow(remaining.to(dtype) / float(cp.m_real), hp["alpha"]),
        )

    # the cycle policy advances only on push sweeps
    # (reference: itm-common.hpp:694-695)
    order_code = st.order_code
    if push_amp is not None and hp["use_cycle"]:
        order_code = (st.order_code + 1) % common.N_CYCLE_STATES

    return DeviceState(
        x=x, P=P, pi=pi, S=S, viol=viol, kappa=kappa, loop=st.loop + 1,
        remaining=remaining, best_x=best_x, best_remaining=best_remaining,
        best_value=best_value, best_loop=best_loop, order_code=order_code,
        gen=st.gen, stop_reason=st.stop_reason,
    )


def make_hyper(params: SolverParameters, cost_norm: np.ndarray, dtype) -> dict:
    """The hyperparameters of a run as Python numbers, rounded to the
    solver's type where the sweep computes with them."""
    delta = (
        common.compute_delta(cost_norm, params.theta)
        if params.delta < 0
        else params.delta
    )
    npdt = np.float64 if dtype == torch.float64 else np.float32

    def f(v) -> float:
        return float(npdt(v))

    return dict(
        delta=f(delta),
        theta=f(params.theta),
        kappa_step=f(params.kappa_step),
        kappa_max=f(params.kappa_max),
        alpha=f(params.alpha),
        w=int(params.w),
        pushing_k_factor=f(params.pushing_k_factor),
        pushing_objective_amplifier=f(params.pushing_objective_amplifier),
        limit=int(min(params.limit, INT_MAX)),
        use_cycle=params.order == ConstraintOrder.cycle,
    )


def _read(st: DeviceState):
    """(remaining, kappa) of the state on the host: the one read a sweep
    costs the host loop."""
    rem, kappa = torch.stack(
        [st.remaining[0].to(torch.float64), st.kappa[0].to(torch.float64)]
    ).tolist()
    return int(rem), kappa


def run_chunk(
    cp, cost_norm, cost_orig, cost_constant, hp, st: DeviceState, n_iters: int,
    minimize: bool, block_size: int, random_solver: bool = False,
    order_policy=None,
) -> DeviceState:
    """Up to n_iters annealed sweeps, stopping early on feasibility /
    kappa_max / global limit (reference: itm-solver-common.hpp:135-166)."""
    start_loop = st.loop
    while st.stop_reason == STOP_RUNNING and st.loop - start_loop < n_iters:
        st = _step(
            cp, cost_norm, cost_orig, cost_constant, st, hp, minimize,
            block_size, None, anneal_counter=st.loop,
            random_solver=random_solver, order_policy=order_policy,
        )
        st = st._replace(stop_reason=_stop_reason(st, hp, hp["limit"]))
    return st


def _stop_reason(st: DeviceState, hp: dict, limit: Optional[int]) -> int:
    remaining, kappa = _read(st)
    if remaining == 0:
        return STOP_FEASIBLE
    if kappa > hp["kappa_max"]:
        return STOP_KAPPA
    if limit is not None and st.loop >= limit:
        return STOP_LIMIT
    return STOP_RUNNING


def run_push_round(
    cp, cost_norm, cost_orig, cost_constant, hp, st: DeviceState,
    minimize: bool, block_size: int, push_iters: int,
    random_solver: bool = False, order_policy=None,
) -> DeviceState:
    """One objective-amplified sweep + up to ``push_iters`` normal sweeps
    (reference: itm-solver-common.hpp:171-213)."""
    st = _step(
        cp, cost_norm, cost_orig, cost_constant, st, hp, minimize, block_size,
        hp["pushing_objective_amplifier"], random_solver=random_solver,
        order_policy=order_policy,
    )
    st = st._replace(stop_reason=STOP_RUNNING)
    it = 0
    while it < push_iters and st.stop_reason == STOP_RUNNING:
        st = _step(
            cp, cost_norm, cost_orig, cost_constant, st, hp, minimize,
            block_size, None, anneal_counter=it, random_solver=random_solver,
            order_policy=order_policy,
        )
        st = st._replace(stop_reason=_stop_reason(st, hp, None))
        it += 1
    return st


def solve_compiled(
    ctx: Context, pb: Problem, device: DeviceLike = None
) -> Result:
    """End-to-end solve on a preprocessed Problem
    (reference: solve_problem, itm-solver-common.hpp:264-319), on one
    device (CUDA unless ``device="cpu"``)."""
    t0 = time.monotonic()
    dev = resolve_device(device)
    params = ctx.parameters
    minimize = pb.type == ObjectiveType.minimize
    f64 = params.float_type == FloatType.float64
    dtype = torch.float64 if f64 else torch.float32

    ret = Result(method="solve")
    n = len(pb.vars.values)
    constraints = make_merged_constraints(ctx, pb)

    if not constraints or n == 0:
        ret.status = ResultStatus.success
        ret.solutions.append(Solution([], pb.objective.value))
        common.finalize(ret, pb, len(constraints), t0)
        return ret

    # observer/debug runs want the real loop's trace; the --random
    # baseline must stay random
    exact = None
    if (
        params.observer == ObserverType.none
        and not params.debug
        and params.solver != SolverType.random
    ):
        exact = exact_enumerate(pb, constraints, n)
    if exact is not None:
        bits, value = exact
        ctx.info("  - exact enumeration ({} variables): optimum {}\n", n, value)
        ret.method += "+exact-enum"
        ret.status = ResultStatus.success
        ret.solutions.append(Solution([int(b) for b in bits], value))
        common.finalize(ret, pb, len(constraints), t0)
        return ret

    seed = params.seed if params.seed else int(time.time())
    rng = np.random.default_rng(seed)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)

    try:
        cp = compile_problem(
            constraints, n, dtype=dtype, qelements=pb.objective.qelements,
            device=dev,
        )
    except InfeasibleConstraintError as e:
        # a provably-unsatisfiable row: report what the solver loop would
        # have reported after exhausting its budget (row stays violated)
        ctx.warning("  - infeasible at compile time: {}\n", e)
        ret.status = ResultStatus.limit_reached
        ret.remaining_constraints = 1
        common.finalize(ret, pb, len(constraints), t0)
        return ret
    use_random = params.solver == SolverType.random
    if cp.has_z and use_random:
        raise NotImplementedError("random solver for Z problems")
    cost_orig_real = common.build_cost_vector(pb, n)
    quad_fac_norm = None
    if cp.has_quad:
        cost_norm_real, q_norm = common.normalize_costs_quad(
            cost_orig_real,
            cp.quad_fac.cpu().numpy().astype(np.float64),
            params.cost_norm,
            rng,
        )
        quad_fac_norm = torch.as_tensor(q_norm, dtype=dtype, device=dev)
    else:
        cost_norm_real = common.normalize_costs(
            cost_orig_real, params.cost_norm, rng
        )
    pad = cp.n - n
    cost_orig = np.pad(cost_orig_real, (0, pad))
    cost_norm = np.pad(cost_norm_real, (0, pad))

    x0 = np.pad(
        common.initial_x(params, cost_orig_real, constraints, minimize, rng),
        (0, pad),
    )

    order_code = common.ORDER_CODES.get(params.order, 0)
    if params.order == ConstraintOrder.cycle:
        order_code = 0
    st = make_initial_state(cp, x0, params, gen, dtype, order_code, minimize)

    cn = torch.as_tensor(cost_norm, dtype=dtype, device=dev)
    co = torch.as_tensor(cost_orig, dtype=dtype, device=dev)
    cc = float(pb.objective.value)
    hp = make_hyper(params, cost_norm, dtype)
    if cp.has_quad:
        qel = pb.objective.qelements
        hp["quad_fac"] = quad_fac_norm
        hp["qa"] = torch.as_tensor(
            [q.variable_index_a for q in qel], dtype=torch.long, device=dev
        )
        hp["qb"] = torch.as_tensor(
            [q.variable_index_b for q in qel], dtype=torch.long, device=dev
        )
        hp["qfv"] = torch.as_tensor(
            [q.factor for q in qel], dtype=dtype, device=dev
        )

    # The time-limit budget runs on its own clock, started once the kernel
    # this instance needs is built and loaded; ret.duration keeps the
    # reference semantics of spanning the whole solve from entry.
    if dev.type == "cuda" and cp.has_z and cp.Wdp:
        zs.dp_select_kernel.load()
    budget_t0 = time.monotonic()

    def time_left() -> bool:
        return (
            params.time_limit <= 0
            or (time.monotonic() - budget_t0) < params.time_limit
        )

    observer = make_observer(params.observer)
    run = dict(
        minimize=minimize, block_size=params.block_size,
        random_solver=use_random, order_policy=params.order,
    )

    # per-row debug trace (reference: debug_logger, itm-common.hpp:
    # 1496-1550, --debug → per-thread `name-<hash>.log` with every row
    # update). The trace granularity here is per sweep: rows whose
    # multiplier moved (= rows the sweep updated) with their pi delta and
    # post-sweep violation flag, one sweep per chunk.
    debug_fh = None
    chunk_len = max(1, params.chunk_size)
    if params.debug:
        debug_path = f"baryonyx-debug-{os.getpid()}.log"
        debug_fh = open(debug_path, "w")
        ctx.notice("- debug row trace: {}\n", debug_path)
        chunk_len = 1
        prev_pi = st.pi[:, 0].cpu().numpy().copy()

    # main annealed loop, in chunks
    timed_out = False
    try:
        while True:
            st = run_chunk(cp, cn, co, cc, hp, st, chunk_len, **run)
            if debug_fh is not None:
                pi0 = st.pi[:, 0].cpu().numpy().copy()
                viol0 = st.viol[:, 0].cpu().numpy()
                dpi = pi0 - prev_pi
                for k in np.nonzero((dpi != 0) | viol0)[0]:
                    debug_fh.write(
                        f"sweep={st.loop} k={int(k)} pi={pi0[k]:.9g} "
                        f"dpi={dpi[k]:.9g} violated={int(viol0[k])}\n"
                    )
                prev_pi = pi0
            if params.observer != ObserverType.none:
                observer.make_observation(
                    st.P[..., 0].cpu().numpy(), st.pi[:, 0].cpu().numpy(), st.loop
                )
            if params.print_level > 0:
                lb = common.dual_bound(
                    cp, st.pi[:, 0].cpu().numpy(), cost_norm, minimize
                )
                ctx.info(
                    "  - loop {}: remaining {} kappa {:.4f} dual-bound {:.6g}\n",
                    st.loop, int(st.remaining[0]), float(st.kappa[0]), lb,
                )
            reason = st.stop_reason
            if reason != STOP_RUNNING:
                break
            if not time_left():
                timed_out = True
                break

        if reason == STOP_FEASIBLE and not timed_out:
            # push phase (reference: :171-213)
            for _ in range(params.pushes_limit):
                st = run_push_round(
                    cp, cn, co, cc, hp, st,
                    push_iters=params.pushing_iteration_limit, **run,
                )
                if not time_left():
                    timed_out = True
                    break
            reason = STOP_FEASIBLE
    finally:
        if debug_fh is not None:
            debug_fh.close()

    # status (reference: :125-169, :215-216)
    best_remaining = int(st.best_remaining[0])
    if best_remaining == 0:
        ret.status = ResultStatus.success
    elif timed_out:
        ret.status = ResultStatus.time_limit_reached
    elif reason == STOP_KAPPA:
        ret.status = ResultStatus.kappa_max_reached
    else:
        ret.status = ResultStatus.limit_reached

    best_x = st.best_x.cpu().numpy().ravel()[:n]
    ret.loop = int(st.best_loop[0])
    ret.remaining_constraints = best_remaining
    ret.sweeps = st.loop
    if best_remaining == 0:
        value = common.objective_value(pb, best_x)
        ret.solutions.append(Solution([int(v) for v in best_x], value))
    elif best_remaining != INT_MAX:
        ret.solutions.append(
            Solution(
                [int(v) for v in best_x],
                float("inf") if minimize else float("-inf"),
            )
        )

    common.finalize(ret, pb, len(constraints), t0)
    if ctx.finish_cb:
        ctx.finish_cb(ret)
    return ret
