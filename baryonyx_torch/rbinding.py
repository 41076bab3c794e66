"""R-compatible binding surface.

The reference ships an Rcpp package exposing two positional-scalar entry
points (reference: rbaryonyx/src/rbaryonyx.cpp:369-520,
solve_01lp_problem / optimize_01lp_problem) that take every tunable as a
scalar (enums as ints) and return a named list. This module reproduces
that exact surface as plain-Python functions returning dicts, so R users
call it through reticulate:

    library(reticulate)
    bx <- import("baryonyx_torch.rbinding")
    r <- bx$optimize_01lp_problem("model.lp", time_limit = 30)

Integer enum codes match the reference's documented mappings
(rbaryonyx.cpp:449-495). Both functions run on the first CUDA device
unless given ``device="cpu"``.
"""

from __future__ import annotations

import time

from baryonyx_torch.core.context import make_context
from baryonyx_torch.core.model import ObjectiveType
from baryonyx_torch.core.params import (
    ConstraintOrder,
    CostNormType,
    FloatType,
    InitPolicyType,
    PreConstraintOrder,
    StorageType,
)
from baryonyx_torch.core.result import ResultStatus
from baryonyx_torch.device import DeviceLike

_PRE_ORDER = [
    PreConstraintOrder.none,
    PreConstraintOrder.memory,
    PreConstraintOrder.less_greater_equal,
    PreConstraintOrder.less_equal_greater,
    PreConstraintOrder.greater_less_equal,
    PreConstraintOrder.greater_equal_less,
    PreConstraintOrder.equal_less_greater,
    PreConstraintOrder.equal_greater_less,
    PreConstraintOrder.p1,
    PreConstraintOrder.p2,
    PreConstraintOrder.p3,
    PreConstraintOrder.p4,
]
_ORDER = [
    ConstraintOrder.none,
    ConstraintOrder.reversing,
    ConstraintOrder.random_sorting,
    ConstraintOrder.infeasibility_decr,
    ConstraintOrder.infeasibility_incr,
    ConstraintOrder.lagrangian_decr,
    ConstraintOrder.lagrangian_incr,
    ConstraintOrder.pi_sign_change,
    ConstraintOrder.cycle,
]
_NORM = [
    CostNormType.none,
    CostNormType.random,
    CostNormType.l1,
    CostNormType.l2,
    CostNormType.loo,
]
_INIT = [
    InitPolicyType.bastert,
    InitPolicyType.pessimistic_solve,
    InitPolicyType.optimistic_solve,
]
_FLOAT = [FloatType.float32, FloatType.float64, FloatType.float64]
_STORAGE = [StorageType.one, StorageType.bound, StorageType.five]


def _pick(table, idx, default):
    return table[idx] if 0 <= idx < len(table) else default


def _run(
    file_path: str,
    optimize: bool,
    limit: int,
    theta: float,
    delta: float,
    pre_constraint_order: int,
    constraint_order: int,
    kappa_min: float,
    kappa_step: float,
    kappa_max: float,
    alpha: float,
    w: float,
    time_limit: float,
    seed: int,
    thread: int,
    norm: int,
    pushing_k_factor: float,
    pushing_objective_amplifier: float,
    pushes_limit: int,
    pushing_iteration_limit: int,
    init_policy: int,
    init_policy_random: float,
    float_type: int,
    storage_type: int,
    verbose: bool,
    device: DeviceLike,
) -> dict:
    from baryonyx_torch import solve as _solve, optimize as _optimize
    from baryonyx_torch.io.lp_parse import parse_lp

    ctx = make_context(6 if verbose else 3)
    p = ctx.parameters
    p.limit = limit
    p.theta = theta
    p.delta = delta
    p.pre_order = _pick(_PRE_ORDER, pre_constraint_order, PreConstraintOrder.memory)
    p.order = _pick(_ORDER, constraint_order, ConstraintOrder.none)
    p.kappa_min = kappa_min
    p.kappa_step = kappa_step
    p.kappa_max = kappa_max
    p.alpha = alpha
    p.w = w
    p.time_limit = time_limit
    if seed > 0:
        p.seed = seed
    p.thread = thread
    p.cost_norm = _pick(_NORM, norm, CostNormType.loo)
    p.pushing_k_factor = pushing_k_factor
    p.pushing_objective_amplifier = pushing_objective_amplifier
    p.pushes_limit = pushes_limit
    p.pushing_iteration_limit = pushing_iteration_limit
    p.init_policy = _pick(_INIT, init_policy, InitPolicyType.bastert)
    p.init_policy_random = init_policy_random
    p.float_type = _pick(_FLOAT, float_type, FloatType.float64)
    p.storage = _pick(_STORAGE, storage_type, StorageType.bound)

    t0 = time.monotonic()
    error = False
    try:
        with open(file_path) as fh:
            pb = parse_lp(fh.read())
        minimize = pb.type == ObjectiveType.minimize
        run = _optimize if optimize else _solve
        res = run(ctx, pb, device=device)
    except Exception as e:  # mirror the Rcpp catch-all (rbaryonyx.cpp:435-444)
        if verbose:
            print(f"Baryonyx error: {e}")
        return dict(
            solution_found=False,
            error_found=True,
            value=0.0,
            duration=time.monotonic() - t0,
            variables=0,
            constraints=0,
            remaining_constraints=-1,
            minimize=True,
            solutions=[],
        )

    found = res.status == ResultStatus.success and bool(res.solutions)
    return dict(
        solution_found=found,
        error_found=error,
        value=float(res.solutions[-1].value) if res.solutions else 0.0,
        duration=res.duration,
        variables=res.variables,
        constraints=res.constraints,
        remaining_constraints=res.remaining_constraints,
        minimize=minimize,
        solutions=[float(s.value) for s in res.solutions],
    )


def solve_01lp_problem(
    file_path: str,
    limit: int = 1000,
    theta: float = 0.5,
    delta: float = -1.0,
    pre_constraint_order: int = 1,
    constraint_order: int = 0,
    kappa_min: float = 0.0,
    kappa_step: float = 1.0e-3,
    kappa_max: float = 0.6,
    alpha: float = 1.0,
    w: float = 0.05,
    time_limit: float = 10.0,
    seed: int = -1,
    thread: int = 1,
    norm: int = 4,
    pushing_k_factor: float = 0.9,
    pushing_objective_amplifier: float = 5.0,
    pushes_limit: int = 100,
    pushing_iteration_limit: int = 50,
    init_policy: int = 0,
    init_policy_random: float = 0.5,
    float_type: int = 1,
    storage_type: int = 1,
    verbose: bool = True,
    device: DeviceLike = None,
) -> dict:
    """Find any feasible solution (reference: rbaryonyx.cpp:369-447)."""
    return _run(
        file_path, False, limit, theta, delta, pre_constraint_order,
        constraint_order, kappa_min, kappa_step, kappa_max, alpha, w,
        time_limit, seed, thread, norm, pushing_k_factor,
        pushing_objective_amplifier, pushes_limit, pushing_iteration_limit,
        init_policy, init_policy_random, float_type, storage_type, verbose,
        device,
    )


def optimize_01lp_problem(
    file_path: str,
    limit: int = 1000,
    theta: float = 0.5,
    delta: float = -1.0,
    pre_constraint_order: int = 1,
    constraint_order: int = 0,
    kappa_min: float = 0.0,
    kappa_step: float = 1.0e-3,
    kappa_max: float = 0.6,
    alpha: float = 1.0,
    w: float = 0.05,
    time_limit: float = 10.0,
    seed: int = -1,
    thread: int = 1,
    norm: int = 4,
    pushing_k_factor: float = 0.9,
    pushing_objective_amplifier: float = 5.0,
    pushes_limit: int = 100,
    pushing_iteration_limit: int = 50,
    init_policy: int = 0,
    init_policy_random: float = 0.5,
    float_type: int = 1,
    storage_type: int = 1,
    verbose: bool = True,
    device: DeviceLike = None,
) -> dict:
    """Multi-start optimize (reference: rbaryonyx.cpp:520-...)."""
    return _run(
        file_path, True, limit, theta, delta, pre_constraint_order,
        constraint_order, kappa_min, kappa_step, kappa_max, alpha, w,
        time_limit, seed, thread, norm, pushing_k_factor,
        pushing_objective_amplifier, pushes_limit, pushing_iteration_limit,
        init_policy, init_policy_random, float_type, storage_type, verbose,
        device,
    )
