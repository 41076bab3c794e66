"""Pretty-printing of parameters, enums and results.

Mirrors the reference's fmt formatters (reference:
lib/include/baryonyx/core-out:30-480) and the CLI's solver-started /
solver-finished callbacks (reference: app/src/main.cpp:64-238), so the
start-callback parameter echo and result lines read identically.
"""

from __future__ import annotations

from baryonyx_torch.core.params import (
    ConstraintOrder,
    CostNormType,
    FloatType,
    InitPolicyType,
    ModeType,
    ObserverType,
    PreConstraintOrder,
    PreprocessorOptions,
    SolverParameters,
    SolverType,
    StorageType,
)
from baryonyx_torch.core.result import Result, ResultStatus

# enum -> reference display string (core-out:160-480)
PRE_ORDER_NAMES = {
    PreConstraintOrder.none: "none",
    PreConstraintOrder.memory: "memory",
    PreConstraintOrder.less_greater_equal: "less-greater-equal",
    PreConstraintOrder.less_equal_greater: "less-equal-greater",
    PreConstraintOrder.greater_less_equal: "greater-less-equal",
    PreConstraintOrder.greater_equal_less: "greater-equal-less",
    PreConstraintOrder.equal_less_greater: "equal-less-greater",
    PreConstraintOrder.equal_greater_less: "equal-greater-less",
    PreConstraintOrder.p1: "p1",
    PreConstraintOrder.p2: "p2",
    PreConstraintOrder.p3: "p3",
    PreConstraintOrder.p4: "p4",
}
INIT_POLICY_NAMES = {
    InitPolicyType.bastert: "bastert",
    InitPolicyType.pessimistic_solve: "pessimistic-solve",
    InitPolicyType.optimistic_solve: "optimistic-solve",
}
FLOAT_NAMES = {
    FloatType.float32: "float",
    FloatType.float64: "double",
}
ORDER_NAMES = {
    ConstraintOrder.none: "none",
    ConstraintOrder.reversing: "reversing",
    ConstraintOrder.random_sorting: "random-sorting",
    ConstraintOrder.infeasibility_decr: "infeasibility-decr",
    ConstraintOrder.infeasibility_incr: "infeasibility-incr",
    ConstraintOrder.lagrangian_decr: "lagrangian-decr",
    ConstraintOrder.lagrangian_incr: "lagrangian-incr",
    ConstraintOrder.pi_sign_change: "pi-sign-change",
    ConstraintOrder.cycle: "cycle",
}
NORM_NAMES = {
    CostNormType.none: "none",
    CostNormType.random: "random",
    CostNormType.l1: "l1",
    CostNormType.l2: "l2",
    CostNormType.loo: "loo",
}
PREPROCESSOR_NAMES = {
    PreprocessorOptions.none: "none",
    PreprocessorOptions.all: "all",
}
OBSERVER_NAMES = {
    ObserverType.none: "none",
    ObserverType.pnm: "pnm",
    ObserverType.file: "file",
}
SOLVER_NAMES = {
    SolverType.bastert: "bastert",
    SolverType.random: "random",
}
STORAGE_NAMES = {
    StorageType.one: "one",
    StorageType.bound: "bound",
    StorageType.five: "five",
}


def mode_name(mode: ModeType) -> str:
    """core-out:348-380 (mode_type bit combinations)."""
    has_branch = bool(mode & ModeType.branch)
    if mode & ModeType.manual:
        return "manual-and-branch" if has_branch else "manual"
    if mode & ModeType.nlopt:
        return "nlopt-and-branch" if has_branch else "nlopt"
    if has_branch:
        return "branch"
    return "disabled"


def _g(v: float) -> str:
    """fmt's {:.10g}."""
    return f"{float(v):.10g}"


def format_parameters(params: SolverParameters) -> str:
    """The solver-started parameter echo (reference: main.cpp:64-238)."""
    out = ["Solver starts\n"]
    out.append(
        " * Global parameters:\n"
        f"  - limit: {params.limit}\n"
        f"  - time-limit: {_g(params.time_limit)}s\n"
        f"  - floating-point-type: {FLOAT_NAMES[params.float_type]}\n"
        f"  - print-level: {params.print_level}\n"
        f"  - auto-tune: {mode_name(params.mode)}\n"
        f"  - observation: {OBSERVER_NAMES[params.observer]}\n"
    )
    if params.solver == SolverType.bastert:
        out.append(
            " * In The Middle parameters:\n"
            f"  - preprocessing: {PRE_ORDER_NAMES[params.pre_order]}\n"
            f"  - constraint-order: {ORDER_NAMES[params.order]}\n"
            f"  - theta: {_g(params.theta)}\n"
            f"  - delta: {_g(params.delta)}\n"
            f"  - kappa: {_g(params.kappa_min)} {_g(params.kappa_step)} "
            f"{_g(params.kappa_max)}\n"
            f"  - alpha: {_g(params.alpha)}\n"
            f"  - w: {_g(params.w)}\n"
            f"  - norm: {NORM_NAMES[params.cost_norm]}\n"
        )
        out.append(
            " * Pushes system parameters:\n"
            f"  - pushes-limit: {params.pushes_limit}\n"
            f"  - pushing-objective-amplifier: "
            f"{_g(params.pushing_objective_amplifier)}\n"
            f"  - pushing-iteration-limit: {params.pushing_iteration_limit}\n"
            f"  - pushing-k-factor: {_g(params.pushing_k_factor)}\n"
        )
        out.append(
            " * Solver initialization parameters:\n"
            f"  - init-policy: {INIT_POLICY_NAMES[params.init_policy]}\n"
            f"  - init-policy-random: {params.init_policy_random}\n"
        )
        out.append(
            " * Optimizer initialization parameters:\n"
            f"  - init-population-size: {params.init_population_size}\n"
            f"  - init-crossover-bastert-insertion: "
            f"{params.init_crossover_bastert_insertion}\n"
            f"  - init-crossover-solution-selection-mean: "
            f"{params.init_crossover_solution_selection_mean}\n"
            f"  - init-crossover-solution-selection-stddev: "
            f"{params.init_crossover_solution_selection_stddev}\n"
            f"  - init-mutation-variable-mean: "
            f"{params.init_mutation_variable_mean}\n"
            f"  - init-mutation-variable-stddev: "
            f"{params.init_mutation_variable_stddev}\n"
            f"  - init-mutation-value-mean: {params.init_mutation_value_mean}\n"
            f"  - init-mutation-value-stddev: "
            f"{params.init_mutation_value_stddev}\n"
            f"  - init-kappa-improve-start: "
            f"{params.init_kappa_improve_start}\n"
            f"  - init-kappa-improve-increase: "
            f"{params.init_kappa_improve_increase}\n"
            f"  - init-kappa-improve-stop: {params.init_kappa_improve_stop}\n"
        )
    else:
        out.append(" * Random solver parameters: none\n")
    return "".join(out)


def format_result_line(r: Result) -> str:
    """The solver-finished line (reference: main.cpp:140-238)."""
    if r.status == ResultStatus.success:
        if not r.solutions:
            return "No solution.\n"
        best = r.solutions[-1]
        if not best.variables:
            return (
                f"Best solution found via preprocessor: {_g(best.value)} "
                f"in {r.duration}s\n"
            )
        if r.loop >= 0:
            return (
                f"Best solution found: {_g(best.value)} in {r.loop} loop "
                f"and {r.duration}s\n"
            )
        return (
            f"Best solution found via push: {_g(best.value)} in {-r.loop} "
            f"loop and {r.duration}s\n"
        )
    if r.status == ResultStatus.internal_error:
        return "No solution. Internal error\n"
    if r.status == ResultStatus.uninitialized:
        return "No solution. Uninitialized error\n"
    if r.status == ResultStatus.kappa_max_reached:
        return (
            f"No solution. Constraint remaining: {r.remaining_constraints}. "
            f"Kappa reached in {r.duration}s.\n"
        )
    if r.status == ResultStatus.time_limit_reached:
        return (
            f"No solution. Constraint remaining: {r.remaining_constraints}. "
            f"Time limit reached at {r.duration}s.\n"
        )
    if r.status == ResultStatus.limit_reached:
        return (
            f"No solution. Constraint remaining: {r.remaining_constraints}. "
            f"Loop limit reached in {r.duration}s.\n"
        )
    return "Context uninitialized\n"
