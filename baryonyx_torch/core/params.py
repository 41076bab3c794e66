"""Solver parameters: the whole configuration surface.

Mirrors the reference's ``solver_parameters`` struct and its enums
(reference: lib/include/baryonyx/core:294-462) as a Python dataclass.
Validation/clamping mirrors ``context_set_solver_parameters``
(reference: lib/src/private.cpp:50-172).
"""

from __future__ import annotations

import dataclasses
import enum
from dataclasses import dataclass


class PreConstraintOrder(enum.Enum):
    """Static constraint/variable pre-ordering (reference: core:297-332)."""

    none = 0
    memory = 1
    less_greater_equal = 2
    less_equal_greater = 3
    greater_less_equal = 4
    greater_equal_less = 5
    equal_less_greater = 6
    equal_greater_less = 7
    p1 = 8
    p2 = 9
    p3 = 10
    p4 = 11


class InitPolicyType(enum.Enum):
    """reference: core:334-339."""

    bastert = 0
    pessimistic_solve = 1
    optimistic_solve = 2


class FloatType(enum.Enum):
    """Solver arithmetic precision (reference: core:341-346).

    The reference offers float/double/long-double; here float32 is the
    fast path (the hand-written kernels are float32) and float64 runs
    through the general sweep.
    """

    float32 = 0
    float64 = 1


class ConstraintOrder(enum.Enum):
    """Per-sweep constraint scheduling policy (reference: core:348-359,
    semantics in itm-common.hpp:627-915)."""

    none = 0
    reversing = 1
    random_sorting = 2
    infeasibility_decr = 3
    infeasibility_incr = 4
    lagrangian_decr = 5
    lagrangian_incr = 6
    pi_sign_change = 7
    cycle = 8


class CostNormType(enum.Enum):
    """Objective normalization (reference: core:361-368)."""

    none = 0
    random = 1
    l1 = 2
    l2 = 3
    loo = 4


class ModeType(enum.IntFlag):
    """Meta-optimizer selection bitflags (reference: core:370-376)."""

    none = 0
    manual = 1
    nlopt = 2
    branch = 4


class PreprocessorOptions(enum.Enum):
    """reference: core:381-385."""

    none = 0
    all = 1


class ObserverType(enum.Enum):
    """P/pi trace dumps in solve mode (reference: core:387-392)."""

    none = 0
    pnm = 1
    file = 2


class SolverType(enum.Enum):
    """Bastert (Wedelin) vs random baseline solver (reference: core:394-398)."""

    bastert = 0
    random = 1


class StorageType(enum.Enum):
    """How many solutions the optimizer returns (reference: core:400-408)."""

    one = 0
    bound = 1
    five = 2


@dataclass
class SolverParameters:
    """All tunables; defaults match the reference (core:410-461)."""

    time_limit: float = -1.0  # <= 0 means no time limit
    theta: float = 0.5
    delta: float = -1.0  # -1 means automatic
    kappa_min: float = 0.0
    kappa_step: float = 1e-3
    kappa_max: float = 0.6
    alpha: float = 1.0
    pushing_k_factor: float = 0.9
    pushing_objective_amplifier: float = 5.0
    init_policy_random: float = 0.5

    init_crossover_bastert_insertion: float = 0.01
    init_crossover_solution_selection_mean: float = 0.0
    init_crossover_solution_selection_stddev: float = 0.3
    init_mutation_variable_mean: float = 0.0001
    init_mutation_variable_stddev: float = 0.001
    init_mutation_value_mean: float = 0.5
    init_mutation_value_stddev: float = 0.2
    init_kappa_improve_start: float = 0.0
    init_kappa_improve_increase: float = 0.02
    init_kappa_improve_stop: float = 0.2

    w: float = 0.05  # warmup: fraction of `limit` when in [0,1]
    seed: int = 0  # 0 means automatic
    thread: int = 0  # <=0: auto; otherwise the number of replicas
    limit: int = 1000  # <=0 means unbounded loop
    print_level: int = 0
    pushes_limit: int = 100
    pushing_iteration_limit: int = 50
    init_population_size: int = 100

    pre_order: PreConstraintOrder = PreConstraintOrder.none
    order: ConstraintOrder = ConstraintOrder.none
    float_type: FloatType = FloatType.float32
    init_policy: InitPolicyType = InitPolicyType.bastert
    cost_norm: CostNormType = CostNormType.loo
    mode: ModeType = ModeType.none
    preprocessor: PreprocessorOptions = PreprocessorOptions.all
    observer: ObserverType = ObserverType.none
    storage: StorageType = StorageType.one
    solver: SolverType = SolverType.bastert
    debug: bool = False

    # --- device-specific knobs (no reference equivalent) -------------------
    # Rows per Gauss-Seidel block inside one sweep: 1 reproduces the
    # reference's strictly sequential row updates; larger blocks trade
    # per-row sequencing for parallel width (SURVEY.md section 7).
    block_size: int = 8
    # Iterations executed per device dispatch before the host checks
    # time limit / callbacks (replaces the reference's 1 Hz polling thread,
    # reference: itm-optimizer-common.hpp:836-857).
    chunk_size: int = 50
    # Optimize-mode preemption recovery (no reference equivalent — flagged
    # as new device-native scope in SURVEY.md section 5): population saved to
    # this .npz path every checkpoint_every seconds and restored on start.
    checkpoint_path: str = ""
    checkpoint_every: float = 30.0

    def validated(self, limit_for_w: int | None = None) -> "SolverParameters":
        """Return a clamped copy (reference: private.cpp:50-172).

        Out-of-range values are reset to defaults or clamped exactly as the
        reference does; ``w`` in [0,1] converts to a fraction of ``limit``
        (reference: private.cpp:126-139).
        """
        d = SolverParameters()
        p = dataclasses.replace(self)

        def in_range(v, lo, hi):
            return lo <= v <= hi

        if not in_range(p.theta, 0.0, 1.0):
            p.theta = d.theta
        if p.delta != -1.0 and p.delta < 0:
            p.delta = d.delta
        if p.kappa_min < 0 or not (p.kappa_min < p.kappa_max <= 1.0):
            p.kappa_min, p.kappa_max = d.kappa_min, d.kappa_max
        if not (0 < p.kappa_step < 1.0):
            p.kappa_step = d.kappa_step
        if p.alpha < 0:
            p.alpha = d.alpha
        if p.pushing_k_factor < 0:
            p.pushing_k_factor = d.pushing_k_factor
        if p.pushing_objective_amplifier < 0:
            p.pushing_objective_amplifier = d.pushing_objective_amplifier
        if not in_range(p.init_policy_random, 0.0, 1.0):
            p.init_policy_random = d.init_policy_random
        if p.limit < 0:
            p.limit = 2**31 - 1  # "infinity" loop bound
        if 0.0 <= p.w <= 1.0:
            lim = limit_for_w if limit_for_w is not None else p.limit
            p.w = p.w * lim
        if p.pushes_limit < 0:
            p.pushes_limit = 0
        if p.pushing_iteration_limit < 0:
            p.pushing_iteration_limit = 0
        if p.init_population_size < 5:
            p.init_population_size = d.init_population_size
        if p.block_size < 1:
            p.block_size = d.block_size
        if p.chunk_size < 1:
            p.chunk_size = d.chunk_size
        return p
