"""Result model (reference: lib/include/baryonyx/core:692-748)."""

from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from baryonyx_torch.core.model import AffectedVariables, DerivedVariables


class ResultStatus(enum.Enum):
    """reference: core:692-701."""

    success = 0
    internal_error = 1
    uninitialized = 2
    kappa_max_reached = 3
    time_limit_reached = 4
    limit_reached = 5
    empty_context = 6


@dataclass
class Solution:
    """One feasible assignment + objective value (reference: core:703-714)."""

    variables: List[int] = field(default_factory=list)
    value: float = 0.0


@dataclass
class Result:
    """Solver output (reference: core:716-748)."""

    method: str = ""
    variable_name: List[str] = field(default_factory=list)
    affected_vars: AffectedVariables = field(default_factory=AffectedVariables)
    derived_vars: DerivedVariables = field(default_factory=DerivedVariables)
    solutions: List[Solution] = field(default_factory=list)

    duration: float = 0.0
    loop: int = 0
    variables: int = 0
    constraints: int = 0
    remaining_constraints: int = 2**31 - 1
    annoying_variable: int = 0
    status: ResultStatus = ResultStatus.uninitialized
    # the replica batch and row block the optimizer ran with (0 when the
    # sweep never ran, e.g. exact enumeration)
    replicas: int = 0
    block_size: int = 0
    # sweeps of the main loop and the push rounds that solve mode ran
    # (``loop`` is the sweep that found the best solution)
    sweeps: int = 0
    # optimize with per-replica hyperparameters (``hp_vectors``): each
    # replica's lifetime best feasible score, minimize-oriented, float64[R]
    # (+inf where it found none); the meta-optimizers score combos by it
    replica_best_values: Optional[object] = None

    def __bool__(self) -> bool:
        return self.status == ResultStatus.success

    @property
    def value(self) -> float:
        """Objective of the best stored solution (last entry, matching the
        reference's ordering where solutions.back() is the best)."""
        if not self.solutions:
            raise ValueError("no solution stored")
        return self.solutions[-1].value

    @property
    def best(self) -> Solution:
        if not self.solutions:
            raise ValueError("no solution stored")
        return self.solutions[-1]

    def solution_map(self) -> Dict[str, int]:
        """Variable name -> 0/1 value of the best solution, including
        preprocessor-fixed variables."""
        out = dict(zip(self.variable_name, self.best.variables))
        out.update(
            {n: int(v) for n, v in zip(self.affected_vars.names, self.affected_vars.values)}
        )
        for n, a, b in zip(
            self.derived_vars.names,
            self.derived_vars.parents_a,
            self.derived_vars.parents_b,
        ):
            out[n] = int(bool(out.get(a, 0))) * int(bool(out.get(b, 0)))
        return out
