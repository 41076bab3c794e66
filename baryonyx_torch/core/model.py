"""Problem data model.

Host-side (pure Python/numpy) representation of a 0-1 / small-integer linear
program, mirroring the reference's data model (reference:
lib/include/baryonyx/core:535-690 — variable_type, problem_solver_type,
objective_function_type, operator_type, constraint, objective_function,
raw_problem; lib/src/problem.hpp:43-122 — problem + which_problem_type).
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple


class VariableType(enum.Enum):
    """reference: core:535-540."""

    real = 0
    binary = 1
    general = 2


class ProblemSolverType(enum.Enum):
    """Constraint-shape classification selecting the kernel specialization
    (reference: core:542-549, classification in problem.hpp:97-122)."""

    equalities_01 = 0
    equalities_101 = 1
    equalities_Z = 2
    inequalities_01 = 3
    inequalities_101 = 4
    inequalities_Z = 5

    @property
    def has_inequalities(self) -> bool:
        return self in (
            ProblemSolverType.inequalities_01,
            ProblemSolverType.inequalities_101,
            ProblemSolverType.inequalities_Z,
        )


class ObjectiveType(enum.Enum):
    """reference: core:552-556 (objective_function_type)."""

    maximize = 0
    minimize = 1


class OperatorType(enum.Enum):
    """reference: core:558-563."""

    equal = 0
    greater = 1
    less = 2


INT_INF = 2**31 - 1  # stand-in for the reference's unbounded upper bound


@dataclass
class VariableValue:
    """Bounds + type of one variable (reference: core:565-579)."""

    min: int = 0
    max: int = INT_INF
    type: VariableType = VariableType.real


@dataclass
class Variables:
    """reference: core:581-585."""

    names: List[str] = field(default_factory=list)
    values: List[VariableValue] = field(default_factory=list)

    def __len__(self) -> int:
        return len(self.names)


@dataclass
class FunctionElement:
    """One `factor * x[variable_index]` term of a constraint LHS
    (reference: core:587-598). Factors are integers."""

    factor: int = 0
    variable_index: int = -1


@dataclass
class ObjectiveElement:
    """Linear objective term; factor is a double (reference: core:600-609)."""

    factor: float = 0.0
    variable_index: int = -1


@dataclass
class ObjectiveQuadraticTerm:
    """Quadratic objective term `factor * x_a * x_b`
    (reference: core:611-625)."""

    factor: float = 0.0
    variable_index_a: int = -1
    variable_index_b: int = -1


@dataclass
class Constraint:
    """LHS elements, RHS value and source id (reference: core:627-645)."""

    label: str = ""
    elements: List[FunctionElement] = field(default_factory=list)
    value: int = 0
    id: int = 0


@dataclass
class ObjectiveFunction:
    """Linear + quadratic terms + constant (reference: core:647-652)."""

    elements: List[ObjectiveElement] = field(default_factory=list)
    qelements: List[ObjectiveQuadraticTerm] = field(default_factory=list)
    value: float = 0.0


@dataclass
class AffectedVariables:
    """Variables fixed by the preprocessor (reference: core:657-664)."""

    names: List[str] = field(default_factory=list)
    values: List[int] = field(default_factory=list)

    def push_back(self, name: str, value: bool) -> None:
        self.names.append(name)
        self.values.append(int(value))

    def __len__(self) -> int:
        return len(self.names)


@dataclass
class DerivedVariables:
    """Variables eliminated by the product-fold preprocessor
    (preprocess/products.py): ``value(name) = value(a) * value(b)`` is
    reconstructed from the final solution at result-expansion time.

    No reference analogue — the reference only linearizes quadratics
    (preprocessor.cpp:289-331); this records the inverse transform."""

    names: List[str] = field(default_factory=list)
    parents_a: List[str] = field(default_factory=list)
    parents_b: List[str] = field(default_factory=list)

    def push_back(self, name: str, a: str, b: str) -> None:
        self.names.append(name)
        self.parents_a.append(a)
        self.parents_b.append(b)

    def __len__(self) -> int:
        return len(self.names)


@dataclass
class RawProblem:
    """Parsed-but-unprocessed problem (reference: core:666-690)."""

    objective: ObjectiveFunction = field(default_factory=ObjectiveFunction)
    equal_constraints: List[Constraint] = field(default_factory=list)
    greater_constraints: List[Constraint] = field(default_factory=list)
    less_constraints: List[Constraint] = field(default_factory=list)
    vars: Variables = field(default_factory=Variables)
    type: ObjectiveType = ObjectiveType.maximize

    @property
    def n_variables(self) -> int:
        return len(self.vars)

    @property
    def n_constraints(self) -> int:
        return (
            len(self.equal_constraints)
            + len(self.greater_constraints)
            + len(self.less_constraints)
        )

    def all_constraints(self) -> List[Tuple[OperatorType, Constraint]]:
        out: List[Tuple[OperatorType, Constraint]] = []
        for cst in self.equal_constraints:
            out.append((OperatorType.equal, cst))
        for cst in self.greater_constraints:
            out.append((OperatorType.greater, cst))
        for cst in self.less_constraints:
            out.append((OperatorType.less, cst))
        return out

    def variable_index(self, name: str) -> int:
        try:
            return self.vars.names.index(name)
        except ValueError:
            return -1


def _coefficient_type(constraints: List[Constraint], current: int) -> int:
    """Widen coefficient domain: 0 = {0,1}, 1 = {-1,0,1}, 2 = Z
    (reference: problem.hpp:71-95)."""
    for cst in constraints:
        for elem in cst.elements:
            f = elem.factor
            if f in (0, 1):
                continue
            elif f == -1:
                current = max(current, 1)
            else:
                return 2
    return current


def which_problem_type(pb: "Problem") -> ProblemSolverType:
    """Classify constraint shape (reference: problem.hpp:97-122)."""
    coeff = 0
    coeff = _coefficient_type(pb.equal_constraints, coeff)
    coeff = _coefficient_type(pb.greater_constraints, coeff)
    coeff = _coefficient_type(pb.less_constraints, coeff)

    has_ineq = bool(pb.greater_constraints) or bool(pb.less_constraints)
    table = {
        (False, 0): ProblemSolverType.equalities_01,
        (False, 1): ProblemSolverType.equalities_101,
        (False, 2): ProblemSolverType.equalities_Z,
        (True, 0): ProblemSolverType.inequalities_01,
        (True, 1): ProblemSolverType.inequalities_101,
        (True, 2): ProblemSolverType.inequalities_Z,
    }
    return table[(has_ineq, coeff)]


@dataclass
class Problem(RawProblem):
    """Preprocessed problem: compacted variables + bookkeeping of fixed
    variables (reference: problem.hpp:43-69)."""

    problem_type: ProblemSolverType = ProblemSolverType.equalities_01
    affected_vars: AffectedVariables = field(default_factory=AffectedVariables)
    derived_vars: DerivedVariables = field(default_factory=DerivedVariables)

    @classmethod
    def from_raw(cls, raw: RawProblem) -> "Problem":
        pb = cls(
            objective=raw.objective,
            equal_constraints=raw.equal_constraints,
            greater_constraints=raw.greater_constraints,
            less_constraints=raw.less_constraints,
            vars=raw.vars,
            type=raw.type,
        )
        pb.problem_type = which_problem_type(pb)
        return pb
