"""Solution validation and objective evaluation — the pure-numpy oracle.

reference: lib/src/lpcore.cpp:134-257 (compute_function,
is_valid_solution, compute_solution, make_variable_value) and
lib/include/baryonyx/core-utils:41-61 (compute_min_max_objective_function).
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

from baryonyx_torch.core.model import ObjectiveFunction, RawProblem
from baryonyx_torch.core.result import Result


def compute_function(elements, values: Sequence[int]) -> int:
    """LHS value of one constraint (reference: lpcore.cpp:134-152)."""
    return sum(el.factor * values[el.variable_index] for el in elements)


def make_variable_value(pb: RawProblem, r: Result) -> List[int]:
    """Map a result (solved variables + preprocessor-fixed variables) back
    onto the raw problem's variable order by name
    (reference: lpcore.cpp:203-231)."""
    if not r or not r.solutions:
        return []
    cache: Dict[str, int] = {}
    for name, value in zip(r.affected_vars.names, r.affected_vars.values):
        cache[name] = int(bool(value))
    for name, value in zip(r.variable_name, r.solutions[-1].variables):
        cache[name] = int(bool(value))
    # product-folded variables: value = parent_a * parent_b
    # (preprocess/products.py; parents are always kept or affected vars)
    for name, a, b in zip(
        r.derived_vars.names, r.derived_vars.parents_a, r.derived_vars.parents_b
    ):
        cache[name] = cache.get(a, 0) * cache.get(b, 0)
    return [cache[name] for name in pb.vars.names]


def is_valid_solution_values(pb: RawProblem, values: Sequence[int]) -> bool:
    """reference: lpcore.cpp:154-183."""
    for cst in pb.equal_constraints:
        if compute_function(cst.elements, values) != cst.value:
            return False
    for cst in pb.less_constraints:
        if compute_function(cst.elements, values) > cst.value:
            return False
    for cst in pb.greater_constraints:
        if compute_function(cst.elements, values) < cst.value:
            return False
    return True


def compute_solution_values(pb: RawProblem, values: Sequence[int]) -> float:
    """reference: lpcore.cpp:185-201."""
    ret = pb.objective.value
    for el in pb.objective.elements:
        ret += el.factor * values[el.variable_index]
    for el in pb.objective.qelements:
        ret += el.factor * values[el.variable_index_a] * values[el.variable_index_b]
    return ret


def is_valid_solution(pb: RawProblem, r: Result) -> bool:
    """reference: lpcore.cpp:233-245."""
    if not r or not r.solutions:
        return False
    return is_valid_solution_values(pb, make_variable_value(pb, r))


def compute_solution(pb: RawProblem, r: Result) -> float:
    """reference: lpcore.cpp:247-257."""
    return compute_solution_values(pb, make_variable_value(pb, r))


def compute_min_max_objective_function(obj: ObjectiveFunction) -> Tuple[float, float]:
    """reference: core-utils:41-61."""
    lo = hi = obj.value
    for el in obj.elements:
        if el.factor < 0:
            lo += el.factor
        else:
            hi += el.factor
    for el in obj.qelements:
        if el.factor < 0:
            lo += el.factor
        else:
            hi += el.factor
    return lo, hi
