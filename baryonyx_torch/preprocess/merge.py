"""Constraint merging and pre-ordering.

Constraints with identical LHS element vectors collapse into one
``MergedConstraint`` with a [min, max] RHS interval (reference:
lib/src/merged-constraint.cpp:57-128):

- ``=  v``  -> [v, v] (conflicting equalities raise, :81-89)
- ``<= v``  -> [-inf, v], repeated: max tightened by min()
- ``>= v``  -> [v, +inf], repeated: min tightened by max()

The cache is shared across operator types, so an equality can tighten a
previously-seen inequality with the same LHS. Orderings mirror
``make_merged_constraints`` (reference: :297-343): none / memory /
6 type-order permutations / p1..p4 cost-ratio sorts.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Tuple

from baryonyx_torch.core.context import Context
from baryonyx_torch.core.errors import ProblemDefinitionError
from baryonyx_torch.core.model import Constraint, FunctionElement, OperatorType, Problem
from baryonyx_torch.core.params import PreConstraintOrder

_INT_MIN = -(2**31)
_INT_MAX = 2**31 - 1


@dataclass
class MergedConstraint:
    """reference: itm-common.hpp:55-71."""

    elements: List[FunctionElement]
    min: int
    max: int
    id: int


def _key(elements: List[FunctionElement]) -> Tuple[Tuple[int, int], ...]:
    return tuple((e.factor, e.variable_index) for e in elements)


def _fill(
    cache: Dict[Tuple, int],
    op: OperatorType,
    constraints: List[Constraint],
    ret: List[MergedConstraint],
) -> None:
    """reference: merged-constraint.cpp:57-128."""
    for cst in constraints:
        k = _key(cst.elements)
        idx = cache.get(k)
        if op == OperatorType.equal:
            if idx is None:
                cache[k] = len(ret)
                ret.append(MergedConstraint(cst.elements, cst.value, cst.value, cst.id))
            else:
                if ret[idx].min <= cst.value <= ret[idx].max:
                    ret[idx].min = ret[idx].max = cst.value
                else:
                    raise ProblemDefinitionError(
                        "equal", f"constraint {cst.id} inconsistent with {ret[idx].id}"
                    )
        elif op == OperatorType.less:
            if idx is None:
                cache[k] = len(ret)
                ret.append(MergedConstraint(cst.elements, _INT_MIN, cst.value, cst.id))
            else:
                ret[idx].max = min(ret[idx].max, cst.value)
        elif op == OperatorType.greater:
            if idx is None:
                cache[k] = len(ret)
                ret.append(MergedConstraint(cst.elements, cst.value, _INT_MAX, cst.id))
            else:
                ret[idx].min = max(ret[idx].min, cst.value)


def _make_unsorted(pb: Problem) -> List[MergedConstraint]:
    """Fill eq, less, greater then restore raw-problem order by id
    (reference: merged-constraint.cpp:133-158)."""
    cache: Dict[Tuple, int] = {}
    ret: List[MergedConstraint] = []
    _fill(cache, OperatorType.equal, pb.equal_constraints, ret)
    _fill(cache, OperatorType.less, pb.less_constraints, ret)
    _fill(cache, OperatorType.greater, pb.greater_constraints, ret)
    ret.sort(key=lambda c: c.id)
    return ret


_TYPE_ORDERS = {
    PreConstraintOrder.less_greater_equal: ("less", "greater", "equal"),
    PreConstraintOrder.less_equal_greater: ("less", "equal", "greater"),
    PreConstraintOrder.greater_less_equal: ("greater", "less", "equal"),
    PreConstraintOrder.greater_equal_less: ("greater", "equal", "less"),
    PreConstraintOrder.equal_less_greater: ("equal", "less", "greater"),
    PreConstraintOrder.equal_greater_less: ("equal", "greater", "less"),
}


def _make_ordered(pb: Problem, pre_order: PreConstraintOrder) -> List[MergedConstraint]:
    """reference: merged-constraint.cpp:163-216."""
    cache: Dict[Tuple, int] = {}
    ret: List[MergedConstraint] = []
    lists = {
        "equal": (OperatorType.equal, pb.equal_constraints),
        "less": (OperatorType.less, pb.less_constraints),
        "greater": (OperatorType.greater, pb.greater_constraints),
    }
    for name in _TYPE_ORDERS[pre_order]:
        op, constraints = lists[name]
        _fill(cache, op, constraints, ret)
    return ret


def _make_special(pb: Problem, pre_order: PreConstraintOrder) -> List[MergedConstraint]:
    """p1..p4 cost-ratio orderings (reference: merged-constraint.cpp:223-284):
    per-variable cost / constraint-degree ratio, constraints sorted by their
    min ratio (p1 descending, p2..p4 ascending), elements sorted by ratio."""
    csts = _make_unsorted(pb)
    n = len(pb.vars.values)
    degree = [0] * n
    for cst in csts:
        for el in cst.elements:
            degree[el.variable_index] += 1
    cost = [0.0] * n
    for el in pb.objective.elements:
        if degree[el.variable_index]:
            cost[el.variable_index] = el.factor / degree[el.variable_index]

    ratio = [
        (i, min(cost[el.variable_index] for el in cst.elements))
        for i, cst in enumerate(csts)
    ]
    reverse = pre_order == PreConstraintOrder.p1
    ratio.sort(key=lambda t: t[1], reverse=reverse)

    # The reference re-ids then re-sorts by the permuted id, which applies
    # the inverse permutation to the constraint list
    # (merged-constraint.cpp:268-276).
    for i, cst in enumerate(csts):
        cst.id = ratio[i][0]
    csts.sort(key=lambda c: c.id)

    for cst in csts:
        cst.elements = sorted(
            cst.elements, key=lambda el: cost[el.variable_index], reverse=True
        )
    return csts


def _improve_memory_usage(csts: List[MergedConstraint]) -> None:
    """Sort elements by variable index (reference: merged-constraint.cpp:286-295)."""
    for cst in csts:
        cst.elements = sorted(cst.elements, key=lambda el: el.variable_index)


def make_merged_constraints(ctx: Context, pb: Problem) -> List[MergedConstraint]:
    """reference: merged-constraint.cpp:297-343."""
    pre = ctx.parameters.pre_order
    if pre == PreConstraintOrder.none:
        ret = _make_unsorted(pb)
    elif pre == PreConstraintOrder.memory:
        ret = _make_unsorted(pb)
        _improve_memory_usage(ret)
    elif pre in _TYPE_ORDERS:
        ret = _make_ordered(pb, pre)
        _improve_memory_usage(ret)
    else:
        ret = _make_special(pb, pre)

    original = pb.n_constraints
    ctx.info("  - merged constraints removed: {}\n", original - len(ret))
    return ret
