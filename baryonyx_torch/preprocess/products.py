"""Product-fold preprocessor: recognize linearized quadratic terms and
fold them back into a quadratic objective.

Many 0-1 encodings (QAP, BQP linearizations a la Glover/RLT — e.g. the
reference's own ``lib/test/small4.lp``) introduce product variables
``y_kl = u_k * v_l`` through "marginal grids":

    row A_k:  sum_l y_kl - u_k = 0          (one row per k)
    row B_l:  sum_k y_kl - v_l = 0          (one row per l)
    one-hot:  sum_k u_k = 1,  sum_l v_l = 1

Given the one-hot equalities, the grid rows force ``y = u (outer) v``:
exactly one y is 1, at the (k*, l*) where u_k* = v_l* = 1. The y block is
therefore *redundant state* — every feasible (u, v) extends uniquely, and
the y objective contribution equals ``sum_kl c_kl u_k v_l``. Folding the
block away turns the linearization back into its natural quadratic form:
for small4 a 272-var / 136-row eq-101 problem collapses to the 16-var /
8-row assignment polytope with quadratic costs, which the Wedelin kernel
solves to optimality in milliseconds where neither this solver nor the
reference binary can stitch the y grid back together by dual descent
(reference stuck at 4 remaining after 120 s on a 2-core host; see
ACCEPTANCE artifacts).

Validity conditions checked (all must hold, else the component is left
untouched — the transform is exact, never heuristic):
  - link rows are equalities with value 0, exactly one factor -1 (the
    parent) and >= 1 factors +1 (the children), nothing else;
  - every child is binary, appears in exactly two constraints (its A row
    and its B row, factor +1 in both) and in no quadratic objective term;
  - the component's rows 2-color into sides A/B and every (A,B) pair
    shares exactly one child (complete bipartite grid, |Y| = K*L);
  - each side's parent multiset is distinct variables, and some equality
    constraint has *exactly* that variable set, all factors +1, value 1
    (the one-hot row — guarantees the marginals sum to 1, which is what
    makes y = outer(u, v) forced rather than merely feasible).

The eliminated variables are recorded in ``Problem.derived_vars`` and
reconstructed at result-expansion time (validate.make_variable_value).

No reference analogue: the reference's preprocessor only goes the other
direction (make_lp_from_bqp_objective, preprocessor.cpp:289-331).
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, FrozenSet, List, Optional, Set, Tuple

from baryonyx_torch.core.context import Context
from baryonyx_torch.core.model import (
    Constraint,
    FunctionElement,
    ObjectiveElement,
    ObjectiveFunction,
    ObjectiveQuadraticTerm,
    Problem,
    VariableType,
    which_problem_type,
)


class _LinkRow(object):
    __slots__ = ("kind", "index", "parent", "children")

    def __init__(self, kind: str, index: int, parent: int, children: Tuple[int, ...]):
        self.kind = kind
        self.index = index
        self.parent = parent
        self.children = children


def _binary(pb: Problem, j: int) -> bool:
    vv = pb.vars.values[j]
    return vv.min == 0 and vv.max == 1


def fold_linearized_products(ctx: Context, pb: Problem) -> Problem:
    """Detect and fold marginal-grid product linearizations; returns a new
    compacted Problem (or ``pb`` unchanged when nothing matches)."""
    n = len(pb.vars.values)
    if n == 0:
        return pb

    # occurrence map: var -> [(kind, row index, factor)]
    occ: Dict[int, List[Tuple[str, int, int]]] = defaultdict(list)
    lists = {
        "equal": pb.equal_constraints,
        "greater": pb.greater_constraints,
        "less": pb.less_constraints,
    }
    for kind, constraints in lists.items():
        for i, cst in enumerate(constraints):
            for el in cst.elements:
                occ[el.variable_index].append((kind, i, el.factor))

    # quadratic-objective participation disqualifies a child
    in_quad: Set[int] = set()
    for q in pb.objective.qelements:
        in_quad.add(q.variable_index_a)
        in_quad.add(q.variable_index_b)

    # 1. candidate link rows: equal, value 0, exactly one -1, rest +1
    links: List[_LinkRow] = []
    for i, cst in enumerate(pb.equal_constraints):
        if cst.value != 0 or len(cst.elements) < 2:
            continue
        parent = -1
        children: List[int] = []
        ok = True
        for el in cst.elements:
            if el.factor == -1:
                if parent >= 0:
                    ok = False
                    break
                parent = el.variable_index
            elif el.factor == 1:
                children.append(el.variable_index)
            else:
                ok = False
                break
        if ok and parent >= 0 and children:
            links.append(_LinkRow("equal", i, parent, tuple(children)))

    if not links:
        return pb

    # 2. qualify children: binary, exactly two constraint occurrences,
    #    both +1 in link rows, never a parent, no quadratic terms
    link_of_row: Dict[int, _LinkRow] = {lr.index: lr for lr in links}
    parent_vars = {lr.parent for lr in links}
    child_rows: Dict[int, List[_LinkRow]] = {}
    for lr in links:
        for c in lr.children:
            child_rows.setdefault(c, []).append(lr)

    def child_ok(c: int) -> bool:
        if c in parent_vars or c in in_quad or not _binary(pb, c):
            return False
        rows = child_rows.get(c, [])
        if len(rows) != 2 or rows[0] is rows[1]:
            return False
        o = occ[c]
        if len(o) != 2:
            return False
        return all(
            kind == "equal" and idx in link_of_row and f == 1 for kind, idx, f in o
        )

    good_children = {c for c in child_rows if child_ok(c)}
    if not good_children:
        return pb

    # rows whose ENTIRE childset qualifies
    good_rows = [
        lr for lr in links if all(c in good_children for c in lr.children)
    ]
    row_ok = {lr.index for lr in good_rows}
    # children must have both their rows good
    def fully_good(c: int) -> bool:
        return all(lr.index in row_ok for lr in child_rows[c])

    # 3. one-hot lookup: frozenset(vars) -> exists equality, all +1, value 1
    onehots: Set[FrozenSet[int]] = set()
    for cst in pb.equal_constraints:
        if cst.value == 1 and all(el.factor == 1 for el in cst.elements):
            onehots.add(frozenset(el.variable_index for el in cst.elements))

    # 4. connected components over good rows via shared children
    adj: Dict[int, Set[int]] = defaultdict(set)  # row index -> row indices
    for c in good_children:
        if not fully_good(c):
            continue
        a, b = child_rows[c]
        adj[a.index].add(b.index)
        adj[b.index].add(a.index)

    seen: Set[int] = set()
    drop_rows: Set[int] = set()
    drop_vars: Set[int] = set()
    new_q: List[ObjectiveQuadraticTerm] = []  # (factor, u, v) in OLD indices
    new_lin: Dict[int, float] = defaultdict(float)
    derived: List[Tuple[int, int, int]] = []  # (child, u, v) old indices
    cost_of = {el.variable_index: el.factor for el in pb.objective.elements}

    for start in list(adj):
        if start in seen:
            continue
        # BFS with 2-coloring
        comp: List[int] = []
        color: Dict[int, int] = {start: 0}
        stack = [start]
        bipartite = True
        while stack:
            r = stack.pop()
            comp.append(r)
            for r2 in adj[r]:
                if r2 not in color:
                    color[r2] = color[r] ^ 1
                    stack.append(r2)
                elif color[r2] == color[r]:
                    bipartite = False
        seen.update(comp)
        if not bipartite:
            continue
        side_a = [link_of_row[r] for r in comp if color[r] == 0]
        side_b = [link_of_row[r] for r in comp if color[r] == 1]
        if not side_a or not side_b:
            continue
        K, L = len(side_a), len(side_b)
        # grid completeness: every A row has exactly L children, every B
        # row exactly K, all children fully good, every (A,B) pair exactly
        # one shared child
        comp_children: Set[int] = set()
        ok = True
        for lr in side_a:
            if len(lr.children) != L or len(set(lr.children)) != L:
                ok = False
                break
            comp_children.update(lr.children)
        for lr in side_b:
            if not ok or len(lr.children) != K or len(set(lr.children)) != K:
                ok = False
                break
            comp_children.update(lr.children)
        if not ok or len(comp_children) != K * L:
            continue
        if not all(c in good_children and fully_good(c) for c in comp_children):
            continue
        cell: Dict[int, Tuple[int, int]] = {}  # child -> (u, v)
        for c in comp_children:
            r1, r2 = child_rows[c]
            if color[r1.index] == 0:
                ra, rb = r1, r2
            else:
                ra, rb = r2, r1
            cell[c] = (ra.parent, rb.parent)
        pa = [lr.parent for lr in side_a]
        pb_ = [lr.parent for lr in side_b]
        if len(set(pa)) != K or len(set(pb_)) != L:
            continue
        # pair uniqueness: K*L children and each (u,v) distinct
        if len({cell[c] for c in comp_children}) != K * L:
            continue
        # one-hot marginals
        if frozenset(pa) not in onehots or frozenset(pb_) not in onehots:
            continue

        # fold the component
        for c in comp_children:
            u, v = cell[c]
            f = cost_of.get(c, 0.0)
            if f:
                if u == v:
                    new_lin[u] += f  # x*x = x for binary
                else:
                    new_q.append(ObjectiveQuadraticTerm(f, u, v))
            derived.append((c, u, v))
            drop_vars.add(c)
        for lr in side_a + side_b:
            drop_rows.add(lr.index)

    if not drop_vars:
        return pb

    # 5. emit compacted problem
    mapping = [-1] * n
    cix = 0
    for i in range(n):
        if i not in drop_vars:
            mapping[i] = cix
            cix += 1

    out = Problem(type=pb.type)
    out.affected_vars.names = list(pb.affected_vars.names)
    out.affected_vars.values = list(pb.affected_vars.values)
    out.derived_vars.names = list(pb.derived_vars.names)
    out.derived_vars.parents_a = list(pb.derived_vars.parents_a)
    out.derived_vars.parents_b = list(pb.derived_vars.parents_b)
    names = pb.vars.names
    for c, u, v in derived:
        out.derived_vars.push_back(names[c], names[u], names[v])

    for i in range(n):
        if mapping[i] >= 0:
            out.vars.names.append(names[i])
            out.vars.values.append(pb.vars.values[i])

    obj = ObjectiveFunction(value=pb.objective.value)
    lin: Dict[int, float] = defaultdict(float)
    for el in pb.objective.elements:
        if el.variable_index in drop_vars:
            continue  # folded into new_lin / new_q
        lin[mapping[el.variable_index]] += el.factor
    for u, f in new_lin.items():
        lin[mapping[u]] += f
    obj.elements = [ObjectiveElement(f, j) for j, f in sorted(lin.items()) if f]
    qmerge: Dict[Tuple[int, int], float] = defaultdict(float)
    for q in pb.objective.qelements:
        a, b = mapping[q.variable_index_a], mapping[q.variable_index_b]
        qmerge[(min(a, b), max(a, b))] += q.factor
    for q in new_q:
        a, b = mapping[q.variable_index_a], mapping[q.variable_index_b]
        qmerge[(min(a, b), max(a, b))] += q.factor
    obj.qelements = [
        ObjectiveQuadraticTerm(f, a, b) for (a, b), f in sorted(qmerge.items()) if f
    ]
    out.objective = obj

    for kind, dst in (
        ("equal", out.equal_constraints),
        ("greater", out.greater_constraints),
        ("less", out.less_constraints),
    ):
        for i, cst in enumerate(lists[kind]):
            if kind == "equal" and i in drop_rows:
                continue
            dst.append(
                Constraint(
                    cst.label,
                    [
                        FunctionElement(el.factor, mapping[el.variable_index])
                        for el in cst.elements
                    ],
                    cst.value,
                    cst.id,
                )
            )

    out.problem_type = which_problem_type(out)
    ctx.info(
        "  - Product fold: removed {} variables, {} constraints "
        "({} quadratic terms)\n",
        len(drop_vars),
        len(drop_rows),
        len(obj.qelements),
    )
    return out
