"""Variable-fixing preprocessor.

Fixed-point propagation over a LIFO of forced assignments
(reference: lib/src/preprocessor.cpp:141-860):

1. seed with variables whose bounds force a value (min == max,
   :440-452) and constraints decidable outright (:454-557):
   - ``=``: singleton rows reduced; all-nonneg-factor rows with value 0
     (all false) or value == sum of factors (all true)
   - ``>=``: all-nonneg rows with value == sum (all true); value == 0 rows
     dropped as trivially satisfied
   - ``<=``: all-nonneg rows with value <= 0 (all false); value == sum rows
     dropped as trivially satisfied
2. pop assignments, decrement per-constraint unfixed counts; a count of 1
   reduces the constraint to a forced assignment of its last variable
   (``reduce_*_constraint``, :190-263); inconsistency raises
3. variables unused by any remaining constraint are fixed to their
   objective-optimal value (:337-359); quadratic objective terms of unused
   variables are folded into the linear objective/constant
   (``make_lp_from_bqp_objective``, :289-331 — re-implemented sanely: the
   reference's merge loop reads ``it->factor`` past-the-end and matches on
   the loop counter, a bug not worth replicating)
4. emit a compacted Problem with old->new index mapping, affected-variable
   bookkeeping, and singleton/decided constraints dropped
   (``make_problem``, :651-716). Unlike the reference, no ``preprocessed.lp``
   debug file is written (the reference leaves that dump enabled
   unconditionally, :710-713 — a bug SURVEY.md flags not to replicate).

``affect``/``split`` re-run the propagation from a single pinned variable
for the branch meta-optimizer (reference: :866-901).
"""

from __future__ import annotations

from typing import Dict, List, Tuple

from baryonyx_torch.core.context import Context
from baryonyx_torch.core.errors import ProblemDefinitionError
from baryonyx_torch.core.model import (
    AffectedVariables,
    Constraint,
    FunctionElement,
    ObjectiveElement,
    ObjectiveFunction,
    ObjectiveQuadraticTerm,
    ObjectiveType,
    Problem,
    RawProblem,
    Variables,
    which_problem_type,
)


class _Fixer:
    def __init__(self, ctx: Context, pb: RawProblem):
        self.ctx = ctx
        self.pb = pb
        self.vars: Dict[int, bool] = {}
        self.lifo: List[Tuple[int, bool]] = []
        # remaining unfixed-variable counts per constraint
        self.counts = {
            "equal": [len(c.elements) for c in pb.equal_constraints],
            "greater": [len(c.elements) for c in pb.greater_constraints],
            "less": [len(c.elements) for c in pb.less_constraints],
        }
        self.lists = {
            "equal": pb.equal_constraints,
            "greater": pb.greater_constraints,
            "less": pb.less_constraints,
        }
        # variable -> constraint indices per kind (reference: :580-600)
        n = len(pb.vars.values)
        self.cache: Dict[str, List[List[int]]] = {
            kind: [[] for _ in range(n)] for kind in self.lists
        }
        for kind, constraints in self.lists.items():
            for i, cst in enumerate(constraints):
                for el in cst.elements:
                    self.cache[kind][el.variable_index].append(i)
        # extra objective terms produced by BQP folding
        self.merge_obj_value = 0.0
        self.merge_obj_elements: List[ObjectiveElement] = []

    # -- constraint reduction ------------------------------------------
    def _reduce(self, cst: Constraint) -> Tuple[int, int, int]:
        """(factor, var_id, residual value) of the single unfixed variable
        (reference: :158-188)."""
        result = cst.value
        remaining = -1
        for i, el in enumerate(cst.elements):
            v = self.vars.get(el.variable_index)
            if v is None:
                remaining = i
            else:
                result -= el.factor * int(v)
        if remaining < 0:
            return (-1, -1, result)
        el = cst.elements[remaining]
        return (el.factor, el.variable_index, result)

    def _reduce_constraint(self, kind: str, cst: Constraint) -> Tuple[int, bool]:
        """Forced value of the last unfixed variable, or (-1, False) when
        undecidable (reference: :190-263)."""
        factor, var, result = self._reduce(cst)
        if var < 0:
            return (-1, False)
        if kind == "equal":
            a0, a1 = (0 == result), (factor == result)
        elif kind == "greater":
            a0, a1 = (0 >= result), (factor >= result)
        else:
            a0, a1 = (0 <= result), (factor <= result)
        if a0 and a1:
            return (-1, False)
        if a0:
            return (var, False)
        if a1:
            return (var, True)
        raise ProblemDefinitionError(
            cst.label or f"constraint#{cst.id}",
            f"{kind} constraint infeasible after fixing",
        )

    # -- propagation ---------------------------------------------------
    def _affects(self) -> None:
        """reference: :360-431."""
        while self.lifo:
            index, value = self.lifo.pop()
            if index in self.vars:
                if self.vars[index] != value:
                    raise ProblemDefinitionError(
                        self.pb.vars.names[index], "conflicting forced values"
                    )
                continue
            self.vars[index] = value
            for kind in ("equal", "greater", "less"):
                counts = self.counts[kind]
                for ci in self.cache[kind][index]:
                    if counts[ci] <= 0:
                        continue
                    counts[ci] -= 1
                    if counts[ci] == 1:
                        var, val = self._reduce_constraint(kind, self.lists[kind][ci])
                        counts[ci] = 0
                        if var >= 0:
                            self.lifo.append((var, val))

    def _try_affect_bounded_variable(self) -> None:
        """min == max bounds force the value (reference: :440-452)."""
        for i, vv in enumerate(self.pb.vars.values):
            if vv.min == vv.max:
                self.lifo.append((i, vv.max != 0))

    def _try_affect_variable(self) -> None:
        """Outright-decidable constraints (reference: :454-557)."""
        for kind in ("equal", "greater", "less"):
            counts = self.counts[kind]
            for i, cst in enumerate(self.lists[kind]):
                if counts[i] == 1:
                    var, val = self._reduce_constraint(kind, cst)
                    counts[i] = 0
                    if var >= 0:
                        self.lifo.append((var, val))
                    continue
                if any(el.factor < 0 for el in cst.elements):
                    continue
                total = sum(el.factor for el in cst.elements)
                if kind == "equal":
                    if total == cst.value or cst.value == 0:
                        counts[i] = 0
                        for el in cst.elements:
                            self.lifo.append((el.variable_index, cst.value != 0))
                elif kind == "greater":
                    if total == cst.value:
                        counts[i] = 0
                        for el in cst.elements:
                            self.lifo.append((el.variable_index, True))
                    elif cst.value == 0:
                        counts[i] = 0  # trivially satisfied
                else:  # less
                    if cst.value <= 0:
                        counts[i] = 0
                        for el in cst.elements:
                            self.lifo.append((el.variable_index, False))
                    elif total == cst.value:
                        counts[i] = 0  # trivially satisfied

    def _is_unused(self, var: int) -> bool:
        """No remaining constraint uses the variable (reference: :265-281)."""
        for kind in ("equal", "greater", "less"):
            counts = self.counts[kind]
            for ci in self.cache[kind][var]:
                if counts[ci] > 0:
                    return False
        return True

    def _fold_bqp_and_unused(self) -> None:
        """Fix unused variables at their objective-optimal value; fold
        quadratic terms of unused variables into the linear objective
        (reference: :289-359, re-implemented without the reference's
        out-of-bounds merge loop)."""
        obj = self.pb.objective
        maximize = self.pb.type == ObjectiveType.maximize
        qindex: Dict[int, List[ObjectiveQuadraticTerm]] = {}
        for q in obj.qelements:
            qindex.setdefault(q.variable_index_a, []).append(q)
            if q.variable_index_b != q.variable_index_a:
                qindex.setdefault(q.variable_index_b, []).append(q)

        linear = {el.variable_index: el.factor for el in obj.elements}

        for i in range(len(self.pb.vars.values)):
            if i in self.vars or not self._is_unused(i):
                continue
            qterms = qindex.get(i, [])
            if qterms:
                # the reference fixes such a variable per the sign of its
                # quadratic terms, folding active terms into the objective
                for q in qterms:
                    value = (q.factor > 0) if maximize else (q.factor < 0)
                    if not value:
                        continue
                    if q.variable_index_a == q.variable_index_b:
                        self.merge_obj_value += q.factor
                    else:
                        other = (
                            q.variable_index_b
                            if q.variable_index_a == i
                            else q.variable_index_a
                        )
                        self.merge_obj_elements.append(
                            ObjectiveElement(q.factor, other)
                        )
            # fix the unused variable by its linear objective sign
            c = linear.get(i, 0.0)
            value = (c > 0) if maximize else (c < 0)
            self.vars[i] = value

    # -- output --------------------------------------------------------
    def _make_problem(self) -> Problem:
        """Compacted copy (reference: :651-716)."""
        pb = self.pb
        n = len(pb.vars.values)
        mapping: List[Tuple[int, bool]] = [(-1, False)] * n
        c = 0
        for i in range(n):
            if i in self.vars:
                mapping[i] = (-1, self.vars[i])
            else:
                mapping[i] = (c, False)
                c += 1

        out = Problem(type=pb.type)

        # objective (reference: :719-772)
        obj = ObjectiveFunction(value=pb.objective.value + self.merge_obj_value)
        merged_linear: Dict[int, float] = {}
        for el in pb.objective.elements:
            new, fixed_val = mapping[el.variable_index]
            if new == -1:
                if fixed_val:
                    obj.value += el.factor
            else:
                merged_linear[new] = merged_linear.get(new, 0.0) + el.factor
        for q in pb.objective.qelements:
            na, va = mapping[q.variable_index_a]
            nb, vb = mapping[q.variable_index_b]
            if na == -1 and nb == -1:
                if va and vb:
                    obj.value += q.factor
            elif na == -1:
                if va:
                    merged_linear[nb] = merged_linear.get(nb, 0.0) + q.factor
            elif nb == -1:
                if vb:
                    merged_linear[na] = merged_linear.get(na, 0.0) + q.factor
            else:
                obj.qelements.append(ObjectiveQuadraticTerm(q.factor, na, nb))
        for el in self.merge_obj_elements:
            new, fixed_val = mapping[el.variable_index]
            if new == -1:
                if fixed_val:
                    obj.value += el.factor
            else:
                merged_linear[new] = merged_linear.get(new, 0.0) + el.factor
        obj.elements = [
            ObjectiveElement(f, idx) for idx, f in sorted(merged_linear.items())
        ]
        out.objective = obj

        # variables + affected bookkeeping (reference: :800-824)
        if isinstance(pb, Problem):
            out.affected_vars = AffectedVariables(
                names=list(pb.affected_vars.names),
                values=list(pb.affected_vars.values),
            )
            out.derived_vars.names = list(pb.derived_vars.names)
            out.derived_vars.parents_a = list(pb.derived_vars.parents_a)
            out.derived_vars.parents_b = list(pb.derived_vars.parents_b)
        for i in range(n):
            if i in self.vars:
                out.affected_vars.names.append(pb.vars.names[i])
                out.affected_vars.values.append(int(self.vars[i]))
            else:
                out.vars.names.append(pb.vars.names[i])
                out.vars.values.append(pb.vars.values[i])

        # constraints (reference: :826-858): drop decided (count 0) and
        # singleton (count 1) rows; remap surviving elements and fold fixed
        # contributions into the RHS
        for kind, dst in (
            ("equal", out.equal_constraints),
            ("greater", out.greater_constraints),
            ("less", out.less_constraints),
        ):
            counts = self.counts[kind]
            for i, cst in enumerate(self.lists[kind]):
                if counts[i] <= 1:
                    continue
                new_cst = Constraint(cst.label, [], cst.value, cst.id)
                for el in cst.elements:
                    new, fixed_val = mapping[el.variable_index]
                    if new >= 0:
                        new_cst.elements.append(FunctionElement(el.factor, new))
                    elif fixed_val:
                        new_cst.value -= el.factor
                dst.append(new_cst)

        out.problem_type = which_problem_type(out)
        self.ctx.info(
            "  - Preprocessor finished: removed {} variables\n", len(self.vars)
        )
        return out

    # -- entry points --------------------------------------------------
    def run(self) -> Problem:
        """reference: operator()() :628-649."""
        self._try_affect_bounded_variable()
        self._try_affect_variable()
        self._affects()
        self._fold_bqp_and_unused()
        self._affects()
        return self._make_problem()

    def run_pinned(self, variable_index: int, value: bool) -> Problem:
        """reference: operator()(int,bool) :607-626."""
        self.lifo.append((variable_index, value))
        self._affects()
        self._fold_bqp_and_unused()
        self._affects()
        return self._make_problem()


def preprocess(ctx: Context, raw: RawProblem) -> Problem:
    """reference: preprocessor.cpp:903-913."""
    return _Fixer(ctx, raw).run()


def unpreprocess(ctx: Context, raw: RawProblem) -> Problem:
    """Conversion without fixing (reference: preprocessor.cpp:915-923)."""
    return Problem.from_raw(raw)


def affect(ctx: Context, pb: Problem, variable_index: int, value: bool) -> Problem:
    """Pin one variable and re-propagate (reference: preprocessor.cpp:883-901)."""
    return _Fixer(ctx, pb).run_pinned(variable_index, value)


def split(ctx: Context, pb: Problem, variable_index: int) -> Tuple[Problem, Problem]:
    """Both pinnings of one variable (reference: preprocessor.cpp:866-881)."""
    return (
        _Fixer(ctx, pb).run_pinned(variable_index, True),
        _Fixer(ctx, pb).run_pinned(variable_index, False),
    )
