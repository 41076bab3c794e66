"""LP-format writer (reference: lib/src/problem.hpp:327-384)."""

from __future__ import annotations

import io
from typing import List, TextIO, Union

from baryonyx_torch.core.model import (
    Constraint,
    INT_INF,
    ObjectiveType,
    RawProblem,
    VariableType,
)


def _fmt_num(v: float) -> str:
    if v == int(v):
        return str(int(v))
    return repr(v)


def _write_function(out: TextIO, pb: RawProblem, elements) -> None:
    for el in elements:
        f = el.factor
        name = pb.vars.names[el.variable_index]
        if f < 0:
            out.write(f" - {_fmt_num(-f) + ' ' if f != -1 else ''}{name}" if f != -1 else f" - {name}")
        else:
            out.write(f" + {_fmt_num(f) + ' ' if f != 1 else ''}{name}" if f != 1 else f" + {name}")


def _write_constraint(out: TextIO, pb: RawProblem, cst: Constraint, op: str) -> None:
    if cst.label:
        out.write(f"{cst.label}:")
    _write_function(out, pb, cst.elements)
    out.write(f" {op} {cst.value}\n")


def write_problem(pb: RawProblem, out: Union[TextIO, None] = None) -> str:
    """Serialize a problem to LP format; returns the text (and writes to
    ``out`` if given)."""
    buf = io.StringIO()
    if pb.vars.names:
        buf.write(
            "maximize\n" if pb.type == ObjectiveType.maximize else "minimize\n"
        )
        _write_function(buf, pb, pb.objective.elements)
        if pb.objective.qelements:
            buf.write(" + [")
            for q in pb.objective.qelements:
                f = q.factor * 2.0
                na = pb.vars.names[q.variable_index_a]
                nb = pb.vars.names[q.variable_index_b]
                sign = "-" if f < 0 else "+"
                mag = _fmt_num(abs(f))
                if q.variable_index_a == q.variable_index_b:
                    buf.write(f" {sign} {mag} {na} ^ 2")
                else:
                    buf.write(f" {sign} {mag} {na} * {nb}")
            buf.write(" ] / 2")
        if pb.objective.value < 0:
            buf.write(f" {_fmt_num(pb.objective.value)}")
        elif pb.objective.value > 0:
            buf.write(f" + {_fmt_num(pb.objective.value)}")
        buf.write("\nsubject to\n")
        for cst in pb.equal_constraints:
            _write_constraint(buf, pb, cst, "=")
        for cst in pb.greater_constraints:
            _write_constraint(buf, pb, cst, ">=")
        for cst in pb.less_constraints:
            _write_constraint(buf, pb, cst, "<=")

        buf.write("bounds\n")
        for name, vv in zip(pb.vars.names, pb.vars.values):
            if vv.type == VariableType.binary:
                continue
            lo = "-inf" if vv.min <= -(2**31) else str(vv.min)
            hi = "+inf" if vv.max >= INT_INF else str(vv.max)
            buf.write(f" {lo} <= {name} <= {hi}\n")

        binaries = [
            n for n, v in zip(pb.vars.names, pb.vars.values) if v.type == VariableType.binary
        ]
        generals = [
            n for n, v in zip(pb.vars.names, pb.vars.values) if v.type == VariableType.general
        ]
        if binaries:
            buf.write("binary\n")
            for n in binaries:
                buf.write(f" {n}\n")
        if generals:
            buf.write("general\n")
            for n in generals:
                buf.write(f" {n}\n")
        buf.write("end\n")

    text = buf.getvalue()
    if out is not None:
        out.write(text)
    return text
