"""Python-side adapter for the native LP parser."""

from __future__ import annotations

from typing import Optional

from baryonyx_torch.core.errors import FileFormatError
from baryonyx_torch.core.model import (
    Constraint,
    FunctionElement,
    ObjectiveElement,
    ObjectiveQuadraticTerm,
    ObjectiveType,
    RawProblem,
    VariableType,
    VariableValue,
)
from baryonyx_torch.native.build import load_library


def parse_lp_native(path: str) -> Optional[RawProblem]:
    """Parse an LP file with the native parser; None when the native
    library is unavailable; raises FileFormatError on parse errors."""
    lib = load_library()
    if lib is None:
        return None
    h = lib.lp_parse_file(path.encode())
    if not h:
        raise FileFormatError(f"cannot open {path!r}")
    return _handle_to_problem(lib, h)


def parse_lp_string_native(text: str) -> Optional[RawProblem]:
    """Parse LP source held in memory with the native parser; None when
    the native library is unavailable."""
    lib = load_library()
    if lib is None:
        return None
    data = text.encode()
    h = lib.lp_parse_buffer(data, len(data))
    if not h:
        return None
    return _handle_to_problem(lib, h)


def _handle_to_problem(lib, h) -> RawProblem:
    try:
        err = lib.lp_error(h)
        if err:
            raise FileFormatError(err.decode())

        pb = RawProblem()
        pb.type = (
            ObjectiveType.maximize if lib.lp_maximize(h) else ObjectiveType.minimize
        )
        nvars = lib.lp_n_vars(h)
        names = lib.lp_var_names(h).decode().split("\n")[:nvars]
        vmin = lib.lp_var_min(h)
        vmax = lib.lp_var_max(h)
        vtype = lib.lp_var_type(h)
        pb.vars.names = names
        pb.vars.values = [
            VariableValue(vmin[i], vmax[i], VariableType(vtype[i]))
            for i in range(nvars)
        ]

        nobj = lib.lp_n_obj(h)
        oi, oc = lib.lp_obj_idx(h), lib.lp_obj_coef(h)
        pb.objective.elements = [
            ObjectiveElement(oc[i], oi[i]) for i in range(nobj)
        ]
        nq = lib.lp_n_quad(h)
        qa, qb, qc = lib.lp_qa(h), lib.lp_qb(h), lib.lp_qcoef(h)
        pb.objective.qelements = [
            ObjectiveQuadraticTerm(qc[i], qa[i], qb[i]) for i in range(nq)
        ]
        pb.objective.value = lib.lp_obj_constant(h)

        ncst = lib.lp_n_cst(h)
        ops = lib.lp_cst_op(h)
        rhs = lib.lp_cst_rhs(h)
        start = lib.lp_cst_start(h)
        ev, ec = lib.lp_el_var(h), lib.lp_el_coef(h)
        labels = lib.lp_cst_labels(h).decode().split("\n")[:ncst]
        for k in range(ncst):
            elements = [
                FunctionElement(ec[i], ev[i])
                for i in range(start[k], start[k + 1])
            ]
            cst = Constraint(labels[k], elements, rhs[k], k)
            if ops[k] == 0:
                pb.equal_constraints.append(cst)
            elif ops[k] == 1:
                pb.greater_constraints.append(cst)
            else:
                pb.less_constraints.append(cst)
        return pb
    finally:
        lib.lp_free(h)
