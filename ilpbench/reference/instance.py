"""An instance as a generator makes it: the LP text handed to the program
and the arrays handed to the reference."""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

import numpy as np

GE, EQ, LE = 1, 0, -1  # row senses
_OPS = {GE: ">=", EQ: "=", LE: "<="}


@dataclass
class Instance:
    lp: str  # the LP text the program parses
    names: List[str]  # variable j's name
    cost: np.ndarray  # float64[n]
    row_ptr: np.ndarray  # int64[m + 1]: row i holds row_idx[row_ptr[i]:row_ptr[i + 1]]
    row_idx: np.ndarray  # int64[nnz] variable indices, ascending within a row
    row_val: np.ndarray  # float64[nnz] factors
    sense: np.ndarray  # int8[m]: GE, EQ or LE
    rhs: np.ndarray  # float64[m]
    minimize: bool = True
    # a solution known feasible by construction (an upper bound for the
    # subgradient's steps), where the generator has one
    feasible_x: Optional[np.ndarray] = None

    @property
    def m(self) -> int:
        return len(self.rhs)

    @property
    def n(self) -> int:
        return len(self.cost)

    def rows(self):
        """(variable indices, factors) of each row."""
        for i in range(self.m):
            a, b = self.row_ptr[i], self.row_ptr[i + 1]
            yield self.row_idx[a:b], self.row_val[a:b]


def _num(v: float) -> str:
    return str(int(v)) if float(v).is_integer() else repr(float(v))


def write_lp(names, cost, rows, sense, rhs) -> str:
    """LP text of a 0-1 minimisation: the objective over every variable in
    order, row k labelled ``c<k>``, unit factors written bare."""
    out = ["minimize", " ".join(f"+ {_num(c)} {v}" for c, v in zip(cost, names)),
           "subject to"]
    for k, (idx, val) in enumerate(rows):
        terms = [names[j] if a == 1 else f"{_num(a)} {names[j]}" for j, a in zip(idx, val)]
        out.append(f"c{k}: " + " + ".join(terms) + f" {_OPS[int(sense[k])]} {_num(rhs[k])}")
    out += ["binary", " ".join(names), "end"]
    return "\n".join(out) + "\n"


def from_rows(names, cost, rows, sense, rhs, feasible_x=None) -> Instance:
    """An instance, and its LP text, from (indices, factors) rows whose
    indices ascend."""
    lengths = [len(r[0]) for r in rows]
    return Instance(
        lp=write_lp(names, cost, rows, sense, rhs),
        names=list(names),
        cost=np.asarray(cost, dtype=np.float64),
        row_ptr=np.concatenate([[0], np.cumsum(lengths)]).astype(np.int64),
        row_idx=np.concatenate([np.asarray(r[0], np.int64) for r in rows]),
        row_val=np.concatenate([np.asarray(r[1], np.float64) for r in rows]),
        sense=np.asarray(sense, dtype=np.int8),
        rhs=np.asarray(rhs, dtype=np.float64),
        feasible_x=None if feasible_x is None else np.asarray(feasible_x, np.int64),
    )


def permuted(inst: Instance, seed: int) -> Instance:
    """The same instance with its rows and its columns in an order drawn
    from ``seed``, column k renamed ``x<k>``: the same work, presented in
    another order."""
    rng = np.random.default_rng(seed)
    col = rng.permutation(inst.n)  # new column k is old column col[k]
    row = rng.permutation(inst.m)  # new row k is old row row[k]
    new_of = np.empty(inst.n, dtype=np.int64)
    new_of[col] = np.arange(inst.n)
    old = list(inst.rows())
    rows = []
    for i in row:
        idx, val = old[i]
        idx = new_of[idx]
        order = np.argsort(idx, kind="stable")
        rows.append((idx[order], val[order]))
    return from_rows(
        [f"x{k}" for k in range(inst.n)], inst.cost[col], rows,
        inst.sense[row], inst.rhs[row],
        None if inst.feasible_x is None else inst.feasible_x[col],
    )
