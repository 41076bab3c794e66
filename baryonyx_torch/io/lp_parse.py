"""CPLEX LP-format parser.

A hand-rolled tokenizer + recursive-descent parser accepting the same
grammar (including quirks) as the reference's parser
(reference: lib/src/parser.cpp:1064-1258 `parse`, tokenizer :268-450):

- sections: objective (``maximize``/``minimize`` + synonyms), ``subject to``
  (``st``, ``st.``, ``s.t.``, ``subject to``, ``sush that``), ``bounds``,
  ``binary``/``bin``, ``general``/``gen``, ``end``;
- ``\\`` starts a comment running to end of line;
- separators ``< = > : - + [ ] * ^`` always split tokens (so ``2x2`` reads
  as factor 2 on variable ``x2`` and exponents like ``1e-5`` split — same
  as the reference, parser.cpp:131-149);
- operators ``<``, ``>``, ``=``, ``<=``, ``>=``, ``=<``, ``=>``, ``==``
  (reference: parser.cpp:631-655);
- quadratic objective blocks ``[ 2 a * b + x ^ 2 ] / 2`` with the factor
  halved and duplicate pairs merged (reference: parser.cpp:662-786);
- objective constants fold into ``objective.value``; duplicate variables in
  a function merge their factors (reference: parser.cpp:491-512);
- bounds forms ``N <= x``, ``N <= x <= M``, ``x <= N``, ``x free-form name``
  with ``inf``/``infinity`` accepted; the relational operator on the
  single-sided ``name op value`` form is ignored and the value is always
  taken as the upper bound, mirroring the reference quirk
  (parser.cpp:940-960);
- constraint ids number constraints in file order across the three
  operator lists (reference: parser.cpp:1110-1196).
"""

from __future__ import annotations

import re
from typing import List, Optional, Tuple

from baryonyx_torch.core.context import Context
from baryonyx_torch.core.errors import FileAccessError, FileFormatError
from baryonyx_torch.core.model import (
    Constraint,
    FunctionElement,
    INT_INF,
    ObjectiveElement,
    ObjectiveQuadraticTerm,
    OperatorType,
    RawProblem,
    VariableType,
    VariableValue,
)

_SEPARATORS = set("<=>:-+[]*^")
_NAME_EXTRA = set('!"#$%&(),.;?@_{}~')
_KEYWORDS = {
    "binary",
    "binaries",
    "bin",
    "bound",
    "bounds",
    "general",
    "generals",
    "gen",
    "end",
    "st",
    "subject",
    "sush",
    "s.t.",
    "st.",
}

_FLOAT_RE = re.compile(r"^[+-]?(?:\d+\.?\d*|\.\d+)(?:[eE][+-]?\d+)?")


def _is_name_char(c: str) -> bool:
    return c.isalnum() or c in _NAME_EXTRA


def _is_number_char(c: str) -> bool:
    return c.isdigit() or c in ".eE-+"


def _starts_with_number(tok: str) -> bool:
    if not tok:
        return False
    if tok[0] in "iI" and tok.lower() in ("inf", "infinity"):
        return True
    return tok[0].isdigit() or tok[0] in ".eE-+"


def _is_keyword(tok: str) -> bool:
    return tok.lower() in _KEYWORDS


def tokenize(text: str) -> List[str]:
    """Split into tokens the way the reference tokenizer does
    (reference: parser.cpp:383-449): whitespace-separated words, then
    within a word separators are single-char tokens, number tokens run
    over number chars, name tokens run to the next separator."""
    tokens: List[str] = []
    for line in text.splitlines():
        for word in line.split():
            if word.startswith("\\"):
                break  # comment to end of line
            i = 0
            L = len(word)
            while i < L:
                c = word[i]
                if c in _SEPARATORS:
                    tokens.append(c)
                    i += 1
                    continue
                start = i
                i += 1
                if c.isdigit() or c == ".":
                    while i < L and word[i] not in _SEPARATORS and _is_number_char(word[i]):
                        i += 1
                else:
                    while i < L and word[i] not in _SEPARATORS:
                        i += 1
                tokens.append(word[start:i])
        # comment handled per-line by the break above
    return tokens


def _read_float(tok: str) -> Optional[float]:
    """sscanf("%lf")-style longest-prefix float parse
    (reference: parser.cpp:565-586)."""
    if len(tok) >= 3 and tok.lower() in ("inf", "infinity"):
        return float("inf")
    m = _FLOAT_RE.match(tok)
    if not m or not any(ch.isdigit() for ch in m.group(0)):
        return None
    return float(m.group(0))


class _Cursor:
    """Token stream with unbounded lookahead (replaces the reference's
    10-slot ring buffer, parser.cpp:268-450)."""

    def __init__(self, tokens: List[str]):
        self.tokens = tokens
        self.pos = 0

    def peek(self, k: int = 0) -> str:
        i = self.pos + k
        return self.tokens[i] if i < len(self.tokens) else ""

    def pop(self, k: int = 1) -> None:
        self.pos += k

    @property
    def eof(self) -> bool:
        return self.pos >= len(self.tokens)


def _read_real2(c: _Cursor) -> Tuple[float, int]:
    """Read an optionally-signed real spanning 0..2 tokens; returns
    (value, tokens_consumed); a bare sign counts as +/-1 with 1 token and
    an absent number as factor 1.0 with 0 tokens
    (reference: parser.cpp:589-615)."""
    t1, t2 = c.peek(0), c.peek(1)
    if t1 == "-":
        v = _read_float(t2)
        return (-1.0, 1) if v is None else (-v, 2)
    if t1 == "+":
        v = _read_float(t2)
        return (1.0, 1) if v is None else (v, 2)
    v = _read_float(t1)
    return (1.0, 0) if v is None else (v, 1)


def _read_name(tok: str) -> Optional[str]:
    if tok and all(_is_name_char(ch) for ch in tok):
        return tok
    return None


def _read_operator(c: _Cursor, offset: int = 0) -> Optional[Tuple[OperatorType, int]]:
    """reference: parser.cpp:625-655."""
    t1, t2 = c.peek(offset), c.peek(offset + 1)
    if t1 == "<":
        return (OperatorType.less, 2 if t2 == "=" else 1)
    if t1 == ">":
        return (OperatorType.greater, 2 if t2 == "=" else 1)
    if t1 == "=":
        if t2 == "<":
            return (OperatorType.less, 2)
        if t2 == "=":
            return (OperatorType.equal, 2)
        if t2 == ">":
            return (OperatorType.greater, 2)
        return (OperatorType.equal, 1)
    return None


def _read_function_element(c: _Cursor) -> Optional[Tuple[float, str, int]]:
    """(factor, name-or-empty, consumed); empty name means a bare constant
    (reference: parser.cpp:789-821)."""
    value, read = _read_real2(c)
    to_read = c.peek(read)
    if not _is_keyword(to_read) and to_read and _is_name_char(to_read[0]):
        name = _read_name(to_read)
        if name is None:
            return None
        return (value, name, read + 1)
    return (value, "", read)


class _Parser:
    def __init__(self, tokens: List[str]):
        self.c = _Cursor(tokens)
        self.pb = RawProblem()
        self.var_index: dict[str, int] = {}

    def fail(self, msg: str) -> None:
        near = " ".join(self.c.tokens[self.c.pos : self.c.pos + 5])
        raise FileFormatError(f"{msg} near {near!r}")

    def get_or_assign_variable(self, name: str) -> int:
        idx = self.var_index.get(name)
        if idx is not None:
            return idx
        idx = len(self.var_index)
        self.var_index[name] = idx
        self.pb.vars.names.append(name)
        self.pb.vars.values.append(VariableValue(0, INT_INF, VariableType.real))
        return idx

    def get_variable(self, name: str) -> int:
        return self.var_index.get(name, -1)

    # -- sections ------------------------------------------------------
    def parse(self) -> RawProblem:
        self.parse_objective_type()
        self.parse_objective()
        self.parse_constraints()
        self.parse_bounds()
        self.parse_binary()
        self.parse_general()
        self.parse_end()
        return self.pb

    def parse_objective_type(self) -> None:
        from baryonyx_torch.core.model import ObjectiveType

        tok = self.c.peek().lower()
        if tok in ("maximize", "maximum", "max"):
            self.pb.type = ObjectiveType.maximize
        elif tok in ("minimize", "minimum", "min"):
            self.pb.type = ObjectiveType.minimize
        else:
            self.fail("bad objective function type")
        self.c.pop()
        # optional label `name :` (reference: parser.cpp:976-987)
        if not _is_keyword(self.c.peek()) and self.c.peek(1) == ":":
            self.c.pop(2)

    def _append_objective(self, factor: float, name: str) -> None:
        if not name:
            self.pb.objective.value += factor
            return
        idx = self.get_or_assign_variable(name)
        for el in self.pb.objective.elements:
            if el.variable_index == idx:
                el.factor += factor
                return
        self.pb.objective.elements.append(ObjectiveElement(factor, idx))

    def _append_qelement(self, factor: float, ia: int, ib: int) -> None:
        for el in self.pb.objective.qelements:
            if (el.variable_index_a, el.variable_index_b) in ((ia, ib), (ib, ia)):
                el.factor += factor
                return
        self.pb.objective.qelements.append(ObjectiveQuadraticTerm(factor, ia, ib))

    def parse_quadratic_block(self, sign_factor: float) -> None:
        """``[ k a * b + x ^ 2 ... ] / 2`` (reference: parser.cpp:694-786)."""
        c = self.c
        if c.peek() != "[":
            self.fail("bad objective quadratic")
        c.pop()
        while c.peek() and c.peek() != "]":
            value, read = _read_real2(c)
            to_read = c.peek(read)
            if _is_keyword(to_read) or not (to_read and _is_name_char(to_read[0])):
                self.fail("bad objective quadratic")
            name = _read_name(to_read)
            if name is None:
                self.fail("bad objective quadratic")
            c.pop(read + 1)

            if c.peek() == "*":
                name2 = _read_name(c.peek(1))
                if name2 is None:
                    self.fail("bad objective quadratic")
                ia = self.get_or_assign_variable(name)
                ib = self.get_or_assign_variable(name2)
                self._append_qelement(value * sign_factor / 2.0, ia, ib)
                c.pop(2)
            elif c.peek() == "^" or c.peek() == "^2":
                if c.peek() == "^" and c.peek(1) == "2":
                    c.pop(2)
                else:
                    c.pop(1)
                idx = self.get_or_assign_variable(name)
                self._append_qelement(value * sign_factor / 2.0, idx, idx)
            # a lone linear term inside [] is dropped, as in the reference
        c.pop()  # ']'
        if c.peek() == "/" and c.peek(1) == "2":
            c.pop(2)
        elif c.peek() == "/2":
            c.pop(1)
        else:
            self.fail("bad objective quadratic: missing /2")

    def parse_objective(self) -> None:
        c = self.c
        while not c.eof and not _is_keyword(c.peek()):
            t1, t2 = c.peek(), c.peek(1)
            if t1 == "[" or (t1 in "+-" and t2 == "["):
                factor = 1.0
                if t1 == "-":
                    factor = -1.0
                    c.pop()
                elif t1 == "+":
                    c.pop()
                self.parse_quadratic_block(factor)
                continue
            elem = _read_function_element(c)
            if elem is None:
                self.fail("bad objective")
            factor, name, read = elem
            self._append_objective(factor, name)
            c.pop(read)

    def _read_subject_to(self) -> int:
        c = self.c
        t1, t2, t3 = c.peek().lower(), c.peek(1), c.peek(2)
        if t1 in ("st", "st.", "s.t", "s.t."):
            return 2 if t2 == ":" else 1
        if t1 == "subject" and t2.lower() == "to":
            return 3 if t3 == ":" else 2
        if t1 == "sush" and t2.lower() == "that":
            return 3 if t3 == ":" else 2
        return 0

    def parse_constraints(self) -> None:
        c = self.c
        read = self._read_subject_to()
        if not read:
            return
        c.pop(read)
        next_id = 0
        while not c.eof and not _is_keyword(c.peek()):
            label = ""
            if c.peek() and _is_name_char(c.peek()[0]) and c.peek(1) == ":":
                label = c.peek()
                c.pop(2)

            elements: List[FunctionElement] = []

            def add_element(factor: float, name: str) -> None:
                idx = self.get_or_assign_variable(name)
                for el in elements:
                    if el.variable_index == idx:
                        el.factor += int(factor)
                        return
                elements.append(FunctionElement(int(factor), idx))

            elem = _read_function_element(c)
            if elem is None or not elem[1]:
                self.fail("bad constraint")
            add_element(elem[0], elem[1])
            c.pop(elem[2])

            while not c.eof and not (c.peek() and c.peek()[0] in "<=>"):
                elem = _read_function_element(c)
                if elem is None or not elem[1]:
                    self.fail("bad constraint")
                add_element(elem[0], elem[1])
                c.pop(elem[2])

            op = _read_operator(c)
            if op is None:
                self.fail("bad constraint operator")
            c.pop(op[1])

            value, vread = _read_real2(c)
            if vread == 0:
                self.fail("bad constraint value")
            c.pop(vread)

            cst = Constraint(label, elements, int(value), next_id)
            next_id += 1
            if op[0] == OperatorType.equal:
                self.pb.equal_constraints.append(cst)
            elif op[0] == OperatorType.greater:
                self.pb.greater_constraints.append(cst)
            else:
                self.pb.less_constraints.append(cst)

    def _read_section(self, names: Tuple[str, ...]) -> int:
        t1, t2 = self.c.peek().lower(), self.c.peek(1)
        if t1 in names:
            return 2 if t2 == ":" else 1
        return 0

    def _set_bound(self, name: str, lo: float, hi: float) -> None:
        idx = self.get_variable(name)
        if idx < 0:
            self.fail(f"bound on unknown variable {name!r}")
        vv = self.pb.vars.values[idx]
        vv.min = -(2**31) if lo == float("-inf") else int(lo)
        vv.max = INT_INF if hi == float("inf") else int(hi)

    def _read_right_bound(self, offset: int) -> Optional[Tuple[float, int]]:
        """op [sign] value → (value, consumed incl. op)
        (reference: parser.cpp:862-905)."""
        c = self.c
        op = _read_operator(c, offset)
        if op is None:
            return None
        _, op_read = op
        i = offset + op_read
        neg = 1.0
        if c.peek(i) in "+-":
            if c.peek(i) == "-":
                neg = -1.0
            i += 1
        v = _read_float(c.peek(i))
        if v is None:
            return None
        return (neg * v, i + 1 - offset)

    def parse_bounds(self) -> None:
        c = self.c
        read = self._read_section(("bounds", "bound"))
        if not read:
            return
        c.pop(read)
        while not c.eof and not _is_keyword(c.peek()):
            tok = c.peek()
            if _starts_with_number(tok):
                # NUM op NAME [op NUM]  (reference: parser.cpp:908-938)
                neg = 1.0
                i = 0
                if tok in "+-":
                    if tok == "-":
                        neg = -1.0
                    i = 1
                v = _read_float(c.peek(i))
                if v is None:
                    self.fail("bad bound")
                left = neg * v
                op = _read_operator(c, i + 1)
                if op is None:
                    self.fail("bad bound")
                i += 1 + op[1]
                name = _read_name(c.peek(i))
                if name is None:
                    self.fail("bad bound")
                i += 1
                rb = self._read_right_bound(i)
                if rb is None:
                    self._set_bound(name, left, float("inf"))
                    c.pop(i)
                else:
                    if left > rb[0]:
                        self.fail("bad bound: min > max")
                    self._set_bound(name, left, rb[0])
                    c.pop(i + rb[1])
            elif tok and _is_name_char(tok[0]):
                name = _read_name(tok)
                if name is None:
                    self.fail("bad bound")
                rb = self._read_right_bound(1)
                if rb is None:
                    # bare name → free variable
                    self._set_bound(name, float("-inf"), float("inf"))
                    c.pop(1)
                else:
                    # reference quirk: the operator is ignored and the value
                    # is taken as the upper bound with min=0
                    # (parser.cpp:940-948)
                    self._set_bound(name, 0.0, rb[0])
                    c.pop(1 + rb[1])
            else:
                self.fail("bad bound")

    def parse_binary(self) -> None:
        c = self.c
        read = self._read_section(("binary", "binaries", "bin"))
        if not read:
            return
        c.pop(read)
        while not c.eof and not _is_keyword(c.peek()):
            idx = self.get_variable(c.peek())
            if idx < 0:
                self.fail(f"binary on unknown variable {c.peek()!r}")
            vv = self.pb.vars.values[idx]
            vv.type = VariableType.binary
            vv.min, vv.max = 0, 1
            c.pop()

    def parse_general(self) -> None:
        c = self.c
        read = self._read_section(("general", "generals", "gen"))
        if not read:
            return
        c.pop(read)
        while not c.eof and not _is_keyword(c.peek()):
            idx = self.get_variable(c.peek())
            if idx < 0:
                self.fail(f"general on unknown variable {c.peek()!r}")
            self.pb.vars.values[idx].type = VariableType.general
            c.pop()

    def parse_end(self) -> None:
        c = self.c
        if c.peek().lower() != "end":
            self.fail("missing 'end'")
        c.pop(2 if c.peek(1) == ":" else 1)
        if not c.eof:
            self.fail("trailing tokens after 'end'")


def parse_lp(text: str) -> RawProblem:
    """Parse LP-format text into a RawProblem (pure-Python parser)."""
    return _Parser(tokenize(text)).parse()


def make_problem(ctx: Context, source) -> RawProblem:
    """Parse from a path or file-like object
    (reference: lpcore.cpp:71-86, parser.cpp:1261-1272)."""
    if hasattr(source, "read"):
        return parse_lp(source.read())
    try:
        with open(source, "r") as fh:
            text = fh.read()
    except OSError as e:
        raise FileAccessError(str(source), str(e))
    return parse_lp(text)
