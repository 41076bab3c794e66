"""The port's native (C++) LP parser, against its Python parser and the
JAX package's parser, on the CPU.

- On the cases of tests/test_native_parser.py and on a quadratic
  semi-assignment instance, the native parser (from a file and from a
  buffer), the port's Python parser and the JAX package's parser give the
  same problem: variables, bounds, types, objective (quadratic terms
  included) and constraints, equal.
- Malformed input raises FileFormatError from the native parser too.
- ``parse_lp`` sends text over 64 KiB, and ``make_problem`` a file path,
  to the native parser; BARYONYX_TORCH_NO_NATIVE=1 forces the Python
  parser, with the same result.
- The library lands in build/native/ at the root of the checkout, keyed
  by the source's hash, never in the package directory.
- qsap500x10 (random_qsap_lp(500, 10, seed=3)) parses in under 2 s.
"""

import time
from pathlib import Path

import pytest

import baryonyx_tpu as bx
from baryonyx_tpu.generators import (
    n_queens_lp,
    random_knapsack_101_lp,
    random_qsap_lp,
    random_set_cover_lp,
)

import baryonyx_torch as bt
from baryonyx_torch.core.errors import FileAccessError
from baryonyx_torch.io import lp_parse as tlp
from baryonyx_torch.native import build as nbuild
from baryonyx_torch.native.lp import parse_lp_native, parse_lp_string_native

REPO = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def native():
    """The library, built here with g++ (every CPU machine of the tests
    has one)."""
    lib = nbuild.load_library()
    assert lib is not None, "the native LP parser did not build"
    return lib


def same_problem(a, b):
    assert a.type.name == b.type.name
    assert a.vars.names == b.vars.names
    assert [(v.min, v.max, v.type.name) for v in a.vars.values] == [
        (v.min, v.max, v.type.name) for v in b.vars.values
    ]
    assert a.objective.value == b.objective.value
    assert [(e.factor, e.variable_index) for e in a.objective.elements] == [
        (e.factor, e.variable_index) for e in b.objective.elements
    ]
    assert [
        (q.factor, q.variable_index_a, q.variable_index_b)
        for q in a.objective.qelements
    ] == [
        (q.factor, q.variable_index_a, q.variable_index_b)
        for q in b.objective.qelements
    ]
    for la, lb in (
        (a.equal_constraints, b.equal_constraints),
        (a.greater_constraints, b.greater_constraints),
        (a.less_constraints, b.less_constraints),
    ):
        assert len(la) == len(lb)
        for ca, cb in zip(la, lb):
            assert ca.label == cb.label
            assert ca.value == cb.value
            assert [(e.factor, e.variable_index) for e in ca.elements] == [
                (e.factor, e.variable_index) for e in cb.elements
            ]


TEXTS = {
    "nqueens6": n_queens_lp(6),
    "scp20x50": random_set_cover_lp(20, 50, 0.15, seed=3),
    "knapsack101": random_knapsack_101_lp(15, seed=4),
    "bounds_maximize": (
        "maximize\nobj: x1 + 2x2 + 3x3 - 100\nst\n"
        "time: -x1 + x2 + x3 <= 20\nbounds\nx1 <= 40\n-2 <= x2 <= 5\nend\n"
    ),
    "quadratic": (
        "minimize\nobj: x + [ 2 x * y + 4 y ^ 2 ] / 2\nst\nc: x + y >= 1\nend\n"
    ),
    "hash_names": (
        "minimize\nobj: Tr#1#0 + Ts#2#0\nst\nc: Tr#1#0 + Ts#2#0 >= 1\n"
        "bounds\n0 <= Tr#1#0 <= 1\n0 <= Ts#2#0 <= 1\nend\n"
    ),
    "qsap12x6": random_qsap_lp(12, 6, seed=2),
}


@pytest.mark.parametrize("name", list(TEXTS))
def test_native_matches_python_and_jax(name, native, tmp_path):
    text = TEXTS[name]
    path = tmp_path / "model.lp"
    path.write_text(text)
    from_file = parse_lp_native(str(path))
    from_buffer = parse_lp_string_native(text)
    python = tlp._Parser(tlp.tokenize(text)).parse()
    jax_pb = bx.parse_lp(text)
    for pb in (from_file, from_buffer, python):
        same_problem(pb, jax_pb)


def test_native_error(native, tmp_path):
    path = tmp_path / "bad.lp"
    path.write_text("frobnicate\nobj: x\nend\n")
    with pytest.raises(bt.FileFormatError):
        parse_lp_native(str(path))
    with pytest.raises(bt.FileFormatError):
        parse_lp_string_native("minimize\nobj: x +\nst\nc: x >= 1\n")
    # through the routing: a file path, and text over 64 KiB
    with pytest.raises(bt.FileFormatError):
        bt.make_problem(bt.make_context(0), str(path))
    long_bad = "\\ " + "x" * 70_000 + "\nfrobnicate\nobj: x\nend\n"
    with pytest.raises(bt.FileFormatError):
        bt.parse_lp(long_bad)


def test_routing_to_the_native_parser(native, tmp_path, monkeypatch):
    calls = []
    import baryonyx_torch.native.lp as nlp

    for name in ("parse_lp_native", "parse_lp_string_native"):
        real = getattr(nlp, name)
        monkeypatch.setattr(
            nlp, name, lambda *a, _r=real, _n=name: calls.append(_n) or _r(*a)
        )
    big = random_set_cover_lp(300, 1500, 0.03, seed=8)
    assert len(big) > tlp.NATIVE_MIN_CHARS
    small = TEXTS["scp20x50"]
    native_pb = bt.parse_lp(big)
    assert calls == ["parse_lp_string_native"]
    bt.parse_lp(small)
    assert calls == ["parse_lp_string_native"]  # short text: Python
    path = tmp_path / "small.lp"
    path.write_text(small)
    from_path = bt.make_problem(bt.make_context(0), str(path))
    assert calls[-1] == "parse_lp_native"
    same_problem(from_path, bx.parse_lp(small))

    monkeypatch.setenv("BARYONYX_TORCH_NO_NATIVE", "1")
    n_calls = len(calls)
    python_pb = bt.parse_lp(big)
    bt.make_problem(bt.make_context(0), str(path))
    assert len(calls) == n_calls
    same_problem(native_pb, python_pb)
    # a missing file is a FileAccessError
    monkeypatch.delenv("BARYONYX_TORCH_NO_NATIVE")
    with pytest.raises(FileAccessError):
        bt.make_problem(bt.make_context(0), str(tmp_path / "missing.lp"))


def test_library_lands_in_the_build_directory(native):
    path = nbuild.library_path()
    assert path.exists()
    assert path.parent == REPO / "build" / "native"
    assert not list((REPO / "baryonyx_torch" / "native").glob("*.so"))


def test_qsap500x10_parses_in_under_two_seconds(native):
    text = random_qsap_lp(500, 10, seed=3)
    t = time.monotonic()
    pb = bt.parse_lp(text)
    assert time.monotonic() - t < 2.0
    assert len(pb.vars.names) == 5000 and len(pb.objective.qelements) == 19_599
