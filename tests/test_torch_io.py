"""The port's LP writer and solution files against the JAX package's:
``write_problem`` → ``parse_lp`` round trips, and both packages write the
same text for the same problem and the same result."""

import io

import pytest

import baryonyx_tpu as bx
from baryonyx_tpu.io.sol_io import problem_resume as jresume

import baryonyx_torch as bt
from baryonyx_torch.generators import (
    n_queens_lp,
    random_assignment_lp,
    random_knapsack_101_lp,
    random_qsap_lp,
    random_set_cover_lp,
    random_z_multiknapsack_lp,
)
from baryonyx_torch.io.sol_io import problem_resume, read_result

LPS = {
    "assignment": lambda: random_assignment_lp(4, seed=1),
    "queens": lambda: n_queens_lp(5),
    "set_cover": lambda: random_set_cover_lp(12, 40, 0.2, seed=3),
    "pm1_maximize": lambda: random_knapsack_101_lp(8, 20, seed=3),
    "quadratic": lambda: random_qsap_lp(4, 3, seed=2),
    "integer_factors": lambda: random_z_multiknapsack_lp(8, 30, seed=2),
    "three_operators": lambda: (
        "maximize\nobj: 2 x + 3 y - z\nst\nc1: x + y + z <= 2\n"
        "c2: x - z <= 1\nc3: x + y >= 1\nc4: y + z = 1\nbinary\nx y z\nend\n"
    ),
}


def _same_problem(a, b):
    assert a.type.name == b.type.name
    assert list(a.vars.names) == list(b.vars.names)
    assert [(e.factor, e.variable_index) for e in a.objective.elements] == [
        (e.factor, e.variable_index) for e in b.objective.elements
    ]
    assert a.objective.value == b.objective.value
    assert [
        (q.factor, q.variable_index_a, q.variable_index_b)
        for q in a.objective.qelements
    ] == [
        (q.factor, q.variable_index_a, q.variable_index_b)
        for q in b.objective.qelements
    ]
    for group in ("equal_constraints", "greater_constraints", "less_constraints"):
        ga, gb = getattr(a, group), getattr(b, group)
        assert len(ga) == len(gb)
        for ca, cb in zip(ga, gb):
            assert ca.value == cb.value
            assert [(e.factor, e.variable_index) for e in ca.elements] == [
                (e.factor, e.variable_index) for e in cb.elements
            ]


@pytest.mark.parametrize("name", list(LPS))
def test_write_problem_round_trip_and_same_text_as_jax(name):
    text = LPS[name]()
    pb = bt.parse_lp(text)
    out = io.StringIO()
    bt.write_problem(pb, out)
    written = out.getvalue()
    _same_problem(bt.parse_lp(written), pb)
    jout = io.StringIO()
    bx.write_problem(bx.parse_lp(text), jout)
    assert written == jout.getvalue()
    assert problem_resume(pb) == jresume(bx.parse_lp(text))


def _results(text, **kw):
    out = []
    for mod, dev in ((bt, dict(device="cpu")), (bx, {})):
        ctx = mod.make_context(0)
        ctx.parameters.seed = 42
        ctx.parameters.limit = 300
        ctx.parameters.pushes_limit = 1
        ctx.parameters.pushing_iteration_limit = 5
        for k, v in kw.items():
            setattr(ctx.parameters, k, v)
        out.append(mod.solve(ctx, mod.parse_lp(text), **dev))
    return out


@pytest.mark.parametrize("name", ["assignment", "three_operators"])
def test_write_result_same_text_as_jax(name):
    """Both instances are solved by exact enumeration, so both packages
    hold the same solution; the duration is set equal."""
    text = LPS[name]()
    rt, rj = _results(text)
    assert rt.method == rj.method and "exact-enum" in rt.method
    rt.duration = rj.duration = 0.25
    assert bt.write_result(rt) == bx.write_result(rj)
    buf = io.StringIO()
    bt.write_result(rt, buf)
    assert buf.getvalue() == bt.write_result(rt)


def test_write_result_without_a_solution_same_text_as_jax():
    from baryonyx_torch.generators import contradiction_cover_lp

    rt, rj = _results(contradiction_cover_lp(3, 20, seed=1), limit=20)
    assert rt.status.name == rj.status.name == "limit_reached"
    rt.duration = rj.duration = 0.25
    rt.loop = rj.loop
    rt.remaining_constraints = rj.remaining_constraints
    assert bt.write_result(rt) == bx.write_result(rj)


def test_make_result_reads_what_write_result_wrote(tmp_path):
    text = LPS["queens"]()
    pb = bt.parse_lp(text)
    ctx = bt.make_context(0)
    ctx.parameters.seed, ctx.parameters.limit = 42, 2000
    ctx.parameters.pushes_limit = 1
    r = bt.solve(ctx, pb, device="cpu")
    assert r.status == bt.ResultStatus.success
    path = tmp_path / "queens.sol"
    with open(path, "w") as fh:
        bt.write_result(r, fh)
    back = bt.make_result(bt.make_context(0), str(path))
    assert back.status == bt.ResultStatus.success
    assert back.solution_map() == r.solution_map()
    assert bt.is_valid_solution(pb, back)
    assert bt.compute_solution(pb, back) == bt.compute_solution(pb, r) == 5.0
    # the JAX package's reader takes the same file
    jback = bx.make_result(bx.make_context(0), str(path))
    assert jback.solution_map() == r.solution_map()
    r2 = read_result(io.StringIO(bt.write_result(r)))
    assert r2.solution_map() == r.solution_map()


def test_min_max_objective_matches_jax():
    for name in ("set_cover", "pm1_maximize", "three_operators"):
        text = LPS[name]()
        a = bt.compute_min_max_objective_function(bt.parse_lp(text).objective)
        b = bx.compute_min_max_objective_function(bx.parse_lp(text).objective)
        assert tuple(a) == tuple(b)
