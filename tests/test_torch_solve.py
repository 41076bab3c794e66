"""Solve mode of the port against the JAX package's.

(a) Step parity: both packages' ``_step`` run a chain of sweeps from the
    same state (the JAX initial state, carried across with
    ``convert.device_state``) under the deterministic order policies. The
    test derives each step's sweep key as the JAX ``_step`` does
    (``jax.random.split(st.key, 3)``) and injects the noise drawn from it
    into the port. x, remaining, the best_* fields and the stop reason are
    equal at every step; kappa agrees within 1e-6.
(b) ``solve`` end to end on ``device="cpu"`` over the instance classes of
    tests/test_solve.py and one instance with integer factors: the same
    status as the JAX package, a result the numpy oracle accepts.
(c) Push rounds improve or keep the incumbent.
"""

import dataclasses
import glob
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import baryonyx_tpu as bx
from baryonyx_tpu.preprocess.merge import make_merged_constraints as jmerge
from baryonyx_tpu.solver import api as japi
from baryonyx_tpu.solver import common as jcommon
from baryonyx_tpu.solver import solve as jsolve
from baryonyx_tpu.ops.layout import compile_problem as jcompile

import baryonyx_torch as bt
from baryonyx_torch import convert
from baryonyx_torch.generators import (
    contradiction_cover_lp,
    n_queens_lp,
    random_assignment_lp,
    random_knapsack_101_lp,
    random_set_cover_lp,
    random_set_partition_lp,
    random_z_multiknapsack_lp,
)
from baryonyx_torch.ops.sweep import SweepNoise
from baryonyx_torch.solver import api as tapi
from baryonyx_torch.solver import solve as tsolve

# ---------------------------------------------------------------------------
# (a) step parity
# ---------------------------------------------------------------------------

STEPS = 24
PUSH_AT = (4, 8, 12, 16, 20)  # objective-amplified push sweeps over every row


def _setup(lp, order, seed=3):
    """Everything ``solve_compiled`` prepares before its loop, on the JAX
    side, and the port's copies of it."""
    ctx = bx.make_context(0)
    p = ctx.parameters
    p.seed, p.order = seed, order
    p.kappa_step = 0.01
    p.w = 3
    pb = japi._prepare(ctx, bx.parse_lp(lp))
    minimize = pb.type == bx.ObjectiveType.minimize
    n = len(pb.vars.values)
    constraints = jmerge(ctx, pb)
    jcp = jcompile(constraints, n, dtype=jnp.float32)
    rng = np.random.default_rng(seed)
    cost_orig = jcommon.build_cost_vector(pb, n)
    cost_norm = jcommon.normalize_costs(cost_orig, p.cost_norm, rng)
    pad = jcp.n - n
    cost_orig = np.pad(cost_orig, (0, pad))
    cost_norm = np.pad(cost_norm, (0, pad))
    x0 = np.pad(jcommon.initial_x(p, cost_orig[:n], constraints, minimize, rng), (0, pad))
    code = jcommon.ORDER_CODES.get(order, 0)
    jst = jsolve.make_initial_state(
        jcp, x0, p, jax.random.key(seed), jnp.float32, code, minimize
    )
    jhp = jsolve.make_hyper(p, cost_norm, jnp.float32)
    tcp = convert.compiled_problem(
        {f.name: np.asarray(getattr(jcp, f.name)) for f in dataclasses.fields(jcp)},
        device="cpu",
    )
    thp = tsolve.make_hyper(p, cost_norm, torch.float32)
    fields = {
        k: np.asarray(getattr(jst, k)) for k in jst._fields if k != "key"
    }
    tst = convert.device_state(fields, device="cpu")
    return dict(
        p=p, pb=pb, minimize=minimize, jcp=jcp, tcp=tcp, jst=jst, tst=tst,
        jhp=jhp, thp=thp, cost_norm=cost_norm, cost_orig=cost_orig,
        cc=float(pb.objective.value),
    )


def _noise(k_sweep, n_blocks, shape):
    tie = []
    for b in range(n_blocks):
        k_tie, _ = jax.random.split(jax.random.fold_in(k_sweep, b))
        tie.append(np.array(jax.random.uniform(k_tie, shape, dtype=jnp.float32)))
    return SweepNoise(torch.as_tensor(np.stack(tie)))


STEP_CASES = {
    "queens8_none": (lambda: n_queens_lp(8), bx.ConstraintOrder.none),
    "queens8_reversing": (lambda: n_queens_lp(8), bx.ConstraintOrder.reversing),
    "scp_infeasibility_decr": (
        lambda: random_set_cover_lp(30, 100, 0.1, seed=3),
        bx.ConstraintOrder.infeasibility_decr,
    ),
    "scp_lagrangian_incr": (
        lambda: random_set_cover_lp(30, 100, 0.1, seed=3),
        bx.ConstraintOrder.lagrangian_incr,
    ),
}


@pytest.mark.parametrize("name", list(STEP_CASES))
def test_step_chain_matches_jax(name):
    lp, order = STEP_CASES[name]
    s = _setup(lp(), order)
    B = s["p"].block_size
    jcp, tcp = s["jcp"], s["tcp"]
    mp = -(-jcp.m // B) * B
    jcn, jco = jnp.asarray(s["cost_norm"], jnp.float32), jnp.asarray(s["cost_orig"], jnp.float32)
    tcn, tco = torch.as_tensor(s["cost_norm"], dtype=torch.float32), torch.as_tensor(s["cost_orig"], dtype=torch.float32)
    jst, tst = s["jst"], s["tst"]
    torder = bt.ConstraintOrder[order.name]
    swept = 0
    for it in range(STEPS):
        push = it in PUSH_AT
        _, _, k_sweep = jax.random.split(jst.key, 3)
        noise = _noise(k_sweep, mp // B, (B, jcp.Kr, 1))
        swept += int(jst.remaining[0]) > 0 or push
        jst = jsolve._step(
            jcp, jcn, jco, jnp.float32(s["cc"]), jst, s["jhp"], s["minimize"], B,
            s["jhp"]["pushing_objective_amplifier"] if push else None,
            anneal_counter=None if push else jst.loop, order_policy=order,
        )
        tst = tsolve._step(
            tcp, tcn, tco, s["cc"], tst, s["thp"], s["minimize"], B,
            s["thp"]["pushing_objective_amplifier"] if push else None,
            anneal_counter=None if push else tst.loop, order_policy=torder,
            noise=noise,
        )
        assert tst.loop == int(jst.loop) == it + 1
        assert np.array_equal(tst.x.numpy(), np.asarray(jst.x)), (name, it)
        assert np.array_equal(tst.viol.numpy(), np.asarray(jst.viol))
        assert int(tst.remaining[0]) == int(jst.remaining[0])
        assert np.array_equal(tst.best_x.numpy(), np.asarray(jst.best_x))
        assert int(tst.best_remaining[0]) == int(jst.best_remaining[0])
        assert int(tst.best_loop[0]) == int(jst.best_loop[0])
        assert float(tst.best_value[0]) == float(jst.best_value[0])
        assert tst.stop_reason == int(jst.stop_reason)
        assert tst.order_code == int(jst.order_code)
        assert abs(float(tst.kappa[0]) - float(jst.kappa[0])) <= 1e-6
        np.testing.assert_allclose(
            tst.pi.numpy(), np.asarray(jst.pi), rtol=1e-5, atol=1e-5
        )
    # a set cover is feasible after a sweep or two: there the push sweeps
    # over every row, and the repairs after them, are what the chain runs
    assert swept >= (10 if name.startswith("queens") else 6), swept
    if name.startswith("queens"):
        assert float(tst.kappa[0]) > 0  # the anneal ran


# ---------------------------------------------------------------------------
# (b) solve end to end
# ---------------------------------------------------------------------------


def _ctx(mod, limit=500, seed=42, **kw):
    """A run's context. The push phase is cut to 3 rounds of 10 sweeps
    (from 100 of 50) unless the case sets it: the port's sweeps are eager
    PyTorch calls, about a millisecond each on the CPU."""
    ctx = mod.make_context(0)
    ctx.parameters.seed = seed
    ctx.parameters.limit = limit
    ctx.parameters.pushes_limit = 3
    ctx.parameters.pushing_iteration_limit = 10
    for k, v in kw.items():
        if hasattr(v, "name"):  # an enum: take the module's own
            v = getattr(getattr(mod, type(v).__name__), v.name)
        setattr(ctx.parameters, k, v)
    return ctx


def _tsolve(lp, **kw):
    pb = bt.parse_lp(lp)
    return pb, bt.solve(_ctx(bt, **kw), pb, device="cpu")


def solve_ok(lp, **kw):
    pb, r = _tsolve(lp, **kw)
    assert r.status == bt.ResultStatus.success, r.status
    assert bt.is_valid_solution(pb, r)
    return pb, r


def _queens_costs():
    import random

    rng = random.Random(123)
    return [rng.uniform(0, 1) for _ in range(64)]


CLASSES = {
    "assignment": (lambda: random_assignment_lp(4, seed=1), {}),
    "queens8": (lambda: n_queens_lp(8), {}),
    "queens8_costs": (lambda: n_queens_lp(8, costs=_queens_costs()), {}),
    "set_cover": (lambda: random_set_cover_lp(30, 100, density=0.1, seed=3), {}),
    "set_partition": (
        lambda: random_set_partition_lp(40, 10, extra_columns=60, seed=5), {}
    ),
    "pm1_maximize": (lambda: random_knapsack_101_lp(20, seed=7), {}),
    "negative_ineq": (
        lambda: "minimize\nobj: x + 2 y\nst\nc1: x - y <= 0\nc2: x + y >= 1\nend\n",
        {},
    ),
    "negative_eq": (
        lambda: "minimize\nobj: x + y\nst\nc1: x - y = 0\nc2: x + y = 2\nend\n", {}
    ),
    "all_fixed": (lambda: "minimize\nobj: x + y\nst\nc1: x + y = 2\nend\n", {}),
    "maximize": (
        lambda: "maximize\nobj: 2 x + 3 y + z\nst\nc1: x + y + z <= 2\nend\n", {}
    ),
    "exact_enum": (
        lambda: "minimize\n3 a + 2 b + 4 c + d\nsubject to\na + b >= 1\n"
        "b + c >= 1\nc + d >= 1\nbinary\na b c d\nend\n",
        {},
    ),
    "block_size_1": (
        lambda: random_set_cover_lp(20, 60, density=0.15, seed=11),
        dict(block_size=1),
    ),
    # an infeasible instance: the loop limit ends the run in both packages
    "infeasible_limit": (
        lambda: contradiction_cover_lp(3, 20, seed=1), dict(limit=40)
    ),
    # ... and a large kappa step ends it at kappa_max
    "infeasible_kappa": (
        lambda: contradiction_cover_lp(3, 20, seed=1),
        dict(limit=2000, kappa_step=0.05, w=2),
    ),
}


@pytest.mark.parametrize("name", list(CLASSES))
def test_solve_same_status_as_jax_and_valid(name):
    lp, kw = CLASSES[name]
    text = lp()
    pb, r = _tsolve(text, **kw)
    jpb = bx.parse_lp(text)
    jr = bx.solve(_ctx(bx, **kw), jpb)
    assert r.status.name == jr.status.name
    assert r.method == jr.method
    if jr.status == bx.ResultStatus.success:
        assert bt.is_valid_solution(pb, r)
    else:
        assert r.remaining_constraints > 0
        assert bool(r.solutions) == bool(jr.solutions)
        if r.solutions:
            assert r.solutions[-1].value == jr.solutions[-1].value == float("inf")
    if name in ("all_fixed", "exact_enum", "queens8"):
        assert bt.compute_solution(pb, r) == bx.compute_solution(jpb, jr)
    if name == "negative_eq":
        assert r.solution_map() == {"x": 1, "y": 1}


def test_solve_z_instance_valid_like_jax():
    text = random_z_multiknapsack_lp(6, 24, seed=2)
    kw = dict(limit=300, pushes_limit=1, pushing_iteration_limit=5)
    pb, r = _tsolve(text, **kw)
    jr = bx.solve(_ctx(bx, **kw), bx.parse_lp(text))
    assert r.status.name == jr.status.name == "success"
    assert bt.is_valid_solution(pb, r)
    assert r.sweeps > 0


def test_solve_z_with_random_solver_raises_as_jax_does():
    text = random_z_multiknapsack_lp(6, 24, seed=2)
    with pytest.raises(NotImplementedError, match="random solver for Z"):
        _tsolve(text, solver=bt.SolverType.random)
    with pytest.raises(NotImplementedError, match="random solver for Z"):
        bx.solve(_ctx(bx, solver=bx.SolverType.random), bx.parse_lp(text))


@pytest.mark.parametrize("order", [o.name for o in bt.ConstraintOrder])
def test_order_policies(order):
    solve_ok(n_queens_lp(6), order=bt.ConstraintOrder[order], limit=3000)


@pytest.mark.parametrize("norm", [c.name for c in bt.CostNormType])
def test_cost_norms(norm):
    solve_ok(
        random_set_cover_lp(15, 40, density=0.2, seed=13),
        cost_norm=bt.CostNormType[norm],
    )


@pytest.mark.parametrize("policy", [c.name for c in bt.InitPolicyType])
def test_init_policies(policy):
    solve_ok(random_assignment_lp(4, seed=17), init_policy=bt.InitPolicyType[policy])


def test_float64_path():
    _, r = solve_ok(
        random_set_cover_lp(30, 100, density=0.1, seed=3),
        float_type=bt.FloatType.float64,
    )
    assert r.sweeps > 0


def test_random_solver_runs_the_loop():
    pb, r = _tsolve(
        random_set_cover_lp(15, 40, density=0.2, seed=13),
        solver=bt.SolverType.random, limit=50,
    )
    assert r.method == "solve" and r.sweeps > 0
    if r.status == bt.ResultStatus.success:
        assert bt.is_valid_solution(pb, r)


def test_time_limit_status():
    _, r = _tsolve(
        contradiction_cover_lp(3, 20, seed=1), limit=10**9, time_limit=0.3,
        kappa_step=1e-9,
    )
    assert r.status == bt.ResultStatus.time_limit_reached
    assert 0.3 <= r.duration < 5.0


def test_infeasible_at_compile_time():
    # 15 elements with gcd 4 and an equality right-hand side of 2: no
    # multiple of 4 lies in [2, 2], which compile_problem proves
    names = [f"x{i}" for i in range(15)]
    text = (
        "minimize\nobj: " + " + ".join(names) + "\nsubject to\nc1: "
        + " + ".join(f"4 {v}" for v in names) + " = 2\nbinary\n"
        + " ".join(names) + "\nend\n"
    )
    r = bt.solve(_ctx(bt, time_limit=1.0), bt.parse_lp(text), device="cpu")
    jr = bx.solve(_ctx(bx, time_limit=1.0), bx.parse_lp(text))
    assert r.status.name == jr.status.name == "limit_reached"
    assert r.remaining_constraints == jr.remaining_constraints == 1
    assert not r.solutions


def test_solve_needs_a_device_or_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bt.solve(_ctx(bt), bt.parse_lp(n_queens_lp(6)))


def test_debug_row_trace(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    pb, r = _tsolve(
        random_set_cover_lp(12, 40, 0.15, seed=4), seed=3, limit=30, debug=True,
        init_policy_random=0.0,
    )
    logs = glob.glob(str(tmp_path / "baryonyx-debug-*.log"))
    assert logs, "debug trace file missing"
    lines = open(logs[0]).read().splitlines()
    assert lines, "trace is empty"
    pat = re.compile(
        r"^sweep=\d+ k=\d+ pi=-?[\d.e+-]+ dpi=-?[\d.e+-]+ violated=[01]$"
    )
    assert all(pat.match(l) for l in lines[:50])
    ks = {int(l.split()[1].split("=")[1]) for l in lines}
    assert max(ks) < 16  # padded row count upper bound for 12 rows


def test_print_level_reports_the_dual_bound(capsys):
    pb = bt.parse_lp(random_set_cover_lp(30, 100, density=0.1, seed=3))
    ctx = bt.make_context(6)
    ctx.parameters.seed, ctx.parameters.limit = 42, 200
    ctx.parameters.print_level = 1
    bt.solve(ctx, pb, device="cpu")
    out = capsys.readouterr()
    assert "dual-bound" in out.out + out.err


def test_dual_bound_and_initial_x_match_jax_twins():
    """Solve mode is the first caller of these in the port."""
    from baryonyx_torch.solver import common as tcommon

    s = _setup(random_set_cover_lp(30, 100, 0.1, seed=3), bx.ConstraintOrder.none)
    rng = np.random.default_rng(0)
    pi = rng.standard_normal(s["jcp"].m)
    for minimize in (True, False):
        a = jcommon.dual_bound(s["jcp"], pi, s["cost_norm"], minimize)
        b = tcommon.dual_bound(s["tcp"], pi, s["cost_norm"], minimize)
        assert a == pytest.approx(b, rel=1e-12)
    ctx = bx.make_context(0)
    jpb = japi._prepare(ctx, bx.parse_lp(random_assignment_lp(4, seed=17)))
    tpb = tapi._prepare(
        bt.make_context(0), bt.parse_lp(random_assignment_lp(4, seed=17))
    )
    n = len(jpb.vars.values)
    c = jcommon.build_cost_vector(jpb, n)
    for pol in bx.InitPolicyType:
        jp, tp = bx.SolverParameters(), bt.SolverParameters()
        jp.init_policy, tp.init_policy = pol, bt.InitPolicyType[pol.name]
        a = jcommon.initial_x(jp, c, jmerge(ctx, jpb), True, np.random.default_rng(5))
        from baryonyx_torch.preprocess.merge import make_merged_constraints as tmerge

        b = tcommon.initial_x(
            tp, c, tmerge(bt.make_context(0), tpb), True, np.random.default_rng(5)
        )
        assert np.array_equal(a, b)


# ---------------------------------------------------------------------------
# (c) push rounds
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["set_cover", "set_partition"])
def test_push_rounds_improve_or_keep_the_incumbent(name):
    lp, _ = CLASSES[name]
    text = lp()
    pb, r0 = solve_ok(text, pushes_limit=0)
    _, r1 = solve_ok(text, pushes_limit=8, pushing_iteration_limit=20)
    v0, v1 = bt.compute_solution(pb, r0), bt.compute_solution(pb, r1)
    assert r1.sweeps > r0.sweeps
    if pb.type == bt.ObjectiveType.minimize:
        assert v1 <= v0
    else:
        assert v1 >= v0
