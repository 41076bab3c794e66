"""Quadratic objectives in the port's optimize, against the JAX package,
on the CPU.

- Set-up: with the same seed both packages normalize the linear and the
  quadratic factors to the same float32 values, build the same dense
  ``quad_mat`` and the same (qa, qb, factor) terms (all bit for bit), and
  the step's quadratic objective term agrees within 1e-5 relative (float32
  sums in another order).
- At a fixed 200-sweep budget (16 replicas, seed 42, as in
  tests/test_torch_optimize.py) the port's result is valid and within 15%
  of the JAX optimizer's, on a quadratic semi-assignment instance of 72
  variables (the fused sweep's plain version with CQ = quad_mat @ x), on a
  row with integer factors and a quadratic term (the Z sweep with
  ``quad_fac``), and in float64 (the general sweep with ``quad_fac``).
- Past ``QUAD_DENSE_MAX_N`` variables the optimizer warns and runs the
  general sweep; no dense matrix is built.
"""

import contextlib
import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import baryonyx_tpu as bx
from baryonyx_tpu.generators import random_qsap_lp
from baryonyx_tpu.solver import optimize as jopt

import baryonyx_torch as bt
from baryonyx_torch.core.context import MessageLevel
from baryonyx_torch.solver import optimize as topt

BAND = 0.15
QSAP = random_qsap_lp(12, 6, seed=2)
# 24 variables of factor 2 (past the exact enumeration), and a penalty of
# 2 for taking the two cheapest together: the optimum is x0 + x2 = 4
Z_QUAD = "minimize\nobj: {} + [ 4 x0 * x1 ] / 2\nst\nc1: {} >= 4\nend\n".format(
    " + ".join(f"{i + 1} x{i}" for i in range(24)),
    " + ".join(f"2 x{i}" for i in range(24)),
)


@pytest.fixture(autouse=True)
def one_torch_thread():
    """Eager torch ops on these small tensors gain nothing from threads,
    and the test workers share the machine's cores: one thread each."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _ctx(mod, **kw):
    ctx = mod.make_context(0)
    ctx.parameters.seed = 42
    ctx.parameters.limit = 200  # no time limit: a fixed 200-sweep budget
    ctx.parameters.thread = 16
    for k, v in kw.items():
        setattr(ctx.parameters, k, v)
    return ctx


def test_quadratic_setup_matches_jax(monkeypatch):
    seen = {}

    def jax_evolve(real):
        # the tests' JAX runs on 8 virtual CPU devices: evolve_sharded
        def fn(*a, **kw):
            seen.setdefault("jax", a)
            return real(*a, **kw)
        return fn

    def torch_evolve(ev, st, k):
        seen.setdefault("torch", ev)
        return real_t(ev, st, k)

    real_t = topt.evolve
    for name in ("evolve", "evolve_sharded"):
        monkeypatch.setattr(jopt, name, jax_evolve(getattr(jopt, name)))
    monkeypatch.setattr(topt, "evolve", torch_evolve)
    bx.optimize(_ctx(bx, limit=1, chunk_size=1), bx.parse_lp(QSAP))
    bt.optimize(_ctx(bt, limit=1, chunk_size=1), bt.parse_lp(QSAP), device="cpu")

    cn, hp = seen["jax"][1], seen["jax"][6]
    ev = seen["torch"]
    np.testing.assert_array_equal(ev.cost_norm.numpy(), np.asarray(cn))
    np.testing.assert_array_equal(ev.quad_fac.numpy(), np.asarray(hp["quad_fac"]))
    np.testing.assert_array_equal(ev.quad_mat.numpy(), np.asarray(hp["quad_mat"]))
    assert ev.quad_mat.dtype == torch.float32
    qa, qb, qfv = ev.quad_terms
    np.testing.assert_array_equal(qa.numpy(), np.asarray(hp["qa"]))
    np.testing.assert_array_equal(qb.numpy(), np.asarray(hp["qb"]))
    np.testing.assert_array_equal(qfv.numpy(), np.asarray(hp["qfv"]))
    assert len(qfv) == len(bt.parse_lp(QSAP).objective.qelements)

    # the step's quadratic term, as the JAX one_step writes it
    n = ev.quad_mat.shape[0]
    x = (np.random.default_rng(5).random((n, 16)) < 0.3).astype(np.int32)
    want = jnp.einsum(
        "q,qr->r", hp["qfv"],
        jnp.asarray(x)[hp["qa"]].astype(jnp.float32)
        * jnp.asarray(x)[hp["qb"]].astype(jnp.float32),
    )
    got = topt.quad_value(ev.quad_terms, torch.as_tensor(x), torch.float32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


CASES = {
    # name: (LP text, parameters, the sweep the port runs)
    "qsap": (QSAP, {}, "psweep"),
    "z_quad": (Z_QUAD, {}, "z_sweep"),
    "float64": (QSAP, dict(float_type="float64"), "sweep"),
}


@pytest.mark.parametrize("name", list(CASES))
def test_quadratic_optimize_matches_jax_within_band(name, monkeypatch):
    lp, kw, route = CASES[name]

    def ctx_of(mod):
        ctx = _ctx(mod)
        for k, v in kw.items():
            setattr(ctx.parameters, k, getattr(mod.FloatType, v))
        return ctx

    calls = {"psweep": 0, "sweep": 0, "z_sweep": 0}

    def counted(fn_name, real):
        def fn(*a, **k):
            calls[fn_name] += 1
            return real(*a, **k)
        return fn

    monkeypatch.setattr(topt, "sweep", counted("sweep", topt.sweep))
    monkeypatch.setattr(topt.pw, "psweep", counted("psweep", topt.pw.psweep))
    monkeypatch.setattr(topt.zs, "z_sweep", counted("z_sweep", topt.zs.z_sweep))
    raw_t = bt.parse_lp(lp)
    rt = bt.optimize(ctx_of(bt), raw_t, device="cpu")
    assert calls[route] == 200 and sum(calls.values()) == 200
    raw_j = bx.parse_lp(lp)
    with jax.enable_x64(name == "float64"):
        rj = bx.optimize(ctx_of(bx), raw_j)
    assert rj.status == bx.ResultStatus.success
    assert rt.status == bt.ResultStatus.success
    assert rt.loop == rj.loop == 200 and "exact" not in rt.method
    assert bx.is_valid_solution(raw_j, rt)
    assert bx.compute_solution(raw_j, rt) == pytest.approx(rt.value)
    assert abs(rt.value - rj.value) <= BAND * abs(rj.value)
    if name == "z_quad":
        assert rt.value == rj.value == 4.0


def test_dense_limit_warns_and_takes_the_general_sweep(monkeypatch):
    monkeypatch.setattr(topt.pw, "QUAD_DENSE_MAX_N", 16)
    calls = {"psweep": 0, "sweep": 0}
    real_sweep, real_psweep = topt.sweep, topt.pw.psweep

    def sweep(*a, **k):
        calls["sweep"] += 1
        return real_sweep(*a, **k)

    def psweep(*a, **k):
        calls["psweep"] += 1
        return real_psweep(*a, **k)

    built = []
    real_dense = topt.dense_quad_matrix
    monkeypatch.setattr(topt, "sweep", sweep)
    monkeypatch.setattr(topt.pw, "psweep", psweep)
    monkeypatch.setattr(
        topt, "dense_quad_matrix", lambda *a: built.append(1) or real_dense(*a)
    )
    ctx = _ctx(bt, limit=20, chunk_size=20)
    ctx.log_priority = MessageLevel.warning
    said = io.StringIO()
    raw = bt.parse_lp(QSAP)
    with contextlib.redirect_stdout(said):
        r = bt.optimize(ctx, raw, device="cpu")
    assert "exceeds the fused kernel's 16-variable dense limit" in said.getvalue()
    assert calls == {"psweep": 0, "sweep": 20} and not built
    assert r.loop == 20
    if r.status == bt.ResultStatus.success:
        assert bt.is_valid_solution(raw, r)
