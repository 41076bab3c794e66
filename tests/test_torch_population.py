"""Parity of the port's population machinery and row schedules with the
JAX package: hash_x, sort_population, batch_insert (victims drawn in the
test from the JAX key and handed to both), choose_solution_index and
crossover_mix (the JAX function's normal draw or bit mask handed to the
port's), and make_order's static policies and cycle switch. All exact:
integer and order results."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from baryonyx_tpu.core.context import make_context
from baryonyx_tpu.core.params import ConstraintOrder
from baryonyx_tpu.generators import random_set_cover_lp
from baryonyx_tpu.io.lp_parse import parse_lp
from baryonyx_tpu.ops.layout import compile_problem
from baryonyx_tpu.preprocess.fixing import preprocess
from baryonyx_tpu.preprocess.merge import make_merged_constraints
from baryonyx_tpu.solver import common as jcommon
from baryonyx_tpu.solver import population as jpop

import baryonyx_torch.core.params as tparams
from baryonyx_torch import convert
from baryonyx_torch.solver import common as tcommon
from baryonyx_torch.solver import population as tpop

N, P, R = 96, 20, 48


def _pop_np(seed=0):
    rng = np.random.default_rng(seed)
    x = (rng.random((P, N)) < 0.4).astype(np.int32)
    x[3] = x[7]  # a duplicate member
    value = rng.integers(0, 6, P).astype(np.float32)  # ties on value
    remaining = rng.integers(0, 3, P).astype(np.int32)
    return x, value, remaining


def _weights():
    return jpop.make_hash_weights(N, 11)


def _both_pops(x, value, remaining):
    hw = _weights()
    jp = jpop.Population(
        x=jnp.asarray(x), value=jnp.asarray(value),
        remaining=jnp.asarray(remaining),
        hash=jpop.hash_x(jnp.asarray(x), jnp.asarray(hw)),
    )
    tp = convert.population({k: np.asarray(v) for k, v in jp._asdict().items()}, "cpu")
    return jp, tp, hw


def _assert_pop_equal(jp, tp):
    for k in ("x", "value", "remaining", "hash"):
        np.testing.assert_array_equal(
            getattr(tp, k).numpy(), np.asarray(getattr(jp, k)).astype(
                np.int64 if k == "hash" else np.asarray(getattr(jp, k)).dtype
            ), err_msg=k,
        )


def test_hash_x_matches_uint32_sum():
    x, _, _ = _pop_np()
    hw = _weights()
    np.testing.assert_array_equal(tpop.make_hash_weights(N, 11), hw)
    jh = np.asarray(jpop.hash_x(jnp.asarray(x), jnp.asarray(hw)))
    th = tpop.hash_x(torch.as_tensor(x), torch.as_tensor(hw.astype(np.int64)))
    np.testing.assert_array_equal(th.numpy(), jh.astype(np.int64))


@pytest.mark.parametrize("minimize", [True, False])
def test_sort_population(minimize):
    jp, tp, _ = _both_pops(*_pop_np(1))
    _assert_pop_equal(
        jpop.sort_population(jp, minimize), tpop.sort_population(tp, minimize)
    )


@pytest.mark.parametrize("minimize", [True, False])
def test_batch_insert(minimize):
    x, value, remaining = _pop_np(2)
    jp, tp, hw = _both_pops(x, value, remaining)
    jp = jpop.sort_population(jp, minimize)
    tp = tpop.sort_population(tp, minimize)
    rng = np.random.default_rng(3)
    cx = (rng.random((R, N)) < 0.4).astype(np.int32)
    cx[5] = np.asarray(jp.x[0])  # duplicates of a member: deduped
    cx[6] = np.asarray(jp.x[1])
    cv = rng.integers(0, 6, R).astype(np.float32)
    cv[5], cv[6] = float(jp.value[0]), float(jp.value[1])
    cr = rng.integers(0, 3, R).astype(np.int32)
    cr[5], cr[6] = int(jp.remaining[0]), int(jp.remaining[1])
    cm = rng.random(R) < 0.7
    key = jax.random.key(4)
    # the victims JAX's batch_insert draws from this key; with R > P
    # several candidates share a victim (last writer wins)
    victims = np.array(jax.random.randint(key, (R,), P // 5, P))
    assert len(np.unique(victims)) < R
    jn = jpop.batch_insert(
        jp, jnp.asarray(cx), jnp.asarray(cv), jnp.asarray(cr),
        jnp.asarray(cm), key, jnp.asarray(hw), minimize,
    )
    tn = tpop.batch_insert(
        tp, torch.as_tensor(cx), torch.as_tensor(cv), torch.as_tensor(cr),
        torch.as_tensor(cm), torch.as_tensor(victims),
        torch.as_tensor(hw.astype(np.int64)), minimize,
    )
    _assert_pop_equal(jn, tn)


def _cp_pair():
    ctx = make_context(0)
    pb = preprocess(ctx, parse_lp(random_set_cover_lp(40, 160, 0.06, seed=5)))
    jcp = compile_problem(make_merged_constraints(ctx, pb), len(pb.vars.values))
    tcp = convert.compiled_problem(
        {f.name: np.asarray(getattr(jcp, f.name)) for f in dataclasses.fields(jcp)},
        device="cpu",
    )
    rng = np.random.default_rng(5)
    x = (rng.random((jcp.n, 16)) < 0.3).astype(np.int32)
    # quarter-step multipliers: their means are exact in float32, so
    # both packages see the same sort keys
    pi = (rng.integers(-8, 9, (jcp.m, 16)) / 4.0).astype(np.float32)
    return jcp, tcp, x, pi


DETERMINISTIC = [
    "none", "reversing", "infeasibility_decr", "infeasibility_incr",
    "lagrangian_decr", "lagrangian_incr",
]


@pytest.mark.parametrize("policy", DETERMINISTIC)
def test_make_order_static_and_cycle(policy):
    jcp, tcp, x, pi = _cp_pair()
    mp = jcp.m + 8
    jorder = np.asarray(
        jcommon.make_order(
            jcp, None, jnp.asarray(x), jnp.asarray(pi), jax.random.key(0), mp,
            static_policy=ConstraintOrder[policy],
        )
    )
    gen = torch.Generator().manual_seed(0)
    tx, tpi = torch.as_tensor(x), torch.as_tensor(pi)
    static = tcommon.make_order(
        tcp, None, tx, tpi, gen, mp, static_policy=tparams.ConstraintOrder[policy]
    )
    code = torch.tensor(tcommon.ORDER_CODES[tparams.ConstraintOrder[policy]])
    switched = tcommon.make_order(tcp, code, tx, tpi, gen, mp)
    np.testing.assert_array_equal(static.numpy(), jorder)
    np.testing.assert_array_equal(switched.numpy(), jorder)
    assert static.dtype == torch.int32 and (jorder[jcp.m:] == jcp.m).all()


def test_make_order_random_policies_are_permutations():
    _, tcp, x, pi = _cp_pair()
    gen = torch.Generator().manual_seed(1)
    for policy in ("random_sorting", "pi_sign_change"):
        o = tcommon.make_order(
            tcp, None, torch.as_tensor(x), torch.as_tensor(pi), gen, tcp.m,
            static_policy=tparams.ConstraintOrder[policy],
        )
        assert sorted(o.tolist()) == list(range(tcp.m))


def test_choose_solution_index_matches_jax(monkeypatch):
    """The index from a given normal draw: the JAX function's own draw is
    handed to the port's in place of ``torch.randn``."""
    real_randn = torch.randn
    for i, (mean, stddev) in enumerate(
        [(0.0, 0.3), (0.2, 0.5), (-0.1, 1.5), (0.0, 3.0)] * 8
    ):
        key = jax.random.PRNGKey(i)
        z = np.float32(jax.random.normal(key))
        want = jpop.choose_solution_index(key, P, mean, stddev)
        monkeypatch.setattr(torch, "randn", lambda *a, **kw: torch.tensor(z))
        got = tpop.choose_solution_index(torch.Generator(), P, mean, stddev)
        assert got.dtype == torch.int32 and got.shape == ()
        assert int(got) == int(want), (mean, stddev, z)
    monkeypatch.setattr(torch, "randn", real_randn)
    g = torch.Generator().manual_seed(3)
    idx = [int(tpop.choose_solution_index(g, P, 0.0, 0.5)) for _ in range(200)]
    assert 0 <= min(idx) and max(idx) < P and len(set(idx)) > 1


def test_crossover_mix_matches_jax(monkeypatch):
    """The mix from a given bit mask: the JAX function's coin flips become
    uniforms below 0.5 exactly where it takes x2's bit."""
    rng = np.random.default_rng(4)
    x1 = (rng.random((N, R)) < 0.5).astype(np.int32)
    x2 = (rng.random((N, R)) < 0.5).astype(np.int32)
    key = jax.random.PRNGKey(9)
    take2 = np.asarray(jax.random.bernoulli(key, 0.5, x1.shape))
    want = np.asarray(jpop.crossover_mix(key, jnp.asarray(x1), jnp.asarray(x2)))
    u = torch.as_tensor(np.where(take2, 0.25, 0.75).astype(np.float32))
    real_rand = torch.rand
    monkeypatch.setattr(torch, "rand", lambda *a, **kw: u)
    got = tpop.crossover_mix(torch.Generator(), torch.as_tensor(x1), torch.as_tensor(x2))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    monkeypatch.setattr(torch, "rand", real_rand)
    mixed = tpop.crossover_mix(
        torch.Generator().manual_seed(1), torch.as_tensor(x1), torch.as_tensor(x2)
    ).numpy()
    assert ((mixed == x1) | (mixed == x2)).all()
    assert (mixed != x1).any() and (mixed != x2).any()
