"""Parity of the port's row activities, violation masks and merged column
sums with the JAX package's ops/sweep.py, to atol 1e-5 (float32 sums
taken in another order)."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from baryonyx_tpu.core.context import make_context
from baryonyx_tpu.generators import random_knapsack_101_lp, random_set_cover_lp
from baryonyx_tpu.io.lp_parse import parse_lp
from baryonyx_tpu.ops import sweep as jsweep
from baryonyx_tpu.ops.layout import compile_problem
from baryonyx_tpu.preprocess.fixing import preprocess
from baryonyx_tpu.preprocess.merge import make_merged_constraints

from baryonyx_torch import convert
from baryonyx_torch.ops import sweep as tsweep

R = 64
ATOL = 1e-5

LPS = {
    "scp": lambda: random_set_cover_lp(40, 160, 0.06, seed=5),
    "knapsack101": lambda: random_knapsack_101_lp(16, 40, seed=3),
}


def _problem(name):
    ctx = make_context(0)
    pb = preprocess(ctx, parse_lp(LPS[name]()))
    jcp = compile_problem(make_merged_constraints(ctx, pb), len(pb.vars.values))
    tcp = convert.compiled_problem(
        {f.name: np.asarray(getattr(jcp, f.name)) for f in dataclasses.fields(jcp)},
        device="cpu",
    )
    return jcp, tcp


def _state(cp, seed=0):
    rng = np.random.default_rng(seed)
    x = (rng.random((cp.n, R)) < 0.3).astype(np.int32)
    P = rng.normal(0.0, 0.1, (cp.m, cp.Kr, R)).astype(np.float32)
    pi = rng.normal(0.0, 0.1, (cp.m, R)).astype(np.float32)
    return x, P, pi


@pytest.mark.parametrize("name", list(LPS))
@pytest.mark.parametrize("ndim", [1, 2])
def test_activities_and_violated_mask(name, ndim):
    """ndim 2 takes the dense matmul, ndim 1 the padded-row gather."""
    jcp, tcp = _problem(name)
    x, _, _ = _state(jcp)
    if ndim == 1:
        x = x[:, 0]
    ja = np.asarray(jsweep.activities(jcp, jnp.asarray(x)))
    ta = tsweep.activities(tcp, torch.as_tensor(x)).numpy()
    np.testing.assert_allclose(ta, ja, rtol=0, atol=ATOL)
    jv = np.asarray(jsweep.violated_mask(jcp, jnp.asarray(x)))
    tv = tsweep.violated_mask(tcp, torch.as_tensor(x)).numpy()
    np.testing.assert_array_equal(tv, jv)


@pytest.mark.parametrize("name", list(LPS))
def test_column_sums(name):
    jcp, tcp = _problem(name)
    _, P, pi = _state(jcp, seed=1)
    js = np.asarray(jsweep.column_sums(jcp, jnp.asarray(P), jnp.asarray(pi)))
    ts = tsweep.column_sums(tcp, torch.as_tensor(P), torch.as_tensor(pi)).numpy()
    np.testing.assert_allclose(ts, js, rtol=0, atol=ATOL)
