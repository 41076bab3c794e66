"""Parity of the port's fused sweep with the JAX package's Pallas sweep.

The JAX side runs ``psweep(..., interpret=True)``, the Pallas interpreter
with its splitmix counter hash for the tie noise; the port's plain PyTorch
version uses the same hash, seeded with the same pair derived from the JAX
key. Costs have distinct, irregular gaps (as in tests/test_psweep.py), so
both must make identical selections: x and remaining bit-exact, P and pi
within atol 2e-4, S within atol 2e-3 (float32 sums in another order).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from baryonyx_tpu.core.context import make_context
from baryonyx_tpu.generators import random_knapsack_101_lp, random_set_cover_lp
from baryonyx_tpu.io.lp_parse import parse_lp
from baryonyx_tpu.ops import psweep as jpw
from baryonyx_tpu.ops.layout import compile_problem
from baryonyx_tpu.ops.sweep import violated_mask as jviolated
from baryonyx_tpu.preprocess.fixing import preprocess
from baryonyx_tpu.preprocess.merge import make_merged_constraints

from baryonyx_torch import convert
from baryonyx_torch.ops import psweep as tpw
from baryonyx_torch.ops.sweep import violated_mask as tviolated

R = 512
SWEEPS = 3


def _compiled(lp):
    ctx = make_context(0)
    pb = preprocess(ctx, parse_lp(lp))
    cp = compile_problem(make_merged_constraints(ctx, pb), len(pb.vars.values))
    cost = 1.0 + np.arange(cp.n) + 0.01 * ((np.arange(cp.n) * 37) % 61)
    return cp, cost.astype(np.float32)


def seed_pair(key) -> np.ndarray:
    """The seed pair the JAX kernel derives from its key
    (baryonyx_tpu/ops/psweep.py, _psweep_call)."""
    k = jax.random.key_data(jax.random.fold_in(key, 7)).astype(jnp.uint32)
    return np.array(k.reshape(-1)[:2].astype(jnp.int32))


def _inputs(cp, sched_fraction):
    rng = np.random.default_rng(0)
    x = (rng.random((cp.n, R)) < 0.2).astype(np.int32)
    kappa = np.full(R, 0.15, np.float32)
    amp = np.zeros(R, np.float32)
    # a partial schedule: some (row, replica) pairs sit out, and the rows
    # nobody schedules are compacted out of the order (n_rows < m)
    keep = rng.random((cp.m, R)) < sched_fraction
    row_off = rng.random(cp.m) < (1.0 - sched_fraction)
    keep[row_off] = False
    return x, kappa, amp, keep


def _compact(order, sched, m):
    any_row = np.concatenate([sched.any(axis=1), [False]])[np.minimum(order, m)]
    return order[np.argsort(~any_row, kind="stable")], int(any_row.sum())


def _run_jax(cp, cost, x, kappa, amp, keep, minimize, Bb):
    x = jnp.asarray(x)
    P = jnp.zeros((cp.m, cp.Kr, R), jnp.float32)
    pi = jnp.zeros((cp.m, R), jnp.float32)
    S = None
    sched = np.asarray(jviolated(cp, x)) & keep
    for it in range(SWEEPS):
        order, n_rows = _compact(np.arange(cp.m, dtype=np.int32), sched, cp.m)
        x, P, pi, S, viol, rem = jpw.psweep(
            cp, x, P, pi, jnp.asarray(cost), jnp.asarray(sched),
            jnp.asarray(order), jnp.asarray(kappa), jnp.float32(0.01),
            jnp.float32(0.5), jax.random.key(it + 1), jnp.asarray(amp),
            n_rows=jnp.asarray(n_rows, jnp.int32), minimize=minimize,
            block_size=Bb, S=S, S_fresh=jnp.asarray(it != 0), interpret=True,
        )
        sched = np.asarray(viol) & keep
    return [np.asarray(a) for a in (x, P, pi, S, rem)]


def _run_torch(cp, cost, x, kappa, amp, keep, minimize, Bb):
    keep_t = torch.as_tensor(keep)
    x = torch.as_tensor(x)
    P = torch.zeros((cp.m, cp.Kr, R))
    pi = torch.zeros((cp.m, R))
    S = None
    sched = tviolated(cp, x) & keep_t
    for it in range(SWEEPS):
        order, n_rows = _compact(np.arange(cp.m, dtype=np.int32), sched.numpy(), cp.m)
        x, P, pi, S, viol, rem = tpw.psweep(
            cp, x, P, pi, torch.as_tensor(cost), sched, torch.as_tensor(order),
            torch.as_tensor(kappa), 0.01, 0.5,
            torch.as_tensor(seed_pair(jax.random.key(it + 1))),
            torch.as_tensor(amp), n_rows=torch.tensor(n_rows),
            minimize=minimize, block_size=Bb, S=S, S_fresh=it != 0,
        )
        sched = viol & keep_t
    return [a.numpy() for a in (x, P, pi, S, rem)]


def _assert_parity(a, b):
    xa, Pa, pia, Sa, rema = a
    xb, Pb, pib, Sb, remb = b
    assert (xa == xb).all(), f"x mismatch on {np.sum(xa != xb)} entries"
    np.testing.assert_allclose(pib, pia, rtol=0, atol=2e-4)
    np.testing.assert_allclose(Pb, Pa, rtol=0, atol=2e-4)
    np.testing.assert_allclose(Sb, Sa, rtol=0, atol=2e-3)
    assert (rema == remb).all()


CASES = {
    # pure 0/1 cover, every violated row scheduled
    "scp": (lambda: random_set_cover_lp(40, 160, 0.06, seed=5), True, 1.0),
    # ±1 factors (the kernel's non-unit branch), maximize
    "knapsack101": (lambda: random_knapsack_101_lp(16, 40, seed=3), False, 1.0),
    # partial schedule with compacted n_rows
    "scp_partial": (lambda: random_set_cover_lp(40, 160, 0.06, seed=5), True, 0.6),
}


@pytest.mark.parametrize("name", list(CASES))
def test_psweep_reference_matches_pallas_interpret(name):
    lp, minimize, frac = CASES[name]
    jcp, cost = _compiled(lp())
    assert jcp.all_unit_pos == (name != "knapsack101")
    Bb = jpw.plan(jcp, R, jnp.float32, 8).Bb
    tcp = convert.compiled_problem(
        {f.name: np.asarray(getattr(jcp, f.name)) for f in dataclasses.fields(jcp)},
        device="cpu",
    )
    x, kappa, amp, keep = _inputs(jcp, frac)
    a = _run_jax(jcp, cost, x, kappa, amp, keep, minimize, Bb)
    b = _run_torch(tcp, cost, x, kappa, amp, keep, minimize, Bb)
    if frac < 1.0:
        # the partial schedule really left (row, replica) pairs untouched
        assert (b[2] == 0).any() and (b[2] != 0).any()
    _assert_parity(a, b)

