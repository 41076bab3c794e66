"""The port's float64 ℤ sweep against the JAX package's, on the CPU
(``jax.enable_x64``).

- ``dp_select`` in float64 equals the JAX package's float64 DP
  (``_dp_select``, the route its ``z_sweep`` takes in float64) bit for
  bit, both objectives, at N(0, 1) reduced costs and at costs scaled to
  1e15 and 1e30. The JAX DP's "infinity" is +inf; a finite 1e30 (the
  float32 DP's, after the Pallas kernel) takes a finite score at an
  unreachable activity once costs pass about 3e29 and the picks then
  differ: the port's float64 DP uses +inf too (``zsweep.dp_big``).
- ``z_sweep`` in float64, 3 sweeps from a seeded state with nonzero P and
  pi, minimizing and maximizing on an instance with enumeration and DP
  rows, and maximizing on one whose long ±1 rows take the greedy walk
  with the JAX package's tie-break noise injected: x, the violated rows
  and remaining bit for bit; P and pi within 1e-12 of the array's largest
  magnitude (XLA fuses some multiply-adds that PyTorch rounds twice: a
  float64 ulp, 2.2e-16 relative, per operation).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import baryonyx_tpu as bx
from baryonyx_tpu.generators import random_z_multiknapsack_lp
from baryonyx_tpu.ops import zsweep as jzs
from baryonyx_tpu.ops.layout import compile_problem as jcompile
from baryonyx_tpu.preprocess import unpreprocess as junpreprocess
from baryonyx_tpu.preprocess.merge import make_merged_constraints as jmerge

from baryonyx_torch import convert
from baryonyx_torch.ops import zsweep as tzs

B = 8
DP_LP = random_z_multiknapsack_lp(20, 80, row_len=(14, 22), seed=5)  # DP rows
MIXED_LP = random_z_multiknapsack_lp(20, 80, seed=5)  # enumeration + DP rows
REL = 1e-12


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _walk_dp_lp(seed=4):
    """Long ±1 rows (the walk's class) beside long ℤ rows (the DP's)."""
    rng = np.random.default_rng(seed)
    n = 60
    lines = ["maximize",
             " + ".join(f"{int(c)} x{j}" for j, c in enumerate(rng.integers(1, 30, n))),
             "st"]
    for k in range(B):
        L = int(rng.integers(14, 22))
        idx = rng.choice(n, L, replace=False)
        sg = np.where(rng.random(L) < 0.7, 1, -1)
        lhs = " ".join(f"{'+' if s > 0 else '-'} x{j}" for s, j in zip(sg, idx))
        npos = int((sg > 0).sum())
        op = [">=", "<=", "="][k % 3]
        lines.append(f"w{k}: {lhs} {op} {int(rng.integers(1, max(2, npos - 2)))}")
    for k in range(4):
        idx = rng.choice(n, 16, replace=False)
        lhs = " + ".join(f"{int(a)} x{j}" for a, j in zip(rng.integers(2, 9, 16), idx))
        lines.append(f"z{k}: {lhs} <= {int(rng.integers(20, 40))}")
    lines.append("end")
    return "\n".join(lines) + "\n"


def _compiled(lp):
    """The JAX package's CompiledProblem in float64 and the port's copy."""
    ctx = bx.make_context(0)
    pb = junpreprocess(ctx, bx.parse_lp(lp))
    jcp = jcompile(jmerge(ctx, pb), len(pb.vars.values), dtype=jnp.float64)
    tcp = convert.compiled_problem(
        {f.name: np.asarray(getattr(jcp, f.name)) for f in dataclasses.fields(jcp)},
        device="cpu",
    )
    return jcp, tcp


@pytest.mark.parametrize("minimize", [True, False])
@pytest.mark.parametrize("scale", [1.0, 1e15, 1e30])
def test_dp_select_float64_matches_jax(scale, minimize):
    with jax.enable_x64(True):
        jcp, tcp = _compiled(DP_LP)
        assert jcp.Wdp > 0
        rng = np.random.default_rng(int(np.log10(scale)))
        rows_c = np.where(np.asarray(jcp.dp_row))[0][:B].astype(np.int32)
        mask = np.asarray(jcp.row_mask)[rows_c]
        r = rng.normal(0, 1, (B, jcp.Kr, 64)) * scale
        want = np.asarray(jzs._dp_select(
            jcp, jnp.asarray(rows_c), jnp.asarray(r), jnp.asarray(mask), minimize))
    got = tzs.dp_select(
        tcp, torch.as_tensor(rows_c), torch.as_tensor(r), torch.as_tensor(mask),
        minimize,
    ).numpy()
    assert (got == want).all(), f"{np.sum(got != want)} bits differ"
    assert got[np.broadcast_to(mask[:, :, None], got.shape)].any()


class _JaxWalkNoise:
    """Stands in for ``torch.rand`` inside the port's ``z_sweep``: block b
    of the sweep keyed ``key`` gets the JAX package's walk noise,
    uniform(fold_in(fold_in(key, b), 1))."""

    def __init__(self, monkeypatch, key):
        self.key = key
        self.block = 0
        real = torch.rand

        def rand(shape, *a, generator=None, dtype=None, device=None, **kw):
            if generator is not self:
                return real(shape, *a, generator=generator, dtype=dtype,
                            device=device, **kw)
            kb = jax.random.fold_in(jax.random.fold_in(self.key, self.block), 1)
            self.block += 1
            return torch.as_tensor(np.asarray(
                jax.random.uniform(kb, tuple(shape), jnp.float32)))

        monkeypatch.setattr(torch, "rand", rand)


# name: (LP, minimize)
CASES = {
    "dp_min": (MIXED_LP, True),
    "dp_max": (MIXED_LP, False),
    "walk_dp_max": (_walk_dp_lp(), False),
}


@pytest.mark.parametrize("case", list(CASES))
def test_z_sweep_float64_matches_jax(case, monkeypatch):
    lp, minimize = CASES[case]
    with jax.enable_x64(True):
        jcp, tcp = _compiled(lp)
        assert jcp.Wdp > 0
        assert jcp.z_needs_walk == (case == "walk_dp_max")
        R = 32
        m, n, Kr = jcp.m, jcp.n, jcp.Kr
        rng = np.random.default_rng(0)
        x = (rng.random((n, R)) < 0.3).astype(np.int32)
        P = rng.normal(0, 0.05, (m, Kr, R)) * np.asarray(jcp.row_mask)[:, :, None]
        pi = rng.normal(0, 0.05, (m, R))
        keep = rng.random((m, R)) < 0.8
        cost = 1.0 + rng.permutation(n) + 0.01 * rng.random(n)
        cost = cost / cost.max() * (1 if minimize else -1)
        kappa = np.full(R, 0.2)
        amp = np.where(rng.random(R) < 0.25, 2.0, 0.0)
        mp = -(-m // B) * B
        order0 = np.concatenate([np.arange(m), np.full(mp - m, m)]).astype(np.int32)
        viol = np.zeros((m, R), bool)
        viol[: jcp.m_real] = True
        for it in range(3):
            sched = viol & keep
            any_row = np.concatenate([sched.any(axis=1), [False]])[np.minimum(order0, m)]
            order = order0[np.argsort(~any_row, kind="stable")]
            key = jax.random.key(it)
            jx, jP, jpi, jviol, jrem = (np.asarray(v) for v in jzs.z_sweep(
                jcp, jnp.asarray(x), jnp.asarray(P), jnp.asarray(pi),
                jnp.asarray(cost), jnp.asarray(sched), jnp.asarray(order),
                jnp.asarray(kappa), jnp.float64(0.01), jnp.float64(0.5), key,
                jnp.asarray(amp), n_rows=jnp.asarray(int(any_row.sum()), jnp.int32),
                minimize=minimize, block_size=B,
            ))
            assert jP.dtype == np.float64
            with monkeypatch.context() as mp_:
                noise = _JaxWalkNoise(mp_, key)
                tx, tP, tpi, tviol, trem = (v.numpy() for v in tzs.z_sweep(
                    tcp, torch.as_tensor(x.copy()), torch.as_tensor(P.copy()),
                    torch.as_tensor(pi.copy()), torch.as_tensor(cost),
                    torch.as_tensor(sched), torch.as_tensor(order),
                    torch.as_tensor(kappa), 0.01, 0.5, noise,
                    torch.as_tensor(amp), minimize=minimize, block_size=B,
                ))
            assert tP.dtype == np.float64
            assert noise.block == (mp // B if jcp.z_needs_walk else 0)
            assert (jpi != pi).any(axis=0).mean() > 0.5  # the duals moved
            assert np.array_equal(tx, jx), f"sweep {it}: {np.sum(tx != jx)} x differ"
            assert np.array_equal(tviol, jviol) and np.array_equal(trem, jrem)
            for what, got, want in (("P", tP, jP), ("pi", tpi, jpi)):
                err = np.abs(got - want).max()
                assert err <= REL * np.abs(want).max(), f"sweep {it} {what}: {err}"
            x, P, pi, viol = jx, jP, jpi, jviol
