"""Parity of the port's ℤ sweep (baryonyx_torch/ops/zsweep.py) with the JAX
package's ops/zsweep.py, on the CPU.

- ``dp_select_reference`` (the plain version of the DP kernel) equals the
  Pallas DP kernel run by its interpreter bit for bit, and ``_dp_select``
  wherever the row has a reachable activity in range; it finds the
  brute-force optimum over all 2^L assignments.
- ``_walk_select`` equals the JAX walk given the same tie-break noise.
- ``z_sweep`` over 3 sweeps from a seeded state with nonzero P and pi: x
  and remaining bit-exact, P and pi within 1e-5 plus 16 float32 ulps of
  the array's largest magnitude. XLA's CPU code fuses some multiply-adds
  into one rounding where PyTorch rounds twice, so the sweep's
  intermediates (reduced costs, the repair term, the column sums, as
  large as P's largest entries) differ by an ulp, and a small P entry
  computed from large ones inherits that absolute error. Minimizing on
  the small instance the error stays below 1e-6; where P grows (the
  64-row instance; maximizing, where the JAX package's repair pass makes
  P grow about 20x per sweep, ROADMAP.md Queue 3) an ulp of the largest
  entry exceeds 1e-5. The enumeration scores are a matmul in each
  framework, summed in its own order: where two feasible assignments
  score within 1e-5 of each other, the picks may differ, and the test
  then compares the picks' scores instead and says so.
- Blocks of the order past the scheduled rows change nothing.
"""

import dataclasses
import warnings

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

import baryonyx_torch as bt
from baryonyx_torch import convert
from baryonyx_torch.ops import zsweep as tzs
from baryonyx_torch.ops.layout import compile_problem as tcompile
from baryonyx_torch.preprocess.fixing import unpreprocess as tunpreprocess
from baryonyx_torch.preprocess.merge import make_merged_constraints as tmerge

B = 8
DP_LP = random_z_multiknapsack_lp(20, 80, row_len=(14, 22), seed=5)  # DP rows
MIXED_LP = random_z_multiknapsack_lp(20, 80, seed=5)  # enumeration + DP rows
ATOL = 1e-5
ULPS = 16 * 2.0**-23  # 16 float32 ulps, relative to an array's largest |value|
TIE = 1e-5


def _assert_close(got, want, what):
    bound = ATOL + ULPS * np.abs(want).max()
    err = np.abs(got - want).max()
    assert err <= bound, f"{what}: max |err| {err} > {bound}"


def _compiled(lp):
    """The JAX package's CompiledProblem and the port's copy of it."""
    ctx = bx.make_context(0)
    pb = junpreprocess(ctx, bx.parse_lp(lp))
    jcp = jcompile(jmerge(ctx, pb), len(pb.vars.values))
    tcp = convert.compiled_problem(
        {f.name: np.asarray(getattr(jcp, f.name)) for f in dataclasses.fields(jcp)},
        device="cpu",
    )
    return jcp, tcp


def _dp_inputs(jcp, R, seed=0):
    rng = np.random.default_rng(seed)
    rows_c = np.where(np.asarray(jcp.dp_row))[0][:B].astype(np.int32)
    r = rng.normal(0, 1, (B, jcp.Kr, R)).astype(np.float32)
    mask = np.asarray(jcp.row_mask)[rows_c]
    return rows_c, r, mask


def _port_dp(tcp, rows_c, r, mask, minimize):
    return tzs.dp_select(
        tcp, torch.as_tensor(rows_c), torch.as_tensor(r), torch.as_tensor(mask),
        minimize,
    ).numpy()


@pytest.mark.parametrize("minimize", [True, False])
def test_dp_select_matches_pallas_interpret(minimize, monkeypatch):
    jcp, tcp = _compiled(DP_LP)
    assert jcp.Wdp > 0 and not jcp.z_needs_walk
    rows_c, r, mask = _dp_inputs(jcp, 128)
    got = _port_dp(tcp, rows_c, r, mask, minimize)
    args = (jcp, jnp.asarray(rows_c), jnp.asarray(r), jnp.asarray(mask), minimize)
    monkeypatch.setenv("BARYONYX_PALLAS", "interpret")
    pal = np.asarray(jzs._dp_select_pallas(*args))
    assert (got == pal).all(), f"{np.sum(got != pal)} bits differ"

    # the inf-based jnp DP agrees wherever its pick is in range
    ref = np.asarray(jzs._dp_select(*args))
    fac = np.asarray(jcp.dp_fac)[rows_c]  # [B, Kr]
    act = np.einsum("bk,bkr->br", fac, ref.astype(np.int64))
    lo = np.asarray(jcp.dp_blo)[rows_c][:, None]
    hi = np.asarray(jcp.dp_bhi)[rows_c][:, None]
    reach = (act >= lo) & (act <= hi)  # [B, R]
    assert reach.mean() > 0.9
    assert (got == ref)[np.broadcast_to(reach[:, None, :], got.shape)].all()


@pytest.mark.parametrize("trial", range(4))
def test_dp_select_matches_brute_force(trial):
    """The tests/test_z_solver.py property on the port's own pipeline."""
    rng = np.random.default_rng(3 + trial)
    L = int(rng.integers(14, 18))
    factors = rng.integers(-3, 4, size=L)
    factors[factors == 0] = 1
    lo = int(factors[factors < 0].sum())
    hi = int(factors[factors > 0].sum())
    b = int(rng.integers(lo, hi + 1))
    terms = " ".join(
        f"{'+' if f > 0 else '-'} {abs(f)} x{i}" for i, f in enumerate(factors)
    )
    op, bmin, bmax = [("<=", lo, b), (">=", b, hi), ("=", b, b), ("<=", lo, b)][trial]
    raw = bt.parse_lp(f"minimize\nobj: x0\nst\nc1: {terms} {op} {b}\nend\n")
    ctx = bt.make_context(0)
    cp = tcompile(tmerge(ctx, tunpreprocess(ctx, raw)), L, device="cpu")
    assert cp.Wdp > 0 and bool(cp.dp_row[0])

    bits = (np.arange(2**L)[:, None] >> np.arange(L)[None, :]) & 1
    act = bits @ factors
    feas = (act >= bmin) & (act <= bmax)
    assert feas.any()
    R = 16
    r = rng.normal(size=(1, cp.Kr, R)).astype(np.float32)
    for minimize in (True, False):
        chosen = _port_dp(cp, np.zeros(1, np.int32), r, cp.row_mask[:1].numpy(), minimize)[0]
        scores = bits @ r[0, :L].astype(np.float64)  # [2^L, R]
        best = scores[feas].min(axis=0) if minimize else scores[feas].max(axis=0)
        got_act = factors @ chosen[:L]
        assert ((got_act >= bmin) & (got_act <= bmax)).all()
        assert not chosen[L:].any()
        got = (r[0, :L].astype(np.float64) * chosen[:L]).sum(axis=0)
        np.testing.assert_allclose(got, best, rtol=0, atol=1e-5)


def _walk_lp(seed=4):
    """Long ±1 rows (the walk's class) beside one ℤ row that makes the
    instance a Z problem."""
    rng = np.random.default_rng(seed)
    n = 60
    lines = ["minimize", " + ".join(f"{int(c)} x{j}" for j, c in enumerate(rng.integers(1, 30, n))), "st"]
    for k in range(B):
        L = int(rng.integers(14, 22))
        idx = rng.choice(n, L, replace=False)
        sg = np.where(rng.random(L) < 0.7, 1, -1)
        lhs = " ".join(f"{'+' if s > 0 else '-'} x{j}" for s, j in zip(sg, idx))
        npos = int((sg > 0).sum())
        op = [">=", "<=", "="][k % 3]
        lines.append(f"w{k}: {lhs} {op} {int(rng.integers(1, max(2, npos - 2)))}")
    lines += ["z0: 2 x0 + 3 x1 - x2 <= 3", "end"]
    return "\n".join(lines) + "\n"


@pytest.mark.parametrize("minimize", [True, False])
def test_walk_select_matches_jax(minimize):
    jcp, tcp = _compiled(_walk_lp())
    assert jcp.z_needs_walk
    enum = np.asarray(jcp.enum_row)
    dp = np.asarray(jcp.dp_row) if jcp.Wdp else np.zeros_like(enum)
    rows_c = np.where(~enum & ~dp)[0][:B].astype(np.int32)
    assert rows_c.shape[0] == B
    R = 64
    rng = np.random.default_rng(1)
    mask = np.asarray(jcp.row_mask)[rows_c]
    r = rng.normal(0, 1, (B, jcp.Kr, R)).astype(np.float32)
    r[:, :, : R // 4] = np.round(r[:, :, : R // 4])  # ties for the noise to break
    r_masked = np.where(mask[:, :, None], r, np.inf if minimize else -np.inf).astype(np.float32)
    a = np.asarray(jcp.row_factor)[rows_c]
    kb = jax.random.key(5)
    want = np.asarray(jzs._walk_select(
        jcp, jnp.asarray(rows_c), jnp.asarray(r_masked), jnp.asarray(a), kb,
        minimize, B, jcp.Kr, R, jnp.float32,
    ))
    tb = np.array(jax.random.uniform(jax.random.fold_in(kb, 1), (B, jcp.Kr, R), jnp.float32))
    got = tzs._walk_select(
        tcp, torch.as_tensor(rows_c), torch.as_tensor(r_masked),
        torch.as_tensor(a), torch.as_tensor(tb), minimize,
    ).numpy()
    assert (got == want).all(), f"{np.sum(got != want)} slots differ"
    assert got[mask].any() and not got[mask].all()


def test_column_sums_abs_matches_jax():
    jcp, tcp = _compiled(MIXED_LP)
    x, P, pi, _ = _state(jcp, 64)
    want = np.asarray(jzs.column_sums_abs(jcp, jnp.asarray(P), jnp.asarray(pi)))
    got = tzs.column_sums_abs(tcp, torch.as_tensor(P), torch.as_tensor(pi)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


def _state(cp, R, seed=0):
    rng = np.random.default_rng(seed)
    x = (rng.random((cp.n, R)) < 0.3).astype(np.int32)
    P = (rng.normal(0, 0.05, (cp.m, cp.Kr, R)) * np.asarray(cp.row_mask)[:, :, None]).astype(np.float32)
    pi = rng.normal(0, 0.05, (cp.m, R)).astype(np.float32)
    keep = rng.random((cp.m, R)) < 0.8
    return x, P, pi, keep


def _compact(order, sched, m):
    any_row = np.concatenate([sched.any(axis=1), [False]])[np.minimum(order, m)]
    return order[np.argsort(~any_row, kind="stable")], int(any_row.sum())


def _sweep_args(cp, R, seed, minimize=True):
    """Normalized costs with distinct gaps (negated when maximizing, so
    both directions see the same kind of state), kappa, and the objective
    amplifier of a quarter of the lanes (push lanes)."""
    rng = np.random.default_rng(100 + seed)
    cost = (1.0 + rng.permutation(cp.n) + 0.01 * rng.random(cp.n)).astype(np.float32)
    cost = cost / cost.max() * (1 if minimize else -1)
    kappa = np.full(R, 0.2, np.float32)
    amp = np.where(rng.random(R) < 0.25, 2.0, 0.0).astype(np.float32)
    return cost, kappa, amp


class _ScoreLog:
    """Records the port's enumeration scores (the [B, Amax, R] products)."""

    def __init__(self, monkeypatch):
        self.scores = []
        real = torch.bmm

        def bmm(a, b):
            out = real(a, b)
            self.scores.append(out.detach().clone())
            return out

        monkeypatch.setattr(torch, "bmm", bmm)


def _near_tie(log, tcp, order, sched, reps, minimize, B):
    """True when, for each of the replicas ``reps``, some block has a
    scheduled enumeration row whose best two feasible assignments score
    within TIE of each other."""
    av = tcp.assign_valid.numpy()
    enum = tcp.enum_row.numpy()
    ok = np.zeros(len(reps), bool)
    for blk, sc in enumerate(log.scores):
        for i, k in enumerate(order[blk * B:(blk + 1) * B]):
            if k >= tcp.m or not enum[k]:
                continue
            s = np.sort(sc[i].numpy()[av[k]][:, reps], axis=0)
            if not minimize:
                s = s[::-1]
            ok |= (s.shape[0] > 1) & (np.abs(s[1] - s[0]) <= TIE) & sched[k, reps]
    return ok.all()


# (LP, block size, minimize). "sentinel": m_real = m = 64 and a block size
# that does not divide it, so the order ends in sentinel rows that share
# the last block with the real row m-1 (clamped onto it, they must not
# overwrite its P update)
Z_SWEEP_CASES = {
    "min": (MIXED_LP, 8, True),
    "max": (MIXED_LP, 8, False),
    "sentinel": (random_z_multiknapsack_lp(64, 200, seed=5), 6, True),
}


@pytest.mark.parametrize("case", list(Z_SWEEP_CASES))
def test_z_sweep_matches_jax(case, monkeypatch):
    lp, Bk, minimize = Z_SWEEP_CASES[case]
    jcp, tcp = _compiled(lp)
    assert jcp.Wdp > 0 and jcp.Amax > 16 and not jcp.z_needs_walk
    R = 64
    mp = -(-jcp.m // Bk) * Bk
    order0 = np.concatenate([np.arange(jcp.m), np.full(mp - jcp.m, jcp.m)]).astype(np.int32)
    if case == "sentinel":
        assert jcp.m_real == jcp.m and mp > jcp.m
    x, P, pi, keep = _state(jcp, R)
    cost, kappa, amp = _sweep_args(jcp, R, int(minimize), minimize)
    viol = np.zeros((jcp.m, R), bool)
    viol[: jcp.m_real] = True  # padded rows are never violated
    log = _ScoreLog(monkeypatch)
    ties = 0
    for it in range(3):
        sched = viol & keep
        order, n_rows = _compact(order0, sched, jcp.m)
        jx, jP, jpi, jviol, jrem = (np.asarray(v) for v in jzs.z_sweep(
            jcp, jnp.asarray(x), jnp.asarray(P), jnp.asarray(pi),
            jnp.asarray(cost), jnp.asarray(sched), jnp.asarray(order),
            jnp.asarray(kappa), jnp.float32(0.01), jnp.float32(0.5),
            jax.random.key(it), jnp.asarray(amp),
            n_rows=jnp.asarray(n_rows, jnp.int32), minimize=minimize,
            block_size=Bk,
        ))
        log.scores.clear()
        tx, tP, tpi, tviol, trem = (v.numpy() for v in tzs.z_sweep(
            tcp, torch.as_tensor(x), torch.as_tensor(P.copy()),
            torch.as_tensor(pi.copy()), torch.as_tensor(cost),
            torch.as_tensor(sched), torch.as_tensor(order),
            torch.as_tensor(kappa), 0.01, 0.5, None, torch.as_tensor(amp),
            minimize=minimize, block_size=Bk,
        ))
        assert len(log.scores) == mp // Bk  # every block was processed
        if case == "sentinel" and it == 0:
            last = order[mp - Bk:]
            assert jcp.m - 1 in last and jcp.m in last
            assert sched[jcp.m - 1].any()
        moved = (jpi != pi).any(axis=0)
        assert moved.mean() > 0.5
        same = (tx == jx).all(axis=0)  # [R]
        if not same.all():
            reps = np.where(~same)[0]
            assert _near_tie(log, tcp, order, sched, reps, minimize, Bk), (
                f"sweep {it}: x differs on replicas {reps} without a near-tie"
            )
            ties += len(reps)
            warnings.warn(
                f"sweep {it}: enumeration near-tie on replicas {reps}: "
                "their picks' scores were compared instead"
            )
        assert (trem == jrem)[same].all() and (tviol == jviol)[:, same].all()
        _assert_close(tP[..., same], jP[..., same], f"sweep {it} P")
        _assert_close(tpi[:, same], jpi[:, same], f"sweep {it} pi")
        # the next sweep starts from the JAX package's state
        x, P, pi, viol = jx, jP, jpi, jviol
    assert ties <= R // 8


def test_blocks_past_the_scheduled_rows_change_nothing():
    jcp, tcp = _compiled(MIXED_LP)
    R = 32
    x, P, pi, keep = _state(jcp, R, seed=3)
    rows_on = np.random.default_rng(4).random(jcp.m) < 0.4
    sched = keep & rows_on[:, None]
    order, n_rows = _compact(np.arange(jcp.m, dtype=np.int32), sched, jcp.m)
    short = -(-n_rows // B) * B
    assert short < jcp.m
    cost, kappa, amp = _sweep_args(jcp, R, 0)
    outs = []
    for o in (order, order[:short]):
        outs.append(tzs.z_sweep(
            tcp, torch.as_tensor(x), torch.as_tensor(P.copy()),
            torch.as_tensor(pi.copy()), torch.as_tensor(cost),
            torch.as_tensor(sched), torch.as_tensor(o), torch.as_tensor(kappa),
            0.01, 0.5, None, torch.as_tensor(amp), block_size=B,
        ))
    for a, b in zip(*outs):
        assert torch.equal(a, b)
    assert not torch.equal(outs[0][1], torch.as_tensor(P))
