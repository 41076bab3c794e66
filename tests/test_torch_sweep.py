"""Parity of the port's general sweep (``baryonyx_torch.ops.sweep.sweep``)
with the JAX package's (``baryonyx_tpu.ops.sweep.sweep``).

Both run the same numpy-seeded inputs for 3 sweeps. The JAX function draws
its tie noise (and the random solver's costs) per row block from
``fold_in(key, b)``; the test draws the same numbers from the same keys and
injects them into the port through ``SweepNoise``.

Tolerance: x, the violated mask and remaining are equal; P, pi and S agree
within 1e-5 absolute + 1e-5 relative in float32 (the scatter-adds sum a
column's contributions in another order) and within 1e-12 in float64.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from baryonyx_tpu.core.context import make_context
from baryonyx_tpu.generators import (
    random_knapsack_101_lp,
    random_qsap_lp,
    random_set_cover_lp,
)
from baryonyx_tpu.io.lp_parse import parse_lp
from baryonyx_tpu.ops import sweep as jsw
from baryonyx_tpu.ops.layout import compile_problem
from baryonyx_tpu.preprocess.fixing import preprocess
from baryonyx_tpu.preprocess.merge import make_merged_constraints

from baryonyx_torch import convert
from baryonyx_torch.ops import psweep as tpw
from baryonyx_torch.ops import sweep as tsw

SWEEPS = 3


def cardinality_rows(names, count: int = 2) -> str:
    """Equality rows whose right-hand side sits mid-row: the selection
    reads ranks no sort-free split covers."""
    out = []
    for i in range(count):
        vs = names[i * 40:(i + 1) * 40]
        out.append(f" card{i}: " + " + ".join(vs) + " = 10")
    return "\n".join(out) + "\n"


def full_sort_lp(m=40, n=160, seed=5) -> str:
    lp = random_set_cover_lp(m, n, 0.06, seed=seed)
    pb = parse_lp(lp)
    extra = cardinality_rows(list(pb.vars.names))
    head, tail = lp.split("binary\n", 1)
    return head + extra + "binary\n" + tail


def compiled(lp, dtype=jnp.float32):
    ctx = make_context(0)
    pb = preprocess(ctx, parse_lp(lp))
    cons = make_merged_constraints(ctx, pb)
    cp = compile_problem(
        cons, len(pb.vars.values), dtype=dtype, qelements=pb.objective.qelements
    )
    cost = 1.0 + np.arange(cp.n) + 0.01 * ((np.arange(cp.n) * 37) % 61)
    return cp, cost / cost.max()


def to_torch(jcp):
    return convert.compiled_problem(
        {f.name: np.asarray(getattr(jcp, f.name)) for f in dataclasses.fields(jcp)},
        device="cpu",
    )


def jax_noise(key, n_blocks, shape, dtype, random_solver=False):
    """The draws ``baryonyx_tpu.ops.sweep.sweep`` makes from ``key``."""
    tie, costs = [], []
    for b in range(n_blocks):
        kb = jax.random.fold_in(key, b)
        k_tie, _ = jax.random.split(kb)
        tie.append(np.asarray(jax.random.uniform(k_tie, shape, dtype=dtype)))
        if random_solver:
            costs.append(
                np.asarray(jax.random.uniform(jax.random.fold_in(kb, 2), shape, dtype))
            )
    if not n_blocks:
        return None
    return tsw.SweepNoise(
        torch.as_tensor(np.stack(tie)),
        torch.as_tensor(np.stack(costs)) if random_solver else None,
    )


def compact(order, sched, m):
    any_row = np.concatenate([sched.any(axis=1), [False]])[np.minimum(order, m)]
    return order[np.argsort(~any_row, kind="stable")], int(any_row.sum())


def run_pair(
    jcp, cost, R, minimize, B, frac=1.0, f64=False, random_solver=False,
    quad_fac=None, fresh_pattern=(False, True, True), sweeps=SWEEPS,
    kappa_v=0.15, every_row=True,
):
    """Both sweeps on the same inputs; yields per sweep the JAX and the
    torch (x, P, pi, S, viol, remaining) as numpy arrays. ``every_row``
    schedules every kept (row, replica) pair at every sweep, else the
    violated ones."""
    npdt = np.float64 if f64 else np.float32
    jdt = jnp.float64 if f64 else jnp.float32
    tcp = to_torch(jcp)
    m, n, Kr = jcp.m, jcp.n, jcp.Kr
    mp = -(-m // B) * B
    rng = np.random.default_rng(0)
    x0 = (rng.random((n, R)) < 0.2).astype(np.int32)
    keep = rng.random((m, R)) < frac
    keep[rng.random(m) < (1.0 - frac)] = False
    kappa = np.full(R, kappa_v, npdt)
    amp = np.zeros(R, npdt)
    cost = cost.astype(npdt)
    base_order = np.concatenate(
        [np.arange(m, dtype=np.int32), np.full(mp - m, m, np.int32)]
    )

    jx, jP, jpi, jS = (
        jnp.asarray(x0), jnp.zeros((m, Kr, R), jdt), jnp.zeros((m, R), jdt), None
    )
    tx, tP, tpi, tS = (
        torch.as_tensor(x0), torch.zeros((m, Kr, R), dtype=getattr(torch, npdt.__name__)),
        torch.zeros((m, R), dtype=getattr(torch, npdt.__name__)), None,
    )
    jq = None if quad_fac is None else jnp.asarray(quad_fac.astype(npdt))
    tq = None if quad_fac is None else torch.as_tensor(quad_fac.astype(npdt))
    jsched = (np.asarray(jsw.violated_mask(jcp, jx)) | every_row) & keep
    tsched = (tsw.violated_mask(tcp, tx).numpy() | every_row) & keep
    out = []
    for it in range(sweeps):
        assert (jsched == tsched).all()
        order, n_rows = compact(base_order, jsched, m)
        key = jax.random.key(it + 1)
        fresh = fresh_pattern[it % len(fresh_pattern)]
        jx, jP, jpi, jS, jviol, jrem = jsw.sweep(
            jcp, jx, jP, jpi, jnp.asarray(cost), jnp.asarray(jsched),
            jnp.asarray(order), jnp.asarray(kappa), jnp.asarray(0.01, jdt),
            jnp.asarray(0.5, jdt), key, jnp.asarray(amp),
            n_rows=jnp.asarray(n_rows, jnp.int32), minimize=minimize,
            block_size=B, random_solver=random_solver, quad_fac=jq,
            S=jS, S_fresh=jnp.asarray(fresh and jS is not None),
        )
        noise = jax_noise(key, -(-n_rows // B), (B, Kr, R), jdt, random_solver)
        tx, tP, tpi, tS, tviol, trem = tsw.sweep(
            tcp, tx, tP, tpi, torch.as_tensor(cost), torch.as_tensor(tsched),
            torch.as_tensor(order), torch.as_tensor(kappa), 0.01, 0.5, None,
            torch.as_tensor(amp), n_rows=torch.tensor(n_rows),
            minimize=minimize, block_size=B, random_solver=random_solver,
            quad_fac=tq, S=tS, S_fresh=fresh, noise=noise,
        )
        out.append((
            [np.asarray(a) for a in (jx, jP, jpi, jS, jviol, jrem)],
            [a.numpy().copy() for a in (tx, tP, tpi, tS, tviol, trem)],
        ))
        jsched = (np.asarray(jviol) | every_row) & keep
        tsched = (tviol.numpy() | every_row) & keep
    return out


def assert_parity(a, b, f64=False):
    xa, Pa, pia, Sa, va, rema = a
    xb, Pb, pib, Sb, vb, remb = b
    assert (xa == xb).all(), f"x mismatch on {np.sum(xa != xb)} entries"
    assert (va == vb).all()
    assert (rema == remb).all()
    tol = 1e-12 if f64 else 1e-5
    for got, want in ((Pb, Pa), (pib, pia), (Sb, Sa)):
        assert got.dtype == want.dtype
        np.testing.assert_allclose(got, want, rtol=tol, atol=tol)


CASES = {
    # name: (lp, minimize, B, frac, f64, fresh_pattern)
    "scp": (lambda: random_set_cover_lp(40, 160, 0.06, seed=5), True, 8, 1.0,
            False, (False, True, True)),
    "knapsack101_max": (lambda: random_knapsack_101_lp(16, 40, seed=3), False, 8,
                        1.0, False, (False, True, True)),
    "scp_partial": (lambda: random_set_cover_lp(40, 160, 0.06, seed=5), True, 8,
                    0.6, False, (False, True, True)),
    # only the violated rows, as solve mode schedules them
    "scp_violated": (lambda: random_set_cover_lp(40, 160, 0.06, seed=5), True, 8,
                     0.6, False, (False, True, True)),
    "full_sort": (full_sort_lp, True, 8, 1.0, False, (False, True, True)),
    "float64": (lambda: random_set_cover_lp(40, 160, 0.06, seed=5), True, 8, 1.0,
                True, (False, True, True)),
    "block1": (lambda: random_set_cover_lp(24, 80, 0.1, seed=7), True, 1, 1.0,
               False, (False, True, True)),
    # a block size that does not divide m: sentinel rows in the last block
    "block8_sentinels": (lambda: random_knapsack_101_lp(13, 40, seed=4), False, 8,
                         1.0, False, (False, True, True)),
    # S recomputed at every sweep, and carried from the first on
    "S_never_fresh": (lambda: random_set_cover_lp(40, 160, 0.06, seed=5), True, 8,
                      1.0, False, (False, False, False)),
}


@pytest.mark.parametrize("name", list(CASES))
def test_sweep_matches_jax(name):
    lp, minimize, B, frac, f64, fresh = CASES[name]
    with jax.enable_x64(f64):
        jcp, cost = compiled(lp(), jnp.float64 if f64 else jnp.float32)
        assert jcp.sel_reduction_ok == (name != "full_sort")
        R = 16
        res = run_pair(jcp, cost, R, minimize, B, frac=frac, f64=f64,
                       fresh_pattern=fresh, every_row=name != "scp_violated")
    for a, b in res:
        assert_parity(a, b, f64)
    last = res[-1][1]
    assert (last[2] != 0).any()  # the duals moved
    if frac < 1.0:
        assert (last[2] == 0).any()


def test_sweep_quadratic_matches_jax():
    lp = random_qsap_lp(6, 4, seed=2)
    jcp, cost = compiled(lp)
    assert jcp.has_quad
    qf = np.asarray(jcp.quad_fac, np.float64)
    qf = qf / max(np.abs(qf).max(), 1.0)
    res = run_pair(jcp, cost, 8, True, 8, quad_fac=qf)
    for a, b in res:
        assert_parity(a, b)
    # the quadratic terms matter: without them the sweep ends elsewhere
    res0 = run_pair(jcp, cost, 8, True, 8, quad_fac=None)
    assert not np.array_equal(res0[-1][1][1], res[-1][1][1])


def test_random_solver_with_injected_costs_matches_jax():
    jcp, cost = compiled(random_set_cover_lp(40, 160, 0.06, seed=5))
    res = run_pair(jcp, cost, 16, True, 8, random_solver=True)
    for a, b in res:
        assert_parity(a, b)


def test_random_solver_own_draws_select_valid_counts():
    """Without injected costs the port draws its own: every scheduled
    row then selects a count of variables within its bounds."""
    jcp, cost = compiled(random_set_cover_lp(40, 160, 0.06, seed=5))
    tcp = to_torch(jcp)
    R, B = 8, 8
    m, n, Kr = tcp.m, tcp.n, tcp.Kr
    gen = torch.Generator().manual_seed(3)
    x = torch.zeros((n, R), dtype=torch.int32)
    sched = torch.ones((m, R), dtype=torch.bool)
    order = torch.arange(m, dtype=torch.int32)
    P = torch.zeros((m, Kr, R))
    pi = torch.zeros((m, R))
    # block size 1: each row's selection is what its x writes say, until a
    # later row rewrites a shared variable; check the last row
    x, P, pi, S, viol, rem = tsw.sweep(
        tcp, x, P, pi, torch.as_tensor(cost, dtype=torch.float32), sched, order,
        0.15, 0.01, 0.5, gen, 0.0, block_size=1, random_solver=True,
    )
    k = m - 1
    act = (x[tcp.row_vars[k].long()] * tcp.row_mask[k][:, None]).sum(dim=0)
    assert ((act >= tcp.bmin[k]) & (act <= torch.clamp(tcp.bmax[k], max=int(tcp.r_size[k])))).all()
    # every row's chosen slots got P > 0, the others P < 0
    chosen = (P > 0).sum(dim=1)  # [m, R]
    lo = tcp.bmin[:, None]
    hi = torch.minimum(tcp.bmax, tcp.r_size)[:, None]
    real = torch.arange(m) < tcp.m_real
    assert ((chosen >= lo) & (chosen <= hi))[real].all()


def test_unscheduled_pair_with_nonfinite_P_changes_nothing():
    """An unscheduled (row, replica) pair adds nothing to S even where its
    P is infinite, in ``sweep`` and in ``psweep_reference`` alike, and
    walking every block equals stopping at ``n_rows``."""
    jcp, cost = compiled(random_set_cover_lp(40, 160, 0.06, seed=5))
    tcp = to_torch(jcp)
    R, B = 32, 8
    m, n, Kr = tcp.m, tcp.n, tcp.Kr
    rng = np.random.default_rng(1)
    x0 = torch.as_tensor((rng.random((n, R)) < 0.2).astype(np.int32))
    cost_t = torch.as_tensor(cost, dtype=torch.float32)
    sched = torch.ones((m, R), dtype=torch.bool)
    k_off = 3  # a row nobody schedules, with an infinite P in replica 5
    sched[k_off] = False
    order, n_rows = compact(np.arange(m, dtype=np.int32), sched.numpy(), m)
    order_t = torch.as_tensor(order)

    def state(p_val):
        P = torch.as_tensor(rng0.standard_normal((m, Kr, R)).astype(np.float32) * 0.01)
        P = P * tcp.row_mask[:, :, None]
        P[k_off, : int(tcp.r_size[k_off]), 5] = p_val
        pi = torch.zeros((m, R))
        S = torch.as_tensor(rng0.standard_normal((n, R)).astype(np.float32) * 0.01)
        return P, pi, S

    noise = tsw.SweepNoise(torch.rand((m // B, B, Kr, R), generator=torch.Generator().manual_seed(0)))
    results = {}
    for name, p_val, nr in (("inf_all", float("inf"), None),
                            ("inf_bounded", float("inf"), n_rows),
                            ("finite", 1.0, None)):
        rng0 = np.random.default_rng(2)
        P, pi, S = state(p_val)
        results[name] = tsw.sweep(
            tcp, x0, P, pi, cost_t, sched, order_t, 0.15, 0.01, 0.5, None, 0.0,
            n_rows=nr, block_size=B, S=S, S_fresh=True, noise=noise,
        )
    for name, p_val in (("ref_inf", float("inf")), ("ref_finite", 1.0)):
        rng0 = np.random.default_rng(2)
        P, pi, S = state(p_val)
        results[name] = tpw.psweep_reference(
            tcp, x0, P, pi, cost_t, sched, order_t, 0.15, 0.01, 0.5,
            torch.tensor([1, 2], dtype=torch.int32), 0.0,
            n_rows=torch.tensor(m), block_size=B, S=S, S_fresh=True,
        )
    for a, b in (("inf_all", "inf_bounded"), ("inf_all", "finite"),
                 ("ref_inf", "ref_finite")):
        xa, Pa, pia, Sa, va, ra = results[a]
        xb, Pb, pib, Sb, vb, rb = results[b]
        assert torch.isfinite(Sa).all() and torch.isfinite(pia).all()
        assert torch.equal(xa, xb) and torch.equal(Sa, Sb) and torch.equal(pia, pib)
        keep = torch.ones(m, dtype=torch.bool)
        keep[k_off] = False
        assert torch.equal(Pa[keep], Pb[keep])
        assert torch.isinf(Pa[k_off, 0, 5])


def test_dual_growth_matches_jax():
    """Do the duals grow without bound in the JAX package as in the port?
    A dense set cover, every row scheduled at every sweep, kappa fixed at
    0.5, P and pi carried for 300 sweeps through both sweeps with the same
    tie noise: max |P| every 25 sweeps stays within 1e-3 relative while
    finite, and turns non-finite, if it does, at the same sweep."""
    jcp, cost = compiled(random_set_cover_lp(40, 200, 0.1, seed=9))
    tcp = to_torch(jcp)
    R, B = 4, 8
    m, n, Kr = jcp.m, jcp.n, jcp.Kr
    assert m % B == 0
    rng = np.random.default_rng(0)
    x0 = (rng.random((n, R)) < 0.2).astype(np.int32)
    cost = cost.astype(np.float32)
    sched = np.ones((m, R), bool)
    order = np.arange(m, dtype=np.int32)
    kappa = np.full(R, 0.5, np.float32)
    amp = np.zeros(R, np.float32)

    step = jax.jit(
        lambda x, P, pi, key: jsw.sweep(
            jcp, x, P, pi, jnp.asarray(cost), jnp.asarray(sched),
            jnp.asarray(order), jnp.asarray(kappa), jnp.float32(0.01),
            jnp.float32(0.5), key, jnp.asarray(amp), block_size=B,
        )
    )
    draw = jax.jit(
        lambda key: jnp.stack([
            jax.random.uniform(
                jax.random.split(jax.random.fold_in(key, b))[0], (B, Kr, R),
                dtype=jnp.float32,
            )
            for b in range(m // B)
        ])
    )
    jx, jP, jpi = jnp.asarray(x0), jnp.zeros((m, Kr, R)), jnp.zeros((m, R))
    tx, tP, tpi = torch.as_tensor(x0), torch.zeros((m, Kr, R)), torch.zeros((m, R))
    cost_t, sched_t, order_t = (torch.as_tensor(a) for a in (cost, sched, order))
    kappa_t, amp_t = torch.as_tensor(kappa), torch.as_tensor(amp)
    trace = []
    first_bad = {"jax": None, "torch": None}
    for it in range(300):
        key = jax.random.key(it)
        jx, jP, jpi, _, _, _ = step(jx, jP, jpi, key)
        noise = tsw.SweepNoise(torch.as_tensor(np.array(draw(key))))
        tx, tP, tpi, _, _, _ = tsw.sweep(
            tcp, tx, tP, tpi, cost_t, sched_t, order_t, kappa_t, 0.01, 0.5,
            None, amp_t, block_size=B, noise=noise,
        )
        jmax = float(jnp.max(jnp.abs(jP)))
        tmax = float(tP.abs().max())
        for name, v in (("jax", jmax), ("torch", tmax)):
            if first_bad[name] is None and not np.isfinite(v):
                first_bad[name] = it
        if (it + 1) % 25 == 0:
            trace.append((it + 1, jmax, tmax))
        if first_bad["jax"] is not None or first_bad["torch"] is not None:
            break
    print("max|P| every 25 sweeps (sweep, jax, torch):", trace)
    print("first non-finite sweep:", first_bad)
    assert first_bad["jax"] == first_bad["torch"]
    assert trace, "no sample taken"
    for it, jmax, tmax in trace:
        if np.isfinite(jmax) and np.isfinite(tmax):
            assert abs(jmax - tmax) <= 1e-3 * abs(jmax), (it, jmax, tmax)
