"""The port's multi-process paths (``baryonyx_torch.parallel``) against the
JAX package's mesh paths, on the CPU.

The JAX side runs on the 8 virtual CPU devices of ``conftest.py``. The
port's side runs its ranks as spawned processes under one gloo process
group (``spawn_ranks.py`` beside this file: a ``file://`` store in a
temporary directory, one torch thread per rank, a join timeout after
which the ranks are killed).

- ``compile_row_shards`` at D = 2 and 8: the same shapes and the same
  arrays, shard by shard (exact).
- Three row-sharded sweeps at D = 2 from the same state, each shard's tie
  noise drawn from the JAX keys and injected (as in
  ``test_torch_sweep.py``): x and remaining equal; P and pi within 1e-5
  absolute + 1e-5 relative (that file's float32 tolerance).
- The top-K exchange's insert, given the gathered arrays and the JAX
  victims: equal to the JAX ``batch_insert`` (exact); a population's own
  top K change nothing.
- A one-rank group gives the plain path's Result bit for bit at a fixed
  sweep budget, with the ``cycle`` order (its per-step collective on).
  Four chunks of 50 sweeps: the stagnation cataclysm, which only one
  process without a group runs (as in the JAX package), needs seven.
- Optimize at 2 ranks: both return the same valid Result, within 15% of
  the JAX mesh's objective; the first exchange kept each rank's best in
  the other's population, or lost it only to a later candidate that drew
  the same victim slot; rank 0's checkpoint holds both populations,
  [2 P, n].
- The automatic seed (``seed`` 0) with each rank's clock set apart:
  every rank takes rank 0's, so the row route's lanes agree and both
  ranks return the same valid Result.
- The branch meta mode at 2 ranks with rank 1's clock past the budget
  at once: rank 0's stop decision holds for both, and neither waits.
- The row route: ``solve_row_sharded`` at 2 ranks reaches feasibility;
  ``BARYONYX_HBM_BUDGET=5000`` at 2 ranks routes optimize to
  ``+rowshard`` with a valid cover, an ample budget does not.
- ``shard_opt_state`` against ``convert.replica_slice`` /
  ``population_shard`` of the JAX sharded state (exact); the replica
  count over ranks; ``init_distributed`` from either set of variables;
  ``device_memory_stats`` without a card.
"""

import dataclasses

import numpy as np
import pytest
import torch
import torch.distributed as dist

import baryonyx_torch as bt
from baryonyx_torch import convert
from baryonyx_torch.generators import random_set_cover_lp
from baryonyx_torch.ops.sweep import SweepNoise
from baryonyx_torch.parallel import distributed
from baryonyx_torch.preprocess import unpreprocess as tunpreprocess
from baryonyx_torch.preprocess.merge import make_merged_constraints as tmerge
from baryonyx_torch.solver import common as tcommon
from baryonyx_torch.solver import population as tpop
from spawn_ranks import exchange_kept, spawn, watch_first_exchange

# The spawned ranks import this module to find their functions and need
# only torch: the JAX package is imported inside the tests, where the
# JAX side runs.

TOL = 1e-5  # P and pi, absolute + relative (float32; test_torch_sweep.py)
BAND = 0.15
TIMEOUT_S = 90.0  # no spawned rank outlives this
COVER_LP = random_set_cover_lp(48, 160, 0.08, seed=5)  # tests/test_rowshard.py


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jconstraints(lp):
    import baryonyx_tpu as bx
    from baryonyx_tpu.preprocess import unpreprocess as junpreprocess
    from baryonyx_tpu.preprocess.merge import make_merged_constraints as jmerge

    pb = bx.parse_lp(lp)
    ctx = bx.make_context(0)
    return pb, jmerge(ctx, junpreprocess(ctx, pb)), len(pb.vars.names)


def _tconstraints(lp):
    pb = bt.parse_lp(lp)
    ctx = bt.make_context(0)
    return pb, tmerge(ctx, tunpreprocess(ctx, pb)), len(pb.vars.names)


def _fields(cp):
    return {f.name: np.asarray(getattr(cp, f.name)) for f in dataclasses.fields(cp)}


@pytest.mark.parametrize("D", [2, 8])
def test_compile_row_shards_matches_jax(D):
    from baryonyx_tpu.parallel.rowshard import compile_row_shards as jcompile_row_shards

    from baryonyx_torch.parallel.rowshard import compile_row_shards, shard_of

    _, jcs, n = _jconstraints(COVER_LP)
    _, tcs, _ = _tconstraints(COVER_LP)
    jcp = jcompile_row_shards(jcs, n, D)
    tcp = compile_row_shards(tcs, n, D, device="cpu")
    jd = _fields(jcp)
    for f in dataclasses.fields(tcp):
        got = getattr(tcp, f.name)
        want = jd[f.name]
        if isinstance(got, torch.Tensor):
            assert got.shape[0] == D, f.name
            np.testing.assert_array_equal(got.numpy(), want, err_msg=f.name)
        elif got is None:
            assert want.dtype == object and want.item() is None, f.name
        else:
            assert got == want.item(), f.name
    for d in range(D):  # each rank's shard, as convert carries it across
        mine = shard_of(tcp, d)
        theirs = convert.row_shard(jd, d, device="cpu")
        for name in mine.tensor_fields():
            assert torch.equal(getattr(mine, name), getattr(theirs, name)), name


def _jax_noise(key, n_blocks, shape):
    """The tie-noise draws of ``baryonyx_tpu.ops.sweep.sweep`` from
    ``key``: one uniform per block b from split(fold_in(key, b))[0]."""
    import jax
    import jax.numpy as jnp

    tie = []
    for b in range(n_blocks):
        k_tie, _ = jax.random.split(jax.random.fold_in(key, b))
        tie.append(np.asarray(jax.random.uniform(k_tie, shape, dtype=jnp.float32)))
    return np.stack(tie)


def _sweep_ranks(cp_fields, x0, cost, kappa, noises, minimize):
    """One rank: its shard's three row-sharded sweeps with the injected
    noise; (x, P, pi, remaining) after each."""
    from baryonyx_torch.parallel.mesh import make_mesh
    from baryonyx_torch.parallel.rowshard import sweep_row_sharded

    mesh = make_mesh(device="cpu")
    cp = convert.row_shard(cp_fields, mesh.rank, device="cpu")
    R = x0.shape[1]
    x = torch.as_tensor(x0)
    P = torch.zeros((cp.m, cp.Kr, R))
    pi = torch.zeros((cp.m, R))
    out = []
    for noise in noises:
        x, P, pi, rem = sweep_row_sharded(
            cp, x, P, pi, torch.as_tensor(cost), torch.as_tensor(kappa),
            np.float32(0.01), np.float32(0.5), None, mesh=mesh,
            minimize=minimize, noise=SweepNoise(torch.as_tensor(noise[mesh.rank])),
        )
        out.append(tuple(t.clone().numpy() for t in (x, P, pi, rem)))
    return out


@pytest.mark.parametrize("minimize", [True, False])
def test_row_sharded_sweeps_match_jax(minimize):
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec

    from baryonyx_tpu.parallel.mesh import make_mesh as jmake_mesh
    from baryonyx_tpu.parallel.rowshard import (
        compile_row_shards as jcompile_row_shards,
        sweep_row_sharded as jsweep_row_sharded,
    )

    D, R, B, SWEEPS = 2, 8, 8, 3
    _, jcs, n = _jconstraints(COVER_LP)
    jcp = jcompile_row_shards(jcs, n, D)
    mesh = jmake_mesh(jax.devices()[:D])
    rows = NamedSharding(mesh, PartitionSpec(mesh.axis_names[0]))
    m_loc, Kr, n_pad = jcp.m, jcp.Kr, jcp.n
    rng = np.random.default_rng(0)
    x0 = (rng.random((n_pad, R)) < 0.2).astype(np.int32)
    cost = 1.0 + np.arange(n_pad) + 0.01 * ((np.arange(n_pad) * 37) % 61)
    cost = (cost / cost.max()).astype(np.float32)
    kappa = np.full(R, 0.15, np.float32)

    x = jnp.asarray(x0)
    P = jax.device_put(jnp.zeros((D, m_loc, Kr, R), jnp.float32), rows)
    pi = jax.device_put(jnp.zeros((D, m_loc, R), jnp.float32), rows)
    key = jax.random.key(3)
    n_blocks = -(-m_loc // B)
    want, noises = [], []
    for _ in range(SWEEPS):
        key, k = jax.random.split(key)
        noises.append(np.stack([
            _jax_noise(jax.random.fold_in(k, d), n_blocks, (B, Kr, R))
            for d in range(D)
        ]))
        x, P, pi, rem = jsweep_row_sharded(
            jcp, x, P, pi, jnp.asarray(cost), jnp.asarray(kappa),
            jnp.float32(0.01), jnp.float32(0.5), k, mesh=mesh,
            minimize=minimize, block_size=B,
        )
        want.append(tuple(np.asarray(t) for t in (x, P, pi, rem)))

    got = spawn(_sweep_ranks, D, (_fields(jcp), x0, cost, kappa, noises, minimize),
                timeout_s=TIMEOUT_S)
    moved = False
    for it, (jx, jP, jpi, jrem) in enumerate(want):
        for d in range(D):
            tx, tP, tpi, trem = got[d][it]
            np.testing.assert_array_equal(tx, jx, err_msg=f"x, sweep {it}")
            np.testing.assert_array_equal(trem, jrem, err_msg=f"rem, sweep {it}")
            np.testing.assert_allclose(tP, jP[d], rtol=TOL, atol=TOL)
            np.testing.assert_allclose(tpi, jpi[d], rtol=TOL, atol=TOL)
            moved |= bool((jx != x0).any())
    assert moved and (want[-1][1] != 0).any()


@pytest.mark.parametrize("minimize", [True, False])
def test_exchange_insert_matches_jax(minimize):
    """The exchange's candidates: 2 ranks' top 4 of a population of 20
    (rank 0's are this population's own members, which the dedup
    drops)."""
    import jax
    import jax.numpy as jnp

    from baryonyx_tpu.solver import population as jpop

    rng = np.random.default_rng(7 + minimize)
    Psize, n, K = 20, 48, 4
    hw = tpop.make_hash_weights(n, 3)
    x = rng.integers(0, 2, (Psize, n)).astype(np.int32)
    value = rng.random(Psize).astype(np.float32)
    rem = rng.integers(0, 3, Psize).astype(np.int32)
    jp = jpop.sort_population(
        jpop.Population(jnp.asarray(x), jnp.asarray(value), jnp.asarray(rem),
                        jpop.hash_x(jnp.asarray(x), jnp.asarray(hw))),
        minimize,
    )
    other = rng.integers(0, 2, (K, n)).astype(np.int32)
    gx = np.concatenate([np.asarray(jp.x[:K]), other])
    gv = np.concatenate([np.asarray(jp.value[:K]), rng.random(K).astype(np.float32)])
    gr = np.concatenate([np.asarray(jp.remaining[:K]), np.array([0, 1, 0, 2], np.int32)])
    key = jax.random.key(11)
    want = jpop.batch_insert(
        jp, jnp.asarray(gx), jnp.asarray(gv), jnp.asarray(gr),
        jnp.ones(2 * K, bool), key, jnp.asarray(hw), minimize,
    )
    victims = jax.random.randint(key, (2 * K,), Psize // 5, Psize)
    tp = convert.population({k: np.asarray(v) for k, v in jp._asdict().items()}, "cpu")
    got = tpop.batch_insert(
        tp, torch.as_tensor(gx), torch.as_tensor(gv), torch.as_tensor(gr),
        torch.ones(2 * K, dtype=torch.bool), torch.as_tensor(np.asarray(victims)),
        torch.as_tensor(hw.astype(np.int64)), minimize,
    )
    for name in ("x", "value", "remaining", "hash"):
        np.testing.assert_array_equal(
            getattr(got, name).numpy(), np.asarray(getattr(want, name)), err_msg=name
        )
    # a one-rank exchange (this population's own top K only) changes
    # nothing: what a one-rank group's bit-for-bit equality rests on
    alone = tpop.batch_insert(
        tp, torch.as_tensor(gx[:K]), torch.as_tensor(gv[:K]),
        torch.as_tensor(gr[:K]), torch.ones(K, dtype=torch.bool),
        torch.as_tensor(np.asarray(victims)[:K]),
        torch.as_tensor(hw.astype(np.int64)), minimize,
    )
    for a, b in zip(alone, tp):
        assert torch.equal(a, b)


def _optimize(lp, limit, seed=42, thread=16, order=None, checkpoint=None,
              time_limit=0.0):
    ctx = bt.make_context(0)
    p = ctx.parameters
    p.seed, p.limit, p.thread, p.time_limit = seed, limit, thread, time_limit
    if order:
        p.order = bt.ConstraintOrder[order]
    if checkpoint:
        p.checkpoint_path, p.checkpoint_every = checkpoint, 0.0
    raw = bt.parse_lp(lp)
    r = bt.optimize(ctx, raw, device="cpu")
    return dict(
        status=r.status.name, value=r.value, loop=r.loop, method=r.method,
        valid=bt.is_valid_solution(raw, r),
        annoying=r.annoying_variable, replicas=r.replicas,
        remaining=r.remaining_constraints,
        solutions=[(list(s.variables), s.value) for s in r.solutions],
    )


SCP60 = random_set_cover_lp(60, 240, 0.05, seed=11)


def _optimize_cycle(lp, limit):
    return _optimize(lp, limit, order="cycle")


def test_one_rank_group_equals_the_plain_path():
    plain = _optimize_cycle(SCP60, 200)
    (grouped,) = spawn(_optimize_cycle, 1, (SCP60, 200), timeout_s=TIMEOUT_S)
    assert plain["status"] == "success" and plain["loop"] == 200
    assert grouped == plain


def _optimize_two(lp, limit, ckpt):
    """One of two ranks: optimize, watching the first exchange."""
    first = watch_first_exchange()
    return _optimize(lp, limit, seed=7, checkpoint=ckpt), first


def test_optimize_at_two_ranks(tmp_path):
    import baryonyx_tpu as bx

    lp = random_set_cover_lp(30, 80, 0.12, seed=3)  # tests/test_multichip.py
    ckpt = str(tmp_path / "pop.npz")
    (r0, f0), (r1, f1) = spawn(_optimize_two, 2, (lp, 300, ckpt), timeout_s=TIMEOUT_S)
    assert r0 == r1
    assert r0["status"] == "success" and r0["loop"] == 300 and r0["replicas"] == 16
    assert r0["valid"]
    raw = bx.parse_lp(lp)
    ctx = bx.make_context(0)
    ctx.parameters.seed, ctx.parameters.limit, ctx.parameters.thread = 7, 300, 16
    rj = bx.optimize(ctx, raw)  # the 8-device mesh
    assert rj.status == bx.ResultStatus.success
    assert abs(r0["value"] - rj.value) <= BAND * abs(rj.value)
    # the first exchange brought each rank the other's best
    assert exchange_kept(f1["before"][0], f0)
    assert exchange_kept(f0["before"][0], f1)
    # rank 0 wrote both populations side by side
    saved = np.load(ckpt)
    assert saved["x"].shape[0] == 2 * bt.SolverParameters().init_population_size


def _solve_rows(lp):
    from baryonyx_torch.parallel.mesh import make_mesh
    from baryonyx_torch.parallel.rowshard import solve_row_sharded

    pb, csts, n = _tconstraints(lp)
    cn = tcommon.normalize_costs(
        tcommon.build_cost_vector(pb, n), bt.CostNormType.loo,
        np.random.default_rng(0),
    )
    mesh = make_mesh(device="cpu")
    return solve_row_sharded(csts, n, cn, True, mesh, R=16, sweeps=300, seed=3)


def test_solve_row_sharded_reaches_feasibility():
    from baryonyx_tpu.io.lp_parse import parse_lp
    from baryonyx_tpu.validate import is_valid_solution_values

    (x0, rem0), (x1, rem1) = spawn(_solve_rows, 2, (COVER_LP,), timeout_s=TIMEOUT_S)
    assert rem0 == rem1 == 0
    np.testing.assert_array_equal(x0, x1)
    assert is_valid_solution_values(parse_lp(COVER_LP), [int(v) for v in x0])


def _optimize_rows(lp, time_limit, limit):
    return _optimize(lp, limit, seed=7, time_limit=time_limit)


@pytest.mark.parametrize("budget", ["5000", str(64 << 30)])
def test_device_budget_routes_to_row_sharding(budget, monkeypatch):
    """Past the budget at 2 ranks optimize shards the rows (tests/
    test_rowshard.py's instance); an ample budget keeps the replicas."""
    monkeypatch.setenv("BARYONYX_HBM_BUDGET", budget)  # the ranks inherit it
    tight = budget == "5000"
    lp = COVER_LP if tight else random_set_cover_lp(20, 60, 0.15, seed=13)
    r0, r1 = spawn(_optimize_rows, 2, (lp, 4.0 if tight else 0.0, 100),
                   timeout_s=TIMEOUT_S)
    assert r0 == r1
    assert ("+rowshard" in r0["method"]) == tight
    assert r0["status"] == "success" and r0["valid"]


def _optimize_rows_own_clock(lp, time_limit, limit):
    """``_optimize_rows`` with the automatic seed, each rank's clock a
    minute from the other's."""
    import time

    real = time.time
    skew = 60.0 * distributed.rank()
    time.time = lambda: real() + skew
    try:
        return _optimize(lp, limit, seed=0, time_limit=time_limit)
    finally:
        time.time = real


def test_automatic_seed_is_rank_0s(monkeypatch):
    """The row route's lanes are host draws that every rank must make
    alike: with the automatic seed and clocks a minute apart, both ranks
    return the same valid Result."""
    monkeypatch.setenv("BARYONYX_HBM_BUDGET", "5000")
    r0, r1 = spawn(_optimize_rows_own_clock, 2, (COVER_LP, 3.0, 100),
                   timeout_s=TIMEOUT_S)
    assert "+rowshard" in r0["method"]
    assert r0 == r1
    assert r0["status"] == "success" and r0["valid"]


def _branch_own_clock(lp):
    """The branch meta mode for a 1.5 s budget; rank 1's clock reads past
    it at once."""
    from baryonyx_torch.solver import meta

    ctx = bt.make_context(0)
    p = ctx.parameters
    p.seed, p.thread, p.time_limit = 5, 16, 1.5
    if distributed.rank() == 1:
        import itertools
        import types

        real, calls = meta.time.monotonic, itertools.count()
        meta.time = types.SimpleNamespace(
            monotonic=lambda: real() + (1e6 if next(calls) else 0.0)
        )
    r = meta.branch_optimize(ctx, bt.parse_lp(lp), device="cpu")
    return r.status.name, r.value, r.loop


def test_branch_stops_on_rank_0s_clock():
    """Rank 1 alone would stop after the root node; it follows rank 0
    through the nodes instead, and both end with the same Result before
    the collectives' timeout."""
    r0, r1 = spawn(_branch_own_clock, 2, (random_set_cover_lp(20, 60, 0.15, seed=13),),
                   timeout_s=TIMEOUT_S)
    assert r0 == r1 and r0[0] == "success"


def test_shard_opt_state_matches_the_jax_shards():
    """The JAX package's sharded state (``shard_opt_state`` on an 8-device
    mesh, the population tiled to [8 P, n]): each device's part, carried
    across by ``convert``, equals the port's ``shard_opt_state`` of the
    whole state at that rank."""
    import jax
    import jax.numpy as jnp

    from baryonyx_tpu.parallel.mesh import make_mesh as jmake_mesh
    from baryonyx_tpu.parallel.mesh import shard_opt_state as jshard
    from baryonyx_tpu.solver import population as jpop
    from baryonyx_tpu.solver.optimize import OptState as JOptState
    from baryonyx_tpu.solver.optimize import ReplicaState as JReplicaState

    from baryonyx_torch.parallel.mesh import Mesh, shard_opt_state
    from baryonyx_torch.solver.optimize import OptState

    D, R, Psize, n, m, Kr = 8, 16, 10, 32, 12, 8
    rng = np.random.default_rng(5)
    rs_np = dict(
        x=rng.integers(0, 2, (n, R)).astype(np.int32),
        P=rng.random((m, Kr, R)).astype(np.float32),
        pi=rng.random((m, R)).astype(np.float32),
        S=rng.random((n, R)).astype(np.float32),
        viol=rng.random((m, R)) < 0.5,
        kappa=rng.random(R).astype(np.float32),
        kappa_start=rng.random(R).astype(np.float32),
        kappa_append=rng.random(R).astype(np.float32),
        iter_i=rng.integers(0, 9, R).astype(np.int32),
        phase=rng.integers(0, 3, R).astype(np.int32),
        push_idx=rng.integers(0, 2, R).astype(np.int32),
        best_remaining=rng.integers(0, 9, R).astype(np.int32),
        restarts=rng.integers(0, 9, R).astype(np.int32),
        best_value=rng.random(R).astype(np.float32),
    )
    pop_np = dict(
        x=rng.integers(0, 2, (Psize, n)).astype(np.int32),
        value=rng.random(Psize).astype(np.float32),
        remaining=rng.integers(0, 3, Psize).astype(np.int32),
        hash=rng.integers(0, 2**32, Psize, dtype=np.uint32),
    )
    jstate = jshard(
        JOptState(
            JReplicaState(**{k: jnp.asarray(v) for k, v in rs_np.items()}),
            jpop.Population(**{k: jnp.asarray(np.tile(v, (D,) + (1,) * (v.ndim - 1)))
                               for k, v in pop_np.items()}),
            jax.random.key(0), jnp.asarray(0, jnp.int32), jnp.asarray(0, jnp.int32),
            jnp.zeros((n,), jnp.float32),
        ),
        jmake_mesh(jax.devices()),
    )
    jrs = {k: np.asarray(getattr(jstate.replicas, k)) for k in rs_np}
    jp = {k: np.asarray(getattr(jstate.pop, k)) for k in pop_np}
    whole = OptState(
        convert.replica_state(rs_np, "cpu"), convert.population(pop_np, "cpu"),
        torch.Generator(), torch.tensor(0, dtype=torch.int32), 0, torch.zeros(n),
    )
    for d in range(D):
        mine = shard_opt_state(whole, Mesh(None, d, D, torch.device("cpu")))
        theirs = convert.replica_slice(jrs, d, D, "cpu")
        for a, b in zip(mine.replicas, theirs):
            assert torch.equal(a, b)
        for a, b in zip(mine.pop, convert.population_shard(jp, d, D, "cpu")):
            assert torch.equal(a, b)


def test_replica_count_scales_with_the_ranks():
    from baryonyx_torch.solver.optimize import default_replicas

    p = bt.SolverParameters()
    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    assert default_replicas(p, cuda, 1) == 512
    assert default_replicas(p, cuda, 4) == 2048
    assert default_replicas(p, cpu, 4) == 16  # the CPU keeps 16 in all
    assert default_replicas(p, cpu, 3) == 18  # a multiple of the ranks
    p.thread = 100
    assert default_replicas(p, cuda, 3) == 102


def test_device_memory_stats_without_a_card(monkeypatch):
    """No visible card, no entry (the card's own is in test_torch_cuda.py)."""
    from baryonyx_torch.memory import device_memory_stats

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert device_memory_stats() == {}


@pytest.mark.parametrize("variables", ["baryonyx", "torchrun"])
def test_init_distributed_reads_the_environment(variables, monkeypatch, tmp_path):
    """One rank from either set of variables, on the CPU (gloo); a second
    call changes nothing; optimize then takes the group's path."""
    import socket

    if variables == "baryonyx":
        monkeypatch.setenv("BARYONYX_COORDINATOR", f"file://{tmp_path / 'store'}")
        monkeypatch.setenv("BARYONYX_NUM_PROCS", "1")
        monkeypatch.setenv("BARYONYX_PROC_ID", "0")
    else:
        with socket.socket() as s:
            s.bind(("localhost", 0))
            port = s.getsockname()[1]
        monkeypatch.setenv("MASTER_ADDR", "localhost")
        monkeypatch.setenv("MASTER_PORT", str(port))
        monkeypatch.setenv("WORLD_SIZE", "1")
        monkeypatch.setenv("RANK", "0")
    assert not dist.is_initialized()
    try:
        dev = distributed.init_distributed(device="cpu", timeout_s=30)
        assert dev == torch.device("cpu")
        assert dist.get_backend() == "gloo"
        assert distributed.init_distributed(device="cpu") == dev
        assert (distributed.rank(), distributed.world_size()) == (0, 1)
        assert not distributed.is_multiprocess()
        np.testing.assert_array_equal(
            distributed.gather_to_host(torch.arange(3)), np.arange(3)
        )
        assert _optimize_cycle(SCP60, 100)["loop"] == 100
    finally:
        distributed.shutdown()
    assert not dist.is_initialized()
