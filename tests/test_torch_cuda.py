"""The CUDA kernel on the card (skipped without one).

The port alone, no jax: on the card run
    python -m pytest --noconftest -m gpu tests/test_torch_cuda.py
(tests/conftest.py imports jax, which the card's machine lacks).

The hand-written sweep kernel is held against the plain PyTorch version on
CUDA tensors, x and remaining bit-exact (the kernel is built with
--fmad=false, so it rounds as the separate torch ops do), P, pi and S
within 2e-4 / 2e-4 / 2e-3: with the keys in registers and in the
shared-memory tile, at row blocks of 4, 2 and 16 rows, with a row length
that the slot lanes do not divide, with +-1 factors and with a quadratic
objective, at a theta and a delta of its own for every replica (the
meta-optimizers' input), and in the first design (the replica_thread
variant). The
knapsack DP kernel (csrc/dpselect.cu) is held against its plain version
bit for bit on the DP rows of two Z instances (table widths 88 and 2048),
for both objectives, on a block that mixes DP rows with others, in its
first design (the device_table variant), and at 1 and 3 replicas (solve
mode's shape); its double instance bit for bit at 512 and 1 replicas,
and a float64 solve on a Z instance launches it once per block. Kernel
and plain version also agree, S bit for bit, at a state with an infinite
P on pairs that are not scheduled. The sweeps' column sums and a Z sweep
repeat bit for bit on the card, and the column sums equal the CPU's.
"""

import numpy as np
import pytest
import torch

import baryonyx_torch as bt
from baryonyx_torch.generators import (
    random_knapsack_101_lp,
    random_qsap_lp,
    random_set_cover_lp,
    random_z_multiknapsack_lp,
)
from baryonyx_torch.ops import psweep as pw
from baryonyx_torch.ops import zsweep as zs
from baryonyx_torch.ops.layout import compile_problem
from baryonyx_torch.ops.sweep import violated_mask
from baryonyx_torch.preprocess.fixing import preprocess
from baryonyx_torch.preprocess.merge import make_merged_constraints

R = 256
SWEEPS = 3


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _chain(fn, cp, cost, push, keep, minimize, dev, block_size=4, quad_mat=None,
           delta=0.01, theta=0.5):
    """SWEEPS sweeps from x = 0: push lanes schedule every row (as the
    optimizer's push phase does), the others their violated rows; a random
    30% of the (row, replica) pairs sit out."""
    x = torch.zeros((cp.n, R), dtype=torch.int32, device=dev)
    P = torch.zeros((cp.m, cp.Kr, R), device=dev)
    pi = torch.zeros((cp.m, R), device=dev)
    S = None
    sched = (violated_mask(cp, x) | push) & keep
    first_share = float(sched[: cp.m_real].float().mean())
    for it in range(SWEEPS):
        any_row = torch.cat([sched.any(dim=1), sched.new_zeros(1)])
        order = torch.argsort((~any_row[:-1]).to(torch.int8), stable=True)
        x, P, pi, S, viol, rem = fn(
            cp, x, P, pi, cost, sched, order.to(torch.int32),
            torch.full((R,), 0.15, device=dev), delta, theta,
            torch.tensor([17 + it, -3], dtype=torch.int32, device=dev),
            torch.zeros(R, device=dev), n_rows=any_row.sum(),
            minimize=minimize, block_size=block_size, quad_mat=quad_mat,
            S=S, S_fresh=it != 0,
        )
        sched = (viol | push) & keep
    torch.cuda.synchronize()
    return x, P, pi, S, rem, first_share


def _with_plan(make_plan):
    """``psweep`` with the kernel launched by ``make_plan(cp, Bb)``."""

    def fn(*a, n_rows=None, minimize=True, block_size=8, quad_mat=None, S=None,
           S_fresh=None):
        inp = pw._prepare(*a, n_rows, minimize, block_size, quad_mat, S, S_fresh)
        pw.psweep_kernel(inp, make_plan(inp.cp, inp.Bb))
        return pw._finish(inp)

    return fn


def _ragged_plan(cp, Bb):
    """Keys in registers, with a number of slot lanes per row (4 per warp
    at 8 replicas per CUDA block) that does not divide Kr."""
    Wr = next(w for w in (3, 4, 5) if cp.Kr % (4 * w))
    return pw.group_plan(cp.n, cp.Kr, Bb, 8, Wr, True, True)


# name: (LP text, rows per block, plan (None: launch_plan's), its key storage)
SWEEP_CASES = {
    "scp": (lambda: random_set_cover_lp(60, 240, 0.05, seed=3), 4, None,
            "registers"),
    "knapsack101": (lambda: random_knapsack_101_lp(16, 40, seed=3), 4, None,
                    "registers"),
    "block16": (lambda: random_set_cover_lp(60, 240, 0.05, seed=3), 16, None,
                "shared"),
    "ragged_lanes": (lambda: random_set_cover_lp(60, 240, 0.05, seed=3), 2,
                     _ragged_plan, "registers"),
    # rows of about 80 variables: too long for the register keys
    "tile": (lambda: random_set_cover_lp(40, 400, 0.2, seed=4), 4, None,
             "shared"),
    "quad": (lambda: random_qsap_lp(12, 6, seed=2), 4, None, "registers"),
    "first_design": (lambda: random_set_cover_lp(60, 240, 0.05, seed=3), 4,
                     lambda cp, Bb: pw.REPLICA_THREAD, "device"),
}


@pytest.mark.gpu
@pytest.mark.parametrize("name", list(SWEEP_CASES))
def test_kernel_matches_plain_version(cuda, name):
    make_lp, block_size, make_plan, key_storage = SWEEP_CASES[name]
    ctx = bt.make_context(0)
    pb = preprocess(ctx, bt.parse_lp(make_lp()))
    cp = compile_problem(
        make_merged_constraints(ctx, pb), len(pb.vars.values),
        qelements=pb.objective.qelements, device=cuda,
    )
    plan = (make_plan or (lambda cp, Bb: pw.launch_plan(cp.n, cp.Kr, R, Bb)))(
        cp, block_size)
    assert plan.key_storage == key_storage
    rng = np.random.default_rng(0)
    push = torch.as_tensor(rng.random(R) < 0.5, device=cuda)[None, :]
    keep = torch.as_tensor(rng.random((cp.m, R)) < 0.7, device=cuda)
    cost = torch.as_tensor(
        1.0 + np.arange(cp.n) + 0.01 * ((np.arange(cp.n) * 37) % 61),
        dtype=torch.float32, device=cuda,
    )
    quad_mat = None
    if name == "quad":
        assert cp.has_quad
        q = rng.normal(0, 0.05, (cp.n, cp.n))
        quad_mat = torch.as_tensor(q + q.T, dtype=torch.float32, device=cuda)
    minimize = name != "knapsack101"
    before = pw.psweep_kernel.launches
    a = _chain(pw.psweep_reference, cp, cost, push, keep, minimize, cuda,
               block_size, quad_mat)
    b = _chain(_with_plan(make_plan) if make_plan else pw.psweep, cp, cost,
               push, keep, minimize, cuda, block_size, quad_mat)
    assert pw.psweep_kernel.launches == before + SWEEPS
    # phase B ran for a real share of the pairs
    assert a[5] >= 0.25
    assert float((b[1][: cp.m_real] != 0).any(dim=1).float().mean()) >= 0.25
    assert torch.equal(a[0], b[0]) and torch.equal(a[4], b[4])
    for u, v, tol in zip(a[1:4], b[1:4], (2e-4, 2e-4, 2e-3)):
        assert float((u - v).abs().max()) <= tol


@pytest.mark.gpu
def test_kernel_matches_plain_version_at_per_replica_theta_delta(cuda):
    """theta and delta as [R] vectors, every replica its own, as the
    meta-optimizers' combos give them."""
    ctx = bt.make_context(0)
    pb = preprocess(ctx, bt.parse_lp(random_set_cover_lp(60, 240, 0.05, seed=3)))
    cp = compile_problem(
        make_merged_constraints(ctx, pb), len(pb.vars.values), device=cuda
    )
    rng = np.random.default_rng(1)
    push = torch.as_tensor(rng.random(R) < 0.5, device=cuda)[None, :]
    keep = torch.as_tensor(rng.random((cp.m, R)) < 0.7, device=cuda)
    cost = torch.as_tensor(
        1.0 + np.arange(cp.n) + 0.01 * ((np.arange(cp.n) * 37) % 61),
        dtype=torch.float32, device=cuda,
    )
    theta = torch.as_tensor(rng.uniform(0.2, 0.9, R), dtype=torch.float32,
                            device=cuda)
    delta = torch.as_tensor(rng.uniform(0.001, 0.05, R), dtype=torch.float32,
                            device=cuda)
    before = pw.psweep_kernel.launches
    a = _chain(pw.psweep_reference, cp, cost, push, keep, True, cuda,
               delta=delta, theta=theta)
    b = _chain(pw.psweep, cp, cost, push, keep, True, cuda, delta=delta,
               theta=theta)
    assert pw.psweep_kernel.launches == before + SWEEPS
    assert torch.equal(a[0], b[0]) and torch.equal(a[4], b[4])
    for u, v, tol in zip(a[1:4], b[1:4], (2e-4, 2e-4, 2e-3)):
        assert float((u - v).abs().max()) <= tol


@pytest.mark.gpu
def test_kernel_refuses_what_it_does_not_take(cuda):
    ctx = bt.make_context(0)
    pb = preprocess(ctx, bt.parse_lp(random_set_cover_lp(30, 90, 0.08, seed=2)))
    cp = compile_problem(
        make_merged_constraints(ctx, pb), len(pb.vars.values), device=cuda
    )
    r = 48  # not a multiple of 32
    with pytest.raises(NotImplementedError):
        pw.psweep(
            cp, torch.zeros((cp.n, r), dtype=torch.int32, device=cuda),
            torch.zeros((cp.m, cp.Kr, r), device=cuda),
            torch.zeros((cp.m, r), device=cuda), torch.ones(cp.n, device=cuda),
            torch.ones((cp.m, r), dtype=torch.bool, device=cuda),
            torch.arange(cp.m, dtype=torch.int32, device=cuda),
            torch.full((r,), 0.1, device=cuda), 0.01, 0.5,
            torch.tensor([1, 2], dtype=torch.int32, device=cuda),
            torch.zeros(r, device=cuda),
        )


Z_INSTANCES = {
    # zknap200x1000 (Wdp 88) and a wide-table instance (Wdp 2048)
    "zknap": lambda: random_z_multiknapsack_lp(200, 1000, seed=2),
    "wide": lambda: random_z_multiknapsack_lp(
        64, 400, row_len=(13, 24), coeff_range=(1, 150), seed=3
    ),
}


def _z_compiled_lp(lp, dev):
    ctx = bt.make_context(0)
    pb = preprocess(ctx, bt.parse_lp(lp))
    return compile_problem(
        make_merged_constraints(ctx, pb), len(pb.vars.values), device=dev
    )


def _z_compiled(name, dev):
    return _z_compiled_lp(Z_INSTANCES[name](), dev)


@pytest.mark.gpu
@pytest.mark.parametrize("variant", ["planned", "first_design"])
@pytest.mark.parametrize("name", list(Z_INSTANCES))
def test_dp_kernel_matches_plain_version(cuda, name, variant):
    cp = _z_compiled(name, cuda)
    dp_rows = torch.nonzero(cp.dp_row).flatten().to(torch.int32)
    assert cp.Wdp > 0 and dp_rows.numel() >= 8
    plan = zs.dp_launch_plan(cp.Wdp, cp.Kr, 512, 8)
    assert plan.variant == "shared"
    if variant == "first_design":
        plan = zs.DEVICE_TABLE
    rng = np.random.default_rng(0)
    for minimize in (True, False):
        for blk in range(0, min(dp_rows.numel(), 32) - 7, 8):
            rows_c = dp_rows[blk:blk + 8].contiguous()
            r = torch.as_tensor(
                rng.normal(0, 1, (8, cp.Kr, 512)), dtype=torch.float32,
                device=cuda,
            )
            mask = cp.row_mask[rows_c.long()].contiguous()
            before = zs.dp_select_kernel.launches
            got = zs.dp_select_kernel(cp, rows_c, r, mask, minimize, plan)
            torch.cuda.synchronize()
            assert zs.dp_select_kernel.launches == before + 1
            want = zs.dp_select_reference(cp, rows_c, r, mask, minimize)
            assert torch.equal(got, want)
            assert got.any() and not got[mask].all()


@pytest.mark.gpu
@pytest.mark.parametrize("variant", ["planned", "first_design"])
def test_dp_kernel_on_a_block_that_mixes_dp_rows_with_others(cuda, variant):
    """The rows of a sweep's block as they come: the DP rows get their
    set, the others an all-zero one, as in the plain version."""
    cp = _z_compiled("zknap", cuda)
    plan = None if variant == "planned" else zs.DEVICE_TABLE
    rng = np.random.default_rng(1)
    mixed = 0
    for blk in range(0, 64, 8):
        rows_c = torch.arange(blk, blk + 8, dtype=torch.int32, device=cuda)
        is_dp = cp.dp_row[rows_c.long()]
        mixed += int(0 < int(is_dp.sum()) < 8)
        r = torch.as_tensor(
            rng.normal(0, 1, (8, cp.Kr, 512)), dtype=torch.float32, device=cuda
        )
        mask = cp.row_mask[rows_c.long()].contiguous()
        for minimize in (True, False):
            got = zs.dp_select_kernel(cp, rows_c, r, mask, minimize, plan)
            torch.cuda.synchronize()
            want = zs.dp_select_reference(cp, rows_c, r, mask, minimize)
            assert torch.equal(got, want)
            assert not got[~is_dp].any()
    assert mixed >= 4


@pytest.mark.gpu
def test_dp_kernel_refuses_what_it_does_not_take(cuda):
    cp = _z_compiled("zknap", cuda)
    rows_c = torch.nonzero(cp.dp_row).flatten()[:8].to(torch.int32)
    mask = cp.row_mask[rows_c.long()].contiguous()
    r = torch.zeros((8, cp.Kr, 64), device=cuda)
    with pytest.raises(ValueError, match="dpselect"):
        zs.dp_select(cp, rows_c, r.half(), mask, True)  # wrong dtype
    with pytest.raises(ValueError, match="dpselect"):
        zs.dp_select(cp, rows_c.long(), r, mask, True)  # wrong index type
    with pytest.raises(ValueError, match="dpselect"):
        zs.dp_select(cp, rows_c, r[:, :-1], mask, True)  # wrong shape
    with pytest.raises(ValueError, match="dpselect"):
        zs.dp_select(cp, rows_c, r.transpose(0, 2).contiguous().transpose(0, 2), mask, True)


@pytest.mark.gpu
@pytest.mark.parametrize("replicas", [1, 3])
@pytest.mark.parametrize("name", list(Z_INSTANCES))
def test_dp_kernel_at_one_and_three_replicas(cuda, name, replicas):
    """Solve mode calls the DP at one replica; three divide by no group
    size but 1 either. Both take the shared variant with G = 1."""
    cp = _z_compiled(name, cuda)
    dp_rows = torch.nonzero(cp.dp_row).flatten().to(torch.int32)
    plan = zs.dp_launch_plan(cp.Wdp, cp.Kr, replicas, 8)
    assert plan.variant == "shared" and plan.G == 1
    rng = np.random.default_rng(replicas)
    for minimize in (True, False):
        for blk in range(0, min(dp_rows.numel(), 32) - 7, 8):
            rows_c = dp_rows[blk:blk + 8].contiguous()
            r = torch.as_tensor(
                rng.normal(0, 1, (8, cp.Kr, replicas)), dtype=torch.float32,
                device=cuda,
            )
            mask = cp.row_mask[rows_c.long()].contiguous()
            before = zs.dp_select_kernel.launches
            got = zs.dp_select(cp, rows_c, r, mask, minimize)
            torch.cuda.synchronize()
            assert zs.dp_select_kernel.launches == before + 1
            want = zs.dp_select_reference(cp, rows_c, r, mask, minimize)
            assert torch.equal(got, want)
            assert got.any() and not got[mask].all()


@pytest.mark.gpu
@pytest.mark.parametrize("variant", ["planned", "first_design"])
@pytest.mark.parametrize("name", list(Z_INSTANCES))
def test_dp_kernel_in_double_matches_plain_version(cuda, name, variant):
    """The kernel's double instance, bit for bit, at 512 replicas and at
    one, both objectives, at N(0, 1) reduced costs and at costs near
    1e30, where a finite 1e30 would no longer stand for "out of reach"
    (its "infinity" is +inf in float64, as in the plain version)."""
    cp = _z_compiled(name, cuda)
    dp_rows = torch.nonzero(cp.dp_row).flatten().to(torch.int32)
    rng = np.random.default_rng(7)
    for replicas in (512, 1):
        plan = zs.dp_launch_plan(cp.Wdp, cp.Kr, replicas, 8, itemsize=8)
        assert plan.variant == "shared"
        assert plan == zs.dp_plan(cp.Wdp, cp.Kr, plan.G, plan.T, itemsize=8)
        if variant == "first_design":
            plan = zs.DEVICE_TABLE
        for scale in (1.0, 1e30):
            for minimize in (True, False):
                rows_c = dp_rows[:8].contiguous()
                r = torch.as_tensor(
                    rng.normal(0, 1, (8, cp.Kr, replicas)) * scale,
                    dtype=torch.float64, device=cuda,
                )
                mask = cp.row_mask[rows_c.long()].contiguous()
                before = zs.dp_select_kernel.launches
                got = zs.dp_select_kernel(cp, rows_c, r, mask, minimize, plan)
                torch.cuda.synchronize()
                assert zs.dp_select_kernel.launches == before + 1
                want = zs.dp_select_reference(cp, rows_c, r, mask, minimize)
                assert torch.equal(got, want), (replicas, scale, minimize)
                assert got.any()


@pytest.mark.gpu
def test_float64_z_solve_reaches_the_double_kernel(cuda, monkeypatch):
    """Solve mode in float64 on a small Z instance with DP rows: a valid
    solution; every block of every sweep launches the kernel's double
    instance, and the plain version is never called."""
    from baryonyx_torch.core.params import FloatType

    def refused(*a, **kw):
        raise AssertionError("the plain DP ran on the card")

    monkeypatch.setattr(zs, "dp_select_reference", refused)
    lp = random_z_multiknapsack_lp(40, 160, row_len=(14, 22), seed=5)
    ctx = bt.make_context(0)
    ctx.parameters.seed = 3
    ctx.parameters.time_limit = 2.0
    ctx.parameters.float_type = FloatType.float64
    raw = bt.parse_lp(lp)
    cp = _z_compiled_lp(lp, cuda)
    assert cp.Wdp > 0
    zs.dp_select_kernel.launches = 0
    res = bt.solve(ctx, raw, device=cuda)
    torch.cuda.synchronize()
    assert res.status == bt.ResultStatus.success
    assert bt.is_valid_solution(raw, res)
    blocks = -(-cp.m // ctx.parameters.block_size)
    assert res.sweeps > 0
    assert zs.dp_select_kernel.launches == res.sweeps * blocks


@pytest.mark.gpu
@pytest.mark.parametrize("variant", ["planned", "first_design"])
def test_kernel_and_plain_version_agree_at_a_nonfinite_P(cuda, variant):
    """A (row, replica) pair that is not scheduled changes nothing, even
    where its P is infinite: the kernel skips it and the plain version
    adds nothing for it. S, pi, x equal bit for bit; P too."""
    ctx = bt.make_context(0)
    pb = preprocess(ctx, bt.parse_lp(random_set_cover_lp(60, 240, 0.05, seed=3)))
    cp = compile_problem(
        make_merged_constraints(ctx, pb), len(pb.vars.values), device=cuda
    )
    rng = np.random.default_rng(0)
    x = torch.as_tensor(
        (rng.random((cp.n, R)) < 0.2).astype(np.int32), device=cuda
    )
    sched = torch.as_tensor(rng.random((cp.m, R)) < 0.7, device=cuda)
    k_row, k_all = 3, 9  # one pair of a scheduled row; a row nobody schedules
    sched[k_row, 5] = False
    sched[k_row, 6] = True
    sched[k_all] = False
    P0 = torch.as_tensor(
        rng.normal(0, 0.01, (cp.m, cp.Kr, R)), dtype=torch.float32, device=cuda
    ) * cp.row_mask[:, :, None]
    P0[k_row, : int(cp.r_size[k_row]), 5] = float("inf")
    P0[k_all, : int(cp.r_size[k_all]), 7] = float("-inf")
    S0 = torch.as_tensor(
        rng.normal(0, 0.01, (cp.n, R)), dtype=torch.float32, device=cuda
    )
    cost = torch.as_tensor(
        1.0 + np.arange(cp.n) + 0.01 * ((np.arange(cp.n) * 37) % 61),
        dtype=torch.float32, device=cuda,
    )
    any_row = sched.any(dim=1)
    order = torch.argsort((~any_row).to(torch.int8), stable=True).to(torch.int32)
    fn = pw.psweep if variant == "planned" else _with_plan(
        lambda cp, Bb: pw.REPLICA_THREAD)
    outs = []
    for f in (pw.psweep_reference, fn):
        outs.append(f(
            cp, x, P0.clone(), torch.zeros((cp.m, R), device=cuda), cost, sched,
            order, torch.full((R,), 0.15, device=cuda), 0.01, 0.5,
            torch.tensor([17, -3], dtype=torch.int32, device=cuda),
            torch.zeros(R, device=cuda), n_rows=any_row.sum(),
            block_size=4, S=S0.clone(), S_fresh=True,
        ))
    torch.cuda.synchronize()
    a, b = outs
    assert torch.isfinite(a[3]).all() and torch.isfinite(b[3]).all()
    assert torch.isfinite(a[2]).all() and torch.isfinite(b[2]).all()
    assert torch.equal(a[0], b[0]) and torch.equal(a[5], b[5])
    assert torch.equal(a[3], b[3]) and torch.equal(a[2], b[2])
    assert torch.equal(a[1], b[1])
    assert torch.isinf(b[1][k_row, 0, 5]) and torch.isinf(b[1][k_all, 0, 7])
    assert (b[1][k_row, 0, 6] != P0[k_row, 0, 6]).item()  # its neighbor moved


@pytest.mark.gpu
def test_sweeps_repeat_bit_for_bit(cuda):
    """The sweeps' sums come out in one order on the card: the column sums
    of a large random state (over the column view, ops/sweep.py:column_sums)
    and the Z path's (a scatter through ops/sweep.py:add_rows_), and three
    Z sweeps from one state, are the same bit for bit every time."""
    from baryonyx_torch.ops.sweep import column_sums

    cp = _z_compiled("zknap", cuda)
    rng = np.random.default_rng(5)
    R = 512
    P = torch.as_tensor(rng.normal(0, 1, (cp.m, cp.Kr, R)), dtype=torch.float32,
                        device=cuda) * cp.row_mask[:, :, None]
    pi = torch.as_tensor(rng.normal(0, 1, (cp.m, R)), dtype=torch.float32,
                         device=cuda)
    sums = [column_sums(cp, P, pi) for _ in range(3)]
    sums += [zs.column_sums_abs(cp, P, pi) for _ in range(2)]
    assert torch.equal(sums[0], sums[1]) and torch.equal(sums[0], sums[2])
    assert torch.equal(sums[3], sums[4])
    x = torch.as_tensor((rng.random((cp.n, R)) < 0.3).astype(np.int32),
                        device=cuda)
    cost = torch.as_tensor(rng.random(cp.n), dtype=torch.float32, device=cuda)
    sched = torch.ones((cp.m, R), dtype=torch.bool, device=cuda)
    order = torch.arange(cp.m, dtype=torch.int32, device=cuda)
    outs = []
    for _ in range(2):
        xs, Ps, pis = x, P.clone() * 0.01, pi.clone() * 0.01
        for _ in range(3):
            xs, Ps, pis, _, _ = zs.z_sweep(
                cp, xs, Ps, pis, cost, sched, order,
                torch.full((R,), 0.2, device=cuda), 0.01, 0.5, None,
                torch.zeros(R, device=cuda), block_size=8)
        outs.append((xs, Ps, pis))
    torch.cuda.synchronize()
    for a, b in zip(*outs):
        assert torch.equal(a, b)


@pytest.mark.gpu
def test_column_sums_on_the_card_equal_the_cpu(cuda):
    """At the main path's shape and replica count the card's column sums
    are the CPU's bit for bit, a non-finite P in every padded row slot
    included."""
    from baryonyx_torch.ops.sweep import column_sums

    cp = _z_compiled_lp(random_set_cover_lp(200, 1000, 0.02, seed=41), "cpu")
    gen = torch.Generator().manual_seed(3)
    R = 2048
    P = torch.randn((cp.m, cp.Kr, R), generator=gen)
    P = torch.where(cp.row_mask[:, :, None], P, float("inf"))
    pi = torch.randn((cp.m, R), generator=gen)
    want = column_sums(cp, P, pi)
    cp_card = _z_compiled_lp(random_set_cover_lp(200, 1000, 0.02, seed=41), cuda)
    got = column_sums(cp_card, P.to(cuda), pi.to(cuda))
    assert torch.isfinite(want).all()
    assert torch.equal(got.cpu(), want)


@pytest.mark.gpu
def test_device_memory_stats_reads_every_card(cuda):
    from baryonyx_torch.memory import device_memory_stats

    held = torch.empty(1 << 20, device=cuda)
    stats = device_memory_stats()
    assert len(stats) == torch.cuda.device_count()
    mine = stats[f"cuda:{cuda.index or 0}"]
    assert mine["bytes_in_use"] >= held.numel() * 4
    assert mine["bytes_limit"] > mine["bytes_in_use"]
