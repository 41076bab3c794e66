"""The CUDA kernel on the card (skipped without one).

The port alone, no jax: on the card run
    python -m pytest --noconftest -m gpu tests/test_torch_cuda.py
(tests/conftest.py imports jax, which the card's machine lacks).

The hand-written sweep kernel is held against the plain PyTorch version on
CUDA tensors, x and remaining bit-exact (the kernel is built with
--fmad=false, so it rounds as the separate torch ops do), P, pi and S
within 2e-4 / 2e-4 / 2e-3. The knapsack DP kernel (csrc/dpselect.cu) is
held against its plain version bit for bit on the DP rows of two Z
instances (table widths 88 and 2048), for both objectives.
"""

import numpy as np
import pytest
import torch

import baryonyx_torch as bt
from baryonyx_torch.generators import (
    random_knapsack_101_lp,
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


def _chain(fn, cp, cost, push, keep, minimize, dev):
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
            torch.full((R,), 0.15, device=dev), 0.01, 0.5,
            torch.tensor([17 + it, -3], dtype=torch.int32, device=dev),
            torch.zeros(R, device=dev), n_rows=any_row.sum(),
            minimize=minimize, block_size=4, S=S, S_fresh=it != 0,
        )
        sched = (viol | push) & keep
    torch.cuda.synchronize()
    return x, P, pi, S, rem, first_share


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["scp", "knapsack101"])
def test_kernel_matches_plain_version(cuda, name):
    lp = (
        random_set_cover_lp(60, 240, 0.05, seed=3)
        if name == "scp"
        else random_knapsack_101_lp(16, 40, seed=3)
    )
    ctx = bt.make_context(0)
    pb = preprocess(ctx, bt.parse_lp(lp))
    cp = compile_problem(
        make_merged_constraints(ctx, pb), len(pb.vars.values), device=cuda
    )
    rng = np.random.default_rng(0)
    push = torch.as_tensor(rng.random(R) < 0.5, device=cuda)[None, :]
    keep = torch.as_tensor(rng.random((cp.m, R)) < 0.7, device=cuda)
    cost = torch.as_tensor(
        1.0 + np.arange(cp.n) + 0.01 * ((np.arange(cp.n) * 37) % 61),
        dtype=torch.float32, device=cuda,
    )
    minimize = name == "scp"
    before = pw.psweep_kernel.launches
    a = _chain(pw.psweep_reference, cp, cost, push, keep, minimize, cuda)
    b = _chain(pw.psweep, cp, cost, push, keep, minimize, cuda)
    assert pw.psweep_kernel.launches == before + SWEEPS
    # phase B ran for a real share of the pairs
    assert a[5] >= 0.25
    assert float((b[1][: cp.m_real] != 0).any(dim=1).float().mean()) >= 0.25
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


def _z_compiled(name, dev):
    ctx = bt.make_context(0)
    pb = preprocess(ctx, bt.parse_lp(Z_INSTANCES[name]()))
    return compile_problem(
        make_merged_constraints(ctx, pb), len(pb.vars.values), device=dev
    )


@pytest.mark.gpu
@pytest.mark.parametrize("name", list(Z_INSTANCES))
def test_dp_kernel_matches_plain_version(cuda, name):
    cp = _z_compiled(name, cuda)
    dp_rows = torch.nonzero(cp.dp_row).flatten().to(torch.int32)
    assert cp.Wdp > 0 and dp_rows.numel() >= 8
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
            got = zs.dp_select(cp, rows_c, r, mask, minimize)
            torch.cuda.synchronize()
            assert zs.dp_select_kernel.launches == before + 1
            want = zs.dp_select_reference(cp, rows_c, r, mask, minimize)
            assert torch.equal(got, want)
            assert got.any() and not got[mask].all()


@pytest.mark.gpu
def test_dp_kernel_refuses_what_it_does_not_take(cuda):
    cp = _z_compiled("zknap", cuda)
    rows_c = torch.nonzero(cp.dp_row).flatten()[:8].to(torch.int32)
    mask = cp.row_mask[rows_c.long()].contiguous()
    r = torch.zeros((8, cp.Kr, 64), device=cuda)
    with pytest.raises(ValueError, match="dpselect"):
        zs.dp_select(cp, rows_c, r.double(), mask, True)  # wrong dtype
    with pytest.raises(ValueError, match="dpselect"):
        zs.dp_select(cp, rows_c.long(), r, mask, True)  # wrong index type
    with pytest.raises(ValueError, match="dpselect"):
        zs.dp_select(cp, rows_c, r[:, :-1], mask, True)  # wrong shape
    with pytest.raises(ValueError, match="dpselect"):
        zs.dp_select(cp, rows_c, r.transpose(0, 2).contiguous().transpose(0, 2), mask, True)
