"""The launch plans of the port's two CUDA kernels (pure Python, no card).

``launch_plan`` (the fused sweep, csrc/psweep.cu) and ``dp_launch_plan``
(the knapsack DP, csrc/dpselect.cu) must give every shape the dispatchers
admit a plan the card can launch: at most 232,448 bytes of shared memory
(static part included), at most 1,024 threads, a replica group that
divides 32, a grid of at least one CUDA block. The four shapes the smoke
script drives (scp200x1000, the scpnre class, the quadratic qsap500x10,
DP tables of width 88 and 2048) must get the redesigned variants, not the
first designs. Phase B of
the sweep kernel applies the slots of one row in parallel: that rests on
the variables of a row being distinct, which is checked here on the four
instance classes of tests/test_torch_layout.py.
"""

import pytest
import torch

import baryonyx_torch.core.context as tctx
import baryonyx_torch.io.lp_parse as tlp
import baryonyx_torch.ops.layout as tlayout
import baryonyx_torch.preprocess.fixing as tfix
import baryonyx_torch.preprocess.merge as tmerge
from baryonyx_torch.generators import (
    n_queens_lp,
    random_knapsack_101_lp,
    random_set_cover_lp,
    random_z_multiknapsack_lp,
)
from baryonyx_torch.ops import psweep as pw
from baryonyx_torch.ops import zsweep as zs

SMEM_MAX = 232_448
THREADS_MAX = 1024

SWEEP_SHAPES = {
    # name: (n, Kr, R, Bb, the variant it must get or None)
    "scp200x1000": (1024, 40, 2048, 4, "group"),
    "scpnre500x5000": (5120, 576, 2048, 4, "group"),
    # random_qsap_lp(500, 10, seed=3): m 512, n 5120, Kr 16
    "qsap500x10": (5120, 16, 2048, 4, "group"),
    "longest_rows": (1024, 2048, 2048, 4, None),
    "largest_block": (1024, 40, 2048, 16, None),
    "longest_rows_largest_block": (50_000, 2048, 32, 16, None),
    "fewest_replicas": (1024, 40, 32, 4, None),
    "many_variables": (50_000, 40, 2048, 4, None),
    "many_variables_long_rows": (50_000, 576, 2048, 8, None),
    "one_row_per_block": (1024, 300, 64, 1, None),
}


@pytest.mark.parametrize("name", list(SWEEP_SHAPES))
def test_sweep_plan_fits_the_card(name):
    n, Kr, R, Bb, variant = SWEEP_SHAPES[name]
    plan = pw.launch_plan(n, Kr, R, Bb)
    assert plan.variant in ("group", "replica_thread")
    if variant is not None:
        assert plan.variant == variant
    assert 0 <= plan.smem_bytes and plan.smem_bytes + pw.SMEM_STATIC <= SMEM_MAX
    assert 32 <= plan.threads <= THREADS_MAX and plan.threads % 32 == 0
    assert plan.G >= 1 and 32 % plan.G == 0 and R % plan.G == 0
    assert plan.grid(R) >= 1
    if plan.variant == "group":
        lanes_per_row = plan.Wr * (32 // plan.G)
        assert plan.threads == Bb * plan.Wr * 32
        assert plan.T == Bb * lanes_per_row
        assert plan.key_storage in ("registers", "shared")
        if plan.key_storage == "registers":
            assert Kr <= pw.NQ * lanes_per_row
            assert plan.threads <= pw.GROUP_THREADS_REGS
        else:
            assert plan.smem_bytes >= 4 * Bb * Kr * plan.G
            assert plan.threads <= pw.GROUP_THREADS_MAX
        if plan.s_resident:
            assert plan.smem_bytes >= 4 * n * plan.G
        # the same choices give the same plan, and the kernel's own
        # arithmetic for the shared memory agrees with the plan's
        again = pw.group_plan(
            n, Kr, Bb, plan.G, plan.Wr, plan.key_storage == "registers",
            plan.s_resident,
        )
        assert again == plan
    else:
        assert plan == pw.REPLICA_THREAD and plan.key_storage == "device"


def test_sweep_plan_refuses_what_the_kernel_does_not_take():
    with pytest.raises(ValueError):
        pw.launch_plan(1024, 40, 48, 4)  # R % 32
    with pytest.raises(ValueError):
        pw.launch_plan(1024, 40, 64, 17)  # Bb > MAX_B
    with pytest.raises(ValueError):
        pw.group_plan(1024, 40, 4, 8, 8, False)  # 1,024 threads
    with pytest.raises(ValueError):
        pw.group_plan(1024, 576, 4, 8, 2, True)  # too long for register keys
    with pytest.raises(ValueError):
        pw.group_plan(5120, 576, 4, 8, 4, False, True)  # tile and S: too large


@pytest.mark.parametrize("Kr", [24, 40, 100])
@pytest.mark.parametrize("W", [1, 88, 2048, 30_000])
def test_dp_plan_fits_the_card(W, Kr):
    R, B = 512, 8
    plan = zs.dp_launch_plan(W, Kr, R, B)
    assert plan.variant in ("shared", "device_table")
    if W in (88, 2048):
        assert plan.variant == "shared"
    assert 0 <= plan.smem_bytes and plan.smem_bytes + pw.SMEM_STATIC <= SMEM_MAX
    assert 32 <= plan.threads <= THREADS_MAX and plan.threads % 32 == 0
    assert plan.G >= 1 and 32 % plan.G == 0 and R % plan.G == 0
    gx, gy = plan.grid(R, B)
    assert gx >= 1 and gy == B
    if plan.variant == "shared":
        nw = (Kr + 31) // 32
        assert plan.smem_bytes >= 4 * (2 + nw) * W * plan.G
        assert zs.dp_plan(W, Kr, plan.G, plan.T) == plan
    else:
        # no group size holds this table
        assert 4 * (2 + (Kr + 31) // 32) * W > SMEM_MAX
        assert plan == zs.DEVICE_TABLE


def test_dp_plan_takes_a_group_that_divides_the_replicas():
    plan = zs.dp_launch_plan(88, 24, 12, 8)
    assert plan.variant == "shared" and 12 % plan.G == 0
    with pytest.raises(ValueError):
        zs.dp_plan(88, 24, 8, 3)  # 24 threads: no whole warp
    with pytest.raises(ValueError):
        zs.dp_plan(88, 24, 8, 256)  # 2,048 threads
    with pytest.raises(ValueError):
        zs.dp_plan(30_000, 24, 8, 128)  # the table does not fit


INSTANCES = {
    "scp": lambda: random_set_cover_lp(40, 160, 0.06, seed=5),
    "nqueens": lambda: n_queens_lp(8),
    "knapsack101": lambda: random_knapsack_101_lp(16, 40, seed=3),
    "zmultiknapsack": lambda: random_z_multiknapsack_lp(12, 40, seed=2),
}


@pytest.mark.parametrize("name", list(INSTANCES))
def test_the_variables_of_a_row_are_distinct(name):
    """Merged constraints included: the live slots of every row of
    ``row_vars`` name distinct variables."""
    ctx = tctx.make_context(0)
    pb = tfix.preprocess(ctx, tlp.parse_lp(INSTANCES[name]()))
    cp = tlayout.compile_problem(
        tmerge.make_merged_constraints(ctx, pb), len(pb.vars.values), device="cpu"
    )
    assert cp.m_real > 0
    for k in range(cp.m):
        live = cp.row_vars[k, : int(cp.r_size[k])]
        assert torch.equal(cp.row_mask[k].nonzero().flatten(),
                           torch.arange(live.numel()))
        assert live.unique().numel() == live.numel(), f"row {k} repeats a variable"
    meta = cp.rowmeta()
    assert meta.shape == (cp.m, 5) and meta.dtype == torch.int32
    assert cp.rowmeta() is meta  # built once per CompiledProblem
    assert torch.equal(meta[:, 3], cp.r_size) and torch.equal(
        meta[:, 4], cp.is_eq.to(torch.int32))


@pytest.mark.parametrize("W,Kr", [(88, 24), (2048, 24)])
@pytest.mark.parametrize("R", [1, 3])
def test_dp_plan_at_solve_mode_replica_counts(W, Kr, R):
    """Solve mode runs one replica: the two Z shapes the smoke script
    drives keep the shared-memory variant there, with a group of one."""
    plan = zs.dp_launch_plan(W, Kr, R, 8)
    assert plan.variant == "shared" and plan.G == 1
    assert plan.threads % 32 == 0 and plan.threads <= zs.DP_LANES_MAX
    assert plan.grid(R, 8) == (R, 8)
    assert plan == zs.dp_plan(W, Kr, 1, plan.T)
