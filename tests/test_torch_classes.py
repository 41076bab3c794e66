"""The port's optimize against the JAX package's on the problem classes the
fused sweep's main path does not cover, on the CPU: equality set
partitioning, dial-a-ride crew scheduling (telebus, integer costs up to
900,000), bus-driver scheduling (unit costs, long rows), n-queens (= and
<= rows), and a maximizing instance with ±1 factors (knapsack-101, whose
rows read middle ranks: the general sweep's full sort).

At a fixed budget of 200 sweeps with 16 replicas, each side's result is
valid and the port's objective is within 15% of the JAX optimizer's at the
same parameters (both are randomized heuristics with different random
streams; the same band as tests/test_torch_optimize.py). Every instance has
more than 20 variables, so the exact enumeration does not answer for the
heuristic.

A maximized Z instance (a multiknapsack whose first line says maximize)
ends the same way in both packages: the Z sweep's duals grow about 20x per
sweep when maximizing (ROADMAP.md Queue 3), and at 200 sweeps neither
finds a feasible solution; the port's status and its count of violated
rows match the JAX package's within one row.
"""

import numpy as np
import pytest
import torch

import baryonyx_tpu as bx
from baryonyx_tpu.generators import (
    bus_driver_scheduling_lp,
    n_queens_lp,
    random_knapsack_101_lp,
    random_set_partition_lp,
    random_z_multiknapsack_lp,
    telebus_crew_lp,
)

import baryonyx_torch as bt
from baryonyx_torch.ops.layout import compile_problem as tcompile
from baryonyx_torch.preprocess.fixing import preprocess as tpreprocess
from baryonyx_torch.preprocess.merge import make_merged_constraints as tmerge

BAND = 0.15

# name: (LP, minimize, sel_reduction_ok: the fused sweep's plain version
# runs where True, the general sweep where False)
CLASSES = {
    "set_partition": (random_set_partition_lp(30, 10, 3, (1, 100), 40, seed=1),
                      True, True),
    "telebus": (telebus_crew_lp(40, 10, 4, seed=3), True, True),
    "bus_driver": (bus_driver_scheduling_lp(20, 6, 5, seed=1), True, True),
    "n_queens": (n_queens_lp(8, costs=list(np.random.default_rng(3).integers(
        1, 50, 64).astype(float))), True, True),
    "knapsack101_max": (random_knapsack_101_lp(40, 8, seed=3), False, False),
}


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _ctx(mod):
    ctx = mod.make_context(0)
    ctx.parameters.seed = 42
    ctx.parameters.limit = 200  # no time limit: a fixed 200-sweep budget
    ctx.parameters.thread = 16
    return ctx


@pytest.mark.parametrize("name", list(CLASSES))
def test_optimize_matches_jax_within_band(name):
    lp, minimize, sel_ok = CLASSES[name]
    raw_t = bt.parse_lp(lp)
    assert len(raw_t.vars.names) > 20
    ctx = _ctx(bt)
    pb = tpreprocess(ctx, raw_t)
    cp = tcompile(tmerge(ctx, pb), len(pb.vars.values), device="cpu")
    assert not cp.has_z and cp.sel_reduction_ok == sel_ok
    assert bool((cp.row_factor < 0).any()) == (name == "knapsack101_max")
    assert raw_t.type == (bt.ObjectiveType.minimize if minimize
                          else bt.ObjectiveType.maximize)

    rt = bt.optimize(_ctx(bt), raw_t, device="cpu")
    raw_j = bx.parse_lp(lp)
    rj = bx.optimize(_ctx(bx), raw_j)
    assert rt.status == bt.ResultStatus.success
    assert rj.status == bx.ResultStatus.success
    assert rt.loop == rj.loop == 200
    assert "exact" not in rt.method
    assert bx.is_valid_solution(raw_j, rt)
    assert bx.compute_solution(raw_j, rt) == pytest.approx(rt.value)
    assert abs(rt.value - rj.value) <= BAND * abs(rj.value)


def test_maximized_z_instance_ends_as_in_jax():
    lp = random_z_multiknapsack_lp(24, 90, seed=1)
    assert lp.startswith("minimize\n")
    lp = "maximize\n" + lp.split("\n", 1)[1]
    rt = bt.optimize(_ctx(bt), bt.parse_lp(lp), device="cpu")
    rj = bx.optimize(_ctx(bx), bx.parse_lp(lp))
    assert rt.loop == rj.loop == 200
    assert rt.status.name == rj.status.name
    assert abs(rt.remaining_constraints - rj.remaining_constraints) <= 1
