"""The evolution step's CUDA graphs (``solver/optimize.py:StepGraphs``).

On the CPU (no JAX, no card):

- the rule ``step_graphs_apply`` decides from shapes and flags alone: the
  graphs apply on a CUDA device where the step runs the fused sweep and
  holds no collective;
- ``StepGraphs`` with a stand-in for the capture that runs each "replay"
  eagerly gives ``one_step``'s run bit for bit over 40 steps (two
  column-sum recomputes, a chunk boundary, a cataclysm between chunks):
  the buffers, the copies around the sweep and at a chunk's start, the
  flip counts' chunk delta. On a cover, under two ablation hooks that
  keep state tensors as they are, with the cycle order, and on a
  quadratic objective;
- the same over two gloo ranks, whose chunks end in the flip counts' sum
  and the population exchange;
- a replayed step adds 1 to the count ``optimize.graphed_steps`` while a
  profiler runs; a step run eagerly (the warm-up) adds nothing.

On the card (``python -m pytest --noconftest -m gpu
tests/test_torch_step_graph.py``): the same 40 steps on scp200x1000 at R
2048, through the real graphs and through ``one_step``, bit for bit, the
random stream's state included, with the peak of device memory under 1 GB;
with the default order and with the cycle order.
"""

import contextlib

import pytest
import torch

import baryonyx_torch as bt
from baryonyx_torch import spans
from baryonyx_torch.core.params import ConstraintOrder
from baryonyx_torch.generators import (
    random_qsap_lp,
    random_set_cover_lp,
    random_z_multiknapsack_lp,
)
from baryonyx_torch.ops.layout import compile_problem
from baryonyx_torch.preprocess.fixing import preprocess
from baryonyx_torch.preprocess.merge import make_merged_constraints
from baryonyx_torch.solver import optimize as topt
from step_graph_run import PLAN, mismatches, run_plan

COVER = random_set_cover_lp(60, 240, 0.05, seed=11)
QSAP = random_qsap_lp(12, 6, seed=2)
ZKNAP = random_z_multiknapsack_lp(24, 90, seed=1)
CUDA = torch.device("cuda")


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _compiled(lp: str, dtype=torch.float32):
    ctx = bt.make_context(0)
    pb = preprocess(ctx, bt.parse_lp(lp))
    return compile_problem(
        make_merged_constraints(ctx, pb), len(pb.vars.values), dtype=dtype,
        qelements=pb.objective.qelements, device="cpu",
    )


def _inputs(lp=COVER, dtype=torch.float32, random_solver=False, cycle=False,
            mesh=None, dense_quad=True):
    cp = _compiled(lp, dtype)
    quad_mat = torch.zeros((cp.n, cp.n), dtype=dtype) if cp.has_quad and dense_quad else None
    return topt.EvolveInputs(
        cp=cp, cost_norm=None, cost_orig=None, cost_constant=0.0,
        bastert_x=None, hash_weights=None, hp={"use_cycle": cycle},
        minimize=True, block_size=4, random_solver=random_solver,
        quad_mat=quad_mat, mesh=mesh,
    )


RULE_CASES = {
    # name: (inputs, R, dtype, device, graphs apply)
    "cuda_fused": (dict(), 2048, torch.float32, CUDA, True),
    "cpu": (dict(), 2048, torch.float32, torch.device("cpu"), False),
    "z_instance": (dict(lp=ZKNAP), 2048, torch.float32, CUDA, False),
    "random_solver": (dict(random_solver=True), 2048, torch.float32, CUDA, False),
    "float64": (dict(dtype=torch.float64), 2048, torch.float64, CUDA, False),
    "R_off_32": (dict(), 2040, torch.float32, CUDA, False),
    "cycle_over_a_mesh": (dict(cycle=True, mesh=object()), 2048, torch.float32, CUDA, False),
    "cycle_on_one_process": (dict(cycle=True), 2048, torch.float32, CUDA, True),
    "mesh_without_cycle": (dict(mesh=object()), 2048, torch.float32, CUDA, True),
    "quadratic_dense": (dict(lp=QSAP), 2048, torch.float32, CUDA, True),
    "quadratic_past_dense_limit": (dict(lp=QSAP, dense_quad=False), 2048, torch.float32,
                                   CUDA, False),
}


@pytest.mark.parametrize("name", list(RULE_CASES))
def test_graphs_apply_where_the_rule_says(name):
    kw, R, dtype, device, want = RULE_CASES[name]
    ev = _inputs(**kw)
    assert topt.step_graphs_apply(ev, R, dtype, device) is want
    # the rule follows the sweep the step runs
    if want:
        assert topt.sweep_kind(ev, R, dtype, device) == "fused"


class EagerCapture:
    """A stand-in for ``CudaCapture`` on the CPU: "capturing" runs the
    function with the random stream put back afterwards (a capture draws
    nothing), and each replay runs it again, its tensors copied into the
    first run's (a graph writes its outputs where it captured them)."""

    def __init__(self, gen, device):
        self.gen = gen

    def side_stream(self):
        return contextlib.nullcontext()

    def __call__(self, fn):
        state = self.gen.get_state()
        out = fn()
        self.gen.set_state(state)

        def replay():
            new = fn()
            for a, b in zip(out or (), new or ()):
                if isinstance(a, torch.Tensor):
                    a.copy_(b)
        return out, replay

    def close(self):
        pass


@pytest.fixture
def eager_capture(monkeypatch):
    monkeypatch.setattr(topt.StepGraphs, "capture_cls", EagerCapture)


@pytest.mark.parametrize("lp,ablate,params", [
    (COVER, "", {}), (COVER, "compact", {}), (COVER, "insert", {}), (QSAP, "", {}),
    (COVER, "", {"order": ConstraintOrder.cycle}),
], ids=["cover", "cover_compact", "cover_insert", "qsap", "cover_cycle"])
def test_step_graphs_give_one_steps_run_bit_for_bit(eager_capture, monkeypatch, lp, ablate,
                                                    params):
    if ablate:
        monkeypatch.setenv("BARYONYX_ABLATE", ablate)
    raw = bt.parse_lp(lp)
    eager = run_plan(bt, raw, "cpu", graphed=False, **params)
    graphed = run_plan(bt, raw, "cpu", graphed=True, **params)
    assert eager["rule"] is False  # the CPU: only the stand-in replays here
    assert [s["sweeps"] for s in graphed["snaps"]] == [13, 26, 26, 40]
    assert mismatches(graphed, eager) == {}
    # the run moved: flips counted, the population changed at the cataclysm
    last, first = graphed["snaps"][-1], graphed["snaps"][0]
    assert last["flips"].sum() > 0
    assert not torch.equal(graphed["snaps"][2]["pop.x"], graphed["snaps"][1]["pop.x"])
    assert not torch.equal(last["x"], first["x"])
    assert graphed["result"].loop == eager["result"].loop == 40


def test_replayed_steps_count_under_a_profiler(eager_capture):
    raw = bt.parse_lp(COVER)
    spans.reset()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        run_plan(bt, raw, "cpu", graphed=False, plan=(3, 4))
        assert "optimize.graphed_steps" not in spans.snapshot()["traced"]
        run_plan(bt, raw, "cpu", graphed=True, plan=(3, 4))
        graphed = spans.snapshot()["traced"].get("optimize.graphed_steps")
    assert graphed is not None and graphed["n"] == 3 + 4 - 1  # less the warm-up


def _graphed_against_eager(lp: str):
    """On a rank of a process group: the same plan with the steps' graphs
    (the stand-in capture) and without; no cataclysm, which a group does
    not run. The population exchange and the flip counts' sum meet the
    ranks once per chunk."""
    topt.StepGraphs.capture_cls = EagerCapture
    raw = bt.parse_lp(lp)
    plan = (13, 13, 14)
    eager = run_plan(bt, raw, "cpu", graphed=False, plan=plan)
    graphed = run_plan(bt, raw, "cpu", graphed=True, plan=plan)
    return mismatches(graphed, eager), [s["sweeps"] for s in graphed["snaps"]]


def test_step_graphs_give_one_steps_run_over_two_ranks():
    from spawn_ranks import spawn

    for bad, sweeps in spawn(_graphed_against_eager, 2, (COVER,), timeout_s=240.0):
        assert bad == {} and sweeps == [13, 26, 40]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.mark.gpu
@pytest.mark.parametrize("order", [None, ConstraintOrder.cycle], ids=["default", "cycle"])
def test_graphed_steps_equal_eager_steps_on_the_card(cuda, order):
    """The cycle order builds every policy's order in each step (all their
    operations in the captured part) and picks one on the card."""
    raw = bt.parse_lp(random_set_cover_lp(200, 1000, 0.02, seed=41))
    params = {} if order is None else {"order": order}
    eager = run_plan(bt, raw, cuda, graphed=False, **params)
    torch.cuda.reset_peak_memory_stats(cuda)
    graphed = run_plan(bt, raw, cuda, graphed=True, **params)
    peak = torch.cuda.max_memory_allocated(cuda)
    assert graphed["rule"] is True and graphed["result"].replicas == 2048
    assert [s["sweeps"] for s in graphed["snaps"]] == [13, 26, 26, 40]
    assert mismatches(graphed, eager) == {}
    assert peak < 2**30, peak
    assert len(PLAN) == len(graphed["snaps"])
