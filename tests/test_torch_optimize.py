"""The port's optimize driver against the JAX package, on the CPU.

- At a fixed sweep budget on a small set cover, the port finds a solution
  the JAX package's validator accepts, with an objective within 15% of
  the JAX optimizer's at the same parameters (both are randomized
  heuristics with different random streams).
- State carried across from the JAX package (convert.py) gives the same
  psweep result as the port's own state.
- The port imports and solves with jax blocked, and names neither jax nor
  the JAX package anywhere in its files or in chip_smoke.py.
- The same on two Z (integer-factor) instances, through the Z sweep.
- Without CUDA and without an explicit device the entry points raise;
  what the slice does not cover is refused, never rerouted.
"""

import dataclasses
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import baryonyx_tpu as bx
from baryonyx_tpu.generators import random_set_cover_lp, random_z_multiknapsack_lp
from baryonyx_tpu.ops.layout import compile_problem as jcompile
from baryonyx_tpu.preprocess.fixing import preprocess as jpreprocess
from baryonyx_tpu.preprocess.merge import make_merged_constraints as jmerge
from baryonyx_tpu.solver.optimize import ReplicaState as JReplicaState

import baryonyx_torch as bt
from baryonyx_torch import convert
from baryonyx_torch.ops import psweep as tpw
from baryonyx_torch.ops.layout import compile_problem as tcompile
from baryonyx_torch.preprocess.fixing import preprocess as tpreprocess
from baryonyx_torch.preprocess.merge import make_merged_constraints as tmerge

REPO = Path(__file__).resolve().parent.parent
LP = random_set_cover_lp(60, 240, 0.05, seed=11)
BAND = 0.15


def _ctx(mod):
    ctx = mod.make_context(0)
    ctx.parameters.seed = 42
    ctx.parameters.limit = 200  # no time limit: a fixed 200-sweep budget
    ctx.parameters.thread = 16
    return ctx


def test_optimize_cpu_matches_jax_within_band():
    raw_j = bx.parse_lp(LP)
    rj = bx.optimize(_ctx(bx), raw_j)
    rt = bt.optimize(_ctx(bt), bt.parse_lp(LP), device="cpu")
    assert rj.status == bx.ResultStatus.success
    assert rt.status == bt.ResultStatus.success
    assert rt.loop == rj.loop == 200
    assert bx.is_valid_solution(raw_j, rt)
    assert bx.compute_solution(raw_j, rt) == pytest.approx(rt.value)
    assert abs(rt.value - rj.value) <= BAND * abs(rj.value)


# Z instances: a small multiknapsack (enumeration and DP rows) and a
# 24-variable row of factor 2 (tests/test_z_solver.py's long-row case,
# past the exact enumeration's 20 variables), whose optimum is 3
Z_ROW = "minimize\nobj: {}\nst\nc1: {} >= 4\nend\n".format(
    " + ".join(f"{i + 1} x{i}" for i in range(24)),
    " + ".join(f"2 x{i}" for i in range(24)),
)
Z_LPS = {
    "zknap24x90": random_z_multiknapsack_lp(24, 90, seed=1),
    "z_row24": Z_ROW,
}


@pytest.mark.parametrize("name", list(Z_LPS))
def test_optimize_z_cpu_matches_jax_within_band(name):
    lp = Z_LPS[name]
    raw_j = bx.parse_lp(lp)
    rj = bx.optimize(_ctx(bx), raw_j)
    rt = bt.optimize(_ctx(bt), bt.parse_lp(lp), device="cpu")
    assert rj.status == bx.ResultStatus.success
    assert rt.status == bt.ResultStatus.success
    assert rt.loop == rj.loop == 200
    assert "exact" not in rt.method
    assert bx.is_valid_solution(raw_j, rt)
    assert bx.compute_solution(raw_j, rt) == pytest.approx(rt.value)
    assert abs(rt.value - rj.value) <= BAND * abs(rj.value)
    if name == "z_row24":
        assert rt.value == rj.value == 3.0


def test_convert_round_trip_gives_the_same_psweep():
    ctx = bx.make_context(0)
    pb = jpreprocess(ctx, bx.parse_lp(LP))
    jcp = jcompile(jmerge(ctx, pb), len(pb.vars.values))
    R = 64
    rng = np.random.default_rng(0)
    f = np.float32
    jrs = JReplicaState(
        x=(rng.random((jcp.n, R)) < 0.3).astype(np.int32),
        P=rng.normal(0, 0.01, (jcp.m, jcp.Kr, R)).astype(f),
        pi=rng.normal(0, 0.01, (jcp.m, R)).astype(f),
        S=np.zeros((jcp.n, R), f),
        viol=rng.random((jcp.m, R)) < 0.5,
        kappa=np.full(R, 0.1, f), kappa_start=np.full(R, 0.1, f),
        kappa_append=np.full(R, 0.02, f),
        iter_i=np.zeros(R, np.int32), phase=np.zeros(R, np.int32),
        push_idx=np.zeros(R, np.int32),
        best_remaining=np.full(R, 2**31 - 1, np.int32),
        restarts=np.zeros(R, np.int32), best_value=np.full(R, np.inf, f),
    )
    cp_a = convert.compiled_problem(
        {fl.name: np.asarray(getattr(jcp, fl.name)) for fl in dataclasses.fields(jcp)},
        device="cpu",
    )
    rs_a = convert.replica_state({k: np.asarray(v) for k, v in jrs._asdict().items()}, "cpu")
    tctx = bt.make_context(0)
    tpb = tpreprocess(tctx, bt.parse_lp(LP))
    cp_b = tcompile(tmerge(tctx, tpb), len(tpb.vars.values), device="cpu")
    cost = torch.as_tensor(1.0 + np.arange(jcp.n, dtype=np.float32))
    outs = []
    for cp, x, P, pi, viol in (
        (cp_a, rs_a.x, rs_a.P, rs_a.pi, rs_a.viol),
        (cp_b, *(torch.as_tensor(np.array(jrs[i])) for i in (0, 1, 2, 4))),
    ):
        out = tpw.psweep(
            cp, x, P.clone(), pi.clone(), cost, viol,
            torch.arange(cp.m, dtype=torch.int32), torch.full((R,), 0.1), 0.01,
            0.5, torch.tensor([3, -7], dtype=torch.int32), torch.zeros(R),
        )
        outs.append(out)
    for a, b in zip(*outs):
        assert torch.equal(a, b)


def test_port_runs_without_jax_and_never_names_it():
    code = (
        "import sys; sys.modules['jax'] = None\n"
        "import baryonyx_torch as bt\n"
        "from baryonyx_torch.generators import random_set_cover_lp\n"
        "ctx = bt.make_context(0); ctx.parameters.seed = 1\n"
        "ctx.parameters.limit = 50\n"
        "raw = bt.parse_lp(random_set_cover_lp(30, 90, 0.08, seed=2))\n"
        "r = bt.optimize(ctx, raw, device='cpu')\n"
        "assert 'jax' not in sys.modules or sys.modules['jax'] is None\n"
        "print(r.status.name, bt.is_valid_solution(raw, r))\n"
    )
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True,
        env=env, cwd=REPO, timeout=300,
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.split()[-2:] == ["success", "True"]

    pattern = re.compile(r"baryonyx_tpu|^\s*(import jax|from jax)", re.M)
    files = list((REPO / "baryonyx_torch").rglob("*.py"))
    files += list((REPO / "baryonyx_torch").rglob("*.cu"))
    files.append(REPO / "chip_smoke.py")
    assert len(files) > 20
    for path in files:
        assert not pattern.search(path.read_text()), path


def test_entry_points_need_a_device_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    raw = bt.parse_lp(random_set_cover_lp(30, 90, 0.08, seed=2))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        bt.optimize(bt.make_context(0), raw)
    ctx = bt.make_context(0)
    pb = tpreprocess(ctx, raw)
    with pytest.raises(RuntimeError, match="CUDA"):
        tcompile(tmerge(ctx, pb), len(pb.vars.values))


def test_uncovered_inputs_are_refused():
    ctx = bt.make_context(0)
    ctx.parameters.limit = 10
    z_quad = Z_ROW.replace("\nst\n", " + [ 4 x0 * x1 ] / 2\nst\n")
    with pytest.raises(NotImplementedError, match="ROADMAP.md Queue 1 item 9"):
        bt.optimize(ctx, bt.parse_lp(z_quad), device="cpu")
    raw = bt.parse_lp(LP)
    with pytest.raises(NotImplementedError, match="ROADMAP.md Queue 1 item 7"):
        bt.solve(bt.make_context(0), raw, device="cpu")
    ctx = bt.make_context(0)
    ctx.parameters.float_type = bt.FloatType.float64
    with pytest.raises(NotImplementedError, match="float64"):
        bt.optimize(ctx, raw, device="cpu")
    ctx = bt.make_context(0)
    ctx.parameters.mode = bt.ModeType.manual
    with pytest.raises(NotImplementedError, match="meta-optimizer"):
        bt.optimize(ctx, raw, device="cpu")


def test_state_over_the_device_budget_is_refused(monkeypatch):
    from baryonyx_torch.solver import optimize as topt

    monkeypatch.setattr(topt, "device_budget_bytes", lambda device: 1)
    ctx = bt.make_context(0)
    ctx.parameters.limit = 10
    with pytest.raises(NotImplementedError, match="ROADMAP.md Queue 1 item 11"):
        bt.optimize(ctx, bt.parse_lp(LP), device="cpu")
