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
  what the port does not cover is refused, never rerouted.
- A state over the device budget on one process warns, as the JAX
  package does, and proceeds.
- The random solver skips the exact enumeration of small instances, as
  in the JAX package.
- What the fused sweep does not take (float64, the random solver, an
  instance whose selection needs the full sort, a replica count it
  refuses) runs through the general sweep, chosen in ``one_step``; each
  result is valid and, where the JAX optimizer runs the same thing,
  within the same 15% of it.
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


@pytest.fixture(autouse=True)
def one_torch_thread():
    """Eager torch ops on these small tensors gain nothing from threads,
    and the test workers share the machine's cores: one thread each."""
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
    files += list((REPO / "baryonyx_torch").rglob("*.cpp"))
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
    ctx.parameters.solver = bt.SolverType.random
    with pytest.raises(NotImplementedError, match="random solver for Z"):
        bt.optimize(ctx, bt.parse_lp(Z_ROW), device="cpu")


def test_random_solver_skips_the_exact_enumeration():
    """On an instance of at most EXACT_N_MAX variables the random solver
    runs, as in the JAX package, instead of returning the enumerated
    optimum; the default solver enumerates."""
    from baryonyx_torch.solver.exact import EXACT_N_MAX

    lp = random_set_cover_lp(8, 16, 0.3, seed=3)
    raw_t = bt.parse_lp(lp)
    assert len(raw_t.vars.names) <= EXACT_N_MAX
    results = {}
    for solver in ("bastert", "random"):
        ctx_t, ctx_j = _ctx(bt), _ctx(bx)
        ctx_t.parameters.limit = ctx_j.parameters.limit = 20
        for ctx, mod in ((ctx_t, bt), (ctx_j, bx)):
            ctx.parameters.solver = getattr(mod.SolverType, solver)
        results[solver] = (
            bt.optimize(ctx_t, raw_t, device="cpu"),
            bx.optimize(ctx_j, bx.parse_lp(lp)),
        )
    rt, rj = results["random"]
    assert "exact" not in rt.method and "exact" not in rj.method
    assert rt.method == rj.method and rt.loop == rj.loop > 0
    rt, rj = results["bastert"]
    assert rt.method == rj.method == "optimize+exact-enum"
    assert rt.value == rj.value


def _full_sort_lp():
    """LP plus two cardinality rows `sum of 40 variables = 10`, whose
    selection reads ranks no sort-free split covers."""
    names = list(bt.parse_lp(LP).vars.names)
    rows = "".join(
        f"card{i}: " + " + ".join(names[i * 40:(i + 1) * 40]) + " = 10\n"
        for i in range(2)
    )
    head, tail = LP.split("binary\n", 1)
    return head + rows + "binary\n" + tail


def _count_sweeps(monkeypatch):
    """Count the calls of the general and of the fused sweep."""
    from baryonyx_torch.solver import optimize as topt

    calls = {"sweep": 0, "psweep": 0}
    real_sweep, real_psweep = topt.sweep, topt.pw.psweep

    def sweep(*a, **kw):
        calls["sweep"] += 1
        return real_sweep(*a, **kw)

    def psweep(*a, **kw):
        calls["psweep"] += 1
        return real_psweep(*a, **kw)

    monkeypatch.setattr(topt, "sweep", sweep)
    monkeypatch.setattr(topt.pw, "psweep", psweep)
    return calls


GENERAL_CASES = {
    # name: (lp, parameters, compare with the JAX optimizer)
    "float64": (lambda: LP, dict(float_type="float64"), True),
    "random_solver": (lambda: LP, dict(solver="random"), False),
    "full_sort": (_full_sort_lp, {}, True),
}


@pytest.mark.parametrize("name", list(GENERAL_CASES))
def test_optimize_through_the_general_sweep(name, monkeypatch):
    lp, kw, compare = GENERAL_CASES[name]
    text = lp()

    def ctx_of(mod):
        ctx = _ctx(mod)
        for k, v in kw.items():
            enum = {"float_type": "FloatType", "solver": "SolverType"}[k]
            setattr(ctx.parameters, k, getattr(getattr(mod, enum), v))
        return ctx

    calls = _count_sweeps(monkeypatch)
    raw_t = bt.parse_lp(text)
    rt = bt.optimize(ctx_of(bt), raw_t, device="cpu")
    assert calls == {"sweep": 200, "psweep": 0}
    assert rt.loop == 200 and "exact" not in rt.method
    if name == "random_solver":
        # a randomized greedy fill: no claim on what it finds
        if rt.status == bt.ResultStatus.success:
            assert bt.is_valid_solution(raw_t, rt)
        return
    assert rt.status == bt.ResultStatus.success
    assert bt.is_valid_solution(raw_t, rt)
    if compare:
        import jax

        raw_j = bx.parse_lp(text)
        with jax.enable_x64(name == "float64"):
            rj = bx.optimize(ctx_of(bx), raw_j)
        assert rj.status == bx.ResultStatus.success
        assert bx.is_valid_solution(raw_j, rt)
        assert abs(rt.value - rj.value) <= BAND * abs(rj.value)


def test_optimize_thread_5(monkeypatch):
    """Five replicas: the fused sweep's plain version takes them on the
    CPU; on a CUDA device its kernel wants a multiple of 32 and
    ``one_step`` goes to the general sweep, which the second run forces."""
    from baryonyx_torch.solver import optimize as topt

    raw = bt.parse_lp(LP)
    for force_general in (False, True):
        with monkeypatch.context() as mp:
            calls = _count_sweeps(mp)
            if force_general:
                mp.setattr(
                    topt.pw, "supports",
                    lambda cp, R, dtype, device: R % 32 == 0,
                )
            ctx = _ctx(bt)
            ctx.parameters.thread = 5
            rt = bt.optimize(ctx, raw, device="cpu")
        assert rt.replicas == 5 and rt.loop == 200
        assert calls == (
            {"sweep": 200, "psweep": 0} if force_general
            else {"sweep": 0, "psweep": 200}
        )
        assert rt.status == bt.ResultStatus.success
        assert bt.is_valid_solution(raw, rt)
    rj = bx.optimize(_ctx(bx), bx.parse_lp(LP))
    assert abs(rt.value - rj.value) <= BAND * abs(rj.value)


def test_fused_sweep_wrapper_still_refuses_an_unsupported_call():
    """The dispatch lives in ``one_step``: called directly with what it
    does not take, the fused sweep raises and switches to nothing."""
    tctx = bt.make_context(0)
    tpb = tpreprocess(tctx, bt.parse_lp(_full_sort_lp()))
    cp = tcompile(tmerge(tctx, tpb), len(tpb.vars.values), device="cpu")
    assert not cp.sel_reduction_ok
    R = 4
    args = (
        torch.zeros((cp.n, R), dtype=torch.int32),
        torch.zeros((cp.m, cp.Kr, R)), torch.zeros((cp.m, R)),
        torch.ones(cp.n), torch.ones((cp.m, R), dtype=torch.bool),
        torch.arange(cp.m, dtype=torch.int32), torch.full((R,), 0.1), 0.01,
        0.5, torch.tensor([3, -7], dtype=torch.int32), torch.zeros(R),
    )
    for fn in (tpw.psweep, tpw.psweep_reference):
        with pytest.raises(NotImplementedError, match="fused sweep"):
            fn(cp, *args)


def test_memory_estimate_counts_the_general_sweep():
    from baryonyx_torch.memory import estimated_peak_bytes

    tctx = bt.make_context(0)
    tpb = tpreprocess(tctx, bt.parse_lp(LP))
    cp = tcompile(tmerge(tctx, tpb), len(tpb.vars.values), device="cpu")
    fused = estimated_peak_bytes(cp, 512, B=8)
    general = estimated_peak_bytes(cp, 512, B=8, general_sweep=True)
    assert general >= fused + 12 * 8 * cp.Kr * 512 * 4
    assert estimated_peak_bytes(cp, 512, itemsize=8, general_sweep=True) > general


def test_state_over_the_device_budget_warns_and_proceeds_on_one_device(monkeypatch):
    """Past the device budget, one process (no group to shard the rows
    over) says so with the JAX package's warning and still solves."""
    monkeypatch.setenv("BARYONYX_HBM_BUDGET", "1")
    ctx = _ctx(bt)
    warnings = []
    ctx.warning = lambda msg, *a: warnings.append(msg.format(*a))
    raw = bt.parse_lp(LP)
    rt = bt.optimize(ctx, raw, device="cpu")
    assert any(
        "exceeds the device memory budget and row sharding does not apply"
        in w for w in warnings
    ), warnings
    assert "rowshard" not in rt.method and rt.loop == 200
    assert rt.status == bt.ResultStatus.success
    assert bt.is_valid_solution(raw, rt)
