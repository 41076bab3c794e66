"""The port's meta-optimizers, per-replica hyperparameters, population
checkpoints and debug contracts, against the JAX package, on the CPU.

- ``hp_vectors`` tile cyclically onto the replicas (rounded to float32, R
  not grown) and ``replica_best_values`` has one entry per replica; an
  unknown key is refused.
- With ``optimize_compiled`` replaced in both packages by the same
  deterministic stand-in, the manual grid scores the same combos in the
  same chunks and reruns the same winner, Nelder-Mead evaluates the same
  points in the same order, and branch mode optimizes the same subproblems
  (split on the same variables) and returns the same best: the decisions
  of the three modes are the JAX package's, exactly.
- ``--auto:manual``, ``--auto:nlopt`` and ``--auto:branch`` run through
  ``cli.main`` on the CPU and write a valid .sol.
- A population written by either package's ``save_population`` loads in
  the other; a resumed optimize is no worse than the run that wrote the
  checkpoint, also from a JAX checkpoint of its 8-device CPU mesh
  ([8 P, n], of which the best P are kept).
- ``validate_replica_state`` raises on a non-finite probe; a --debug
  optimize runs the probe after every chunk and completes.
"""

import copy
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import baryonyx_tpu as bx
import baryonyx_tpu.checkpoint as jckpt
import baryonyx_tpu.solver.meta as jmeta
import baryonyx_tpu.solver.optimize as jopt
from baryonyx_tpu.core.result import Result as JResult
from baryonyx_tpu.core.result import Solution as JSolution
from baryonyx_tpu.generators import random_set_cover_lp
from baryonyx_tpu.solver.population import Population as JPopulation

import baryonyx_torch as bt
import baryonyx_torch.checkpoint as tckpt
import baryonyx_torch.solver.meta as tmeta
import baryonyx_torch.solver.optimize as topt
from baryonyx_torch.cli import main
from baryonyx_torch.core.contracts import ContractError, validate_replica_state
from baryonyx_torch.core.result import Result as TResult
from baryonyx_torch.core.result import Solution as TSolution
from baryonyx_torch.preprocess.fixing import unpreprocess

LP = random_set_cover_lp(10, 30, 0.2, seed=21)


@pytest.fixture(autouse=True)
def one_torch_thread():
    """Eager torch ops on these small tensors gain nothing from threads,
    and the test workers share the machine's cores: one thread each."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def make_ctx(mod, **kw):
    ctx = mod.make_context(0)
    ctx.parameters.seed = 42
    ctx.parameters.time_limit = 0.5
    ctx.parameters.limit = 50
    ctx.parameters.thread = 4
    ctx.parameters.init_population_size = 8
    for k, v in kw.items():
        setattr(ctx.parameters, k, v)
    return ctx


HP = {
    "theta": np.array([0.3, 0.6, 0.45]),
    "delta": np.array([0.01, 0.002, 0.005]),
    "kappa_min": np.array([0.0, 0.05, 0.1]),
    "kappa_step": np.array([1e-3, 1e-4, 2e-3]),
    "init_policy_random": np.array([0.2, 0.8, 0.5]),
}


def test_hp_vectors_tile_onto_the_replicas(monkeypatch):
    seen = {}
    real = topt.evolve

    def evolve(ev, st, k):
        seen.setdefault("ev", ev)
        seen.setdefault("kappa", st.replicas.kappa.clone())
        return real(ev, st, k)

    monkeypatch.setattr(topt, "evolve", evolve)
    ctx = make_ctx(bt, thread=8)
    pb = unpreprocess(ctx, bt.parse_lp(LP))
    r = topt.optimize_compiled(ctx, pb, device="cpu", hp_vectors=HP)
    assert r.replicas == 8
    rb = r.replica_best_values
    assert rb.shape == (8,) and rb.dtype == np.float64
    assert np.isfinite(rb).any()
    hp = seen["ev"].hp
    for k in ("theta", "delta", "kappa_min", "kappa_step"):
        want = np.resize(HP[k], 8).astype(np.float32)
        assert hp[k].dtype == torch.float32
        np.testing.assert_array_equal(hp[k].numpy(), want)
    # the first ladder rung starts from each replica's own kappa_min
    p = ctx.parameters
    append0 = p.init_kappa_improve_start + p.init_kappa_improve_increase
    kmin = np.resize(HP["kappa_min"], 8)
    np.testing.assert_allclose(
        seen["kappa"].numpy(), kmin + (p.kappa_max - kmin) * append0, rtol=1e-6
    )
    with pytest.raises(ValueError, match="not sweepable"):
        topt.optimize_compiled(ctx, pb, device="cpu", hp_vectors={"alpha": [1.0]})
    # without hp_vectors there is no readout
    assert topt.optimize_compiled(ctx, pb, device="cpu").replica_best_values is None


# --- the three modes' decisions under a shared deterministic stand-in ---


def _bowl(theta, delta, kappa_min, kappa_step, ipr):
    """The stand-in's score of one combo: a bowl with its floor inside
    the Nelder-Mead bounds."""
    return float(
        (theta - 0.37) ** 2 + 40 * (delta - 0.03) ** 2 + (kappa_min - 0.1) ** 2
        + 1e4 * (kappa_step - 0.004) ** 2 + 0.3 * (ipr - 0.6) ** 2
    )


def _stand_in(Result, Solution, log):
    """``optimize_compiled`` replaced: no solver runs. Its score comes
    from the parameters (and, with hp_vectors, per replica from the
    combos); a branch node's from its variables, and it splits on the
    variable of the largest objective factor."""

    def optimize_compiled(ctx, pb, hp_vectors=None, **kw):
        p = ctx.parameters
        res = Result(method="stand-in")
        res.status = type(res.status).success
        res.remaining_constraints = 0
        res.variable_name = list(pb.vars.names)
        if hp_vectors is not None:
            R = p.thread
            cols = [np.resize(np.asarray(hp_vectors[k], np.float64), R)
                    for k in ("theta", "delta", "kappa_min", "kappa_step",
                              "init_policy_random")]
            log.append(("chunk", np.stack(cols, axis=1).tolist()))
            res.replica_best_values = np.array(
                [_bowl(*c) for c in zip(*cols)], np.float64
            )
            value = float(res.replica_best_values.min())
        params = (p.theta, p.delta, p.kappa_min, p.kappa_step,
                  p.init_policy_random)
        if hp_vectors is None:
            factors = {el.variable_index: el.factor for el in pb.objective.elements}
            if factors:
                res.annoying_variable = max(
                    sorted(factors), key=lambda j: factors[j]
                )
            value = _bowl(*params) + sum(factors.values()) + pb.objective.value
            log.append(("run", [float(v) for v in params],
                        tuple(pb.vars.names), value))
        res.solutions = [Solution([0] * len(pb.vars.names), value)]
        return res

    return optimize_compiled


def _decisions(mode, monkeypatch):
    logs = {}
    for name, mod, opt_mod, meta_mod, Result, Solution in (
        ("jax", bx, jopt, jmeta, JResult, JSolution),
        ("torch", bt, topt, tmeta, TResult, TSolution),
    ):
        log = logs[name] = []
        monkeypatch.setattr(opt_mod, "optimize_compiled",
                            _stand_in(Result, Solution, log))
        ctx = make_ctx(mod, thread=64, time_limit=100.0)
        raw = mod.parse_lp(LP)
        kw = {} if mod is bx else {"device": "cpu"}
        if mode == "manual":
            res = meta_mod.manual_optimize(ctx, raw, grid_len=3, **kw)
        elif mode == "nlopt":
            res = meta_mod.nelder_mead_optimize(ctx, raw, **kw)
        else:
            res = meta_mod.branch_optimize(ctx, raw, **kw)
        log.append(("result", res.solutions[-1].value, list(res.variable_name)))
    return logs


@pytest.mark.parametrize("mode", ["manual", "nlopt", "branch"])
def test_meta_decisions_match_jax(mode, monkeypatch):
    logs = _decisions(mode, monkeypatch)
    assert logs["torch"] == logs["jax"]
    kinds = [entry[0] for entry in logs["torch"]]
    if mode == "manual":
        # 3^5 = 243 combos on 64 replicas: 4 chunks, then the winner's run
        assert kinds == ["chunk"] * 4 + ["run", "result"]
    elif mode == "nlopt":
        # the budget, overshot by at most one iteration, and the rerun
        assert tmeta.NM_BUDGET_EVALS + 1 <= kinds.count("run") <= 47
    else:
        # the root, then both halves of every split node
        assert kinds.count("run") >= 3
        names = [entry[2] for entry in logs["torch"] if entry[0] == "run"]
        assert len(set(names)) > 1  # the splits fixed variables


# --- the modes end to end ---


@pytest.mark.parametrize("mode", ["manual", "nlopt", "branch"])
def test_meta_mode_through_the_cli(mode, tmp_path, monkeypatch):
    monkeypatch.setattr(tmeta, "NM_BUDGET_EVALS", 4)
    lp = tmp_path / "model.lp"
    lp.write_text(LP)
    monkeypatch.chdir(tmp_path)
    # manual: the grid's 3,125 combos in one chunk of as many replicas
    extra = ["-p", "thread:3125", "-p", "chunk-size:2"] if mode == "manual" else []
    rc = main(["--device", "cpu", "--quiet", f"--auto:{mode}", "--time-limit",
               "1", "--seed", "5", "-p", "init-population-size:8", *extra,
               str(lp)])
    assert rc == 0
    sols = list(tmp_path.glob("model.lp-*.sol"))
    assert len(sols) == 1
    pb = bt.parse_lp(LP)
    res = bt.make_result(bt.make_context(0), str(sols[0]))
    assert bt.is_valid_solution(pb, res)


# --- checkpoints ---


def test_checkpoint_files_load_across_packages(tmp_path):
    rng = np.random.default_rng(0)
    x = rng.integers(0, 2, (5, 7)).astype(np.int32)
    value = np.arange(5.0, dtype=np.float32)
    rem = np.array([0, 0, 1, 2, 3], np.int32)
    h = np.array([1, 2**31 + 5, 7, 2**32 - 1, 0], np.uint32)

    jpath = str(tmp_path / "jax.npz")
    jckpt.save_population(jpath, JPopulation(
        x=jnp.asarray(x), value=jnp.asarray(value), remaining=jnp.asarray(rem),
        hash=jnp.asarray(h),
    ))
    back = tckpt.load_population(jpath)
    assert back.x.dtype == torch.int32 and back.hash.dtype == torch.int64
    np.testing.assert_array_equal(back.x.numpy(), x)
    np.testing.assert_array_equal(back.value.numpy(), value)
    np.testing.assert_array_equal(back.remaining.numpy(), rem)
    np.testing.assert_array_equal(back.hash.numpy(), h.astype(np.int64))

    tpath = str(tmp_path / "torch.npz")
    tckpt.save_population(tpath, back)
    again = jckpt.load_population(tpath)
    for k, want in (("x", x), ("value", value), ("remaining", rem), ("hash", h)):
        got = np.asarray(getattr(again, k))
        assert got.dtype == want.dtype, k
        np.testing.assert_array_equal(got, want)
    with np.load(tpath) as a, np.load(jpath) as b:
        assert sorted(a.files) == sorted(b.files)


def test_optimize_resumes_from_checkpoint(tmp_path):
    path = str(tmp_path / "pop.npz")
    raw = bt.parse_lp(LP)
    r1 = bt.optimize(make_ctx(bt, checkpoint_path=path, checkpoint_every=0.0),
                     raw, device="cpu")
    assert r1.status == bt.ResultStatus.success and os.path.exists(path)
    ctx2 = make_ctx(bt, checkpoint_path=path, checkpoint_every=1000.0)
    ctx2.log_priority = type(ctx2.log_priority).notice
    said = []
    ctx2.notice = lambda msg, *a: said.append(msg.format(*a))
    r2 = bt.optimize(ctx2, raw, device="cpu")
    assert any("resumed population" in s for s in said)
    assert bt.is_valid_solution(raw, r2)
    assert r2.solutions[-1].value <= r1.solutions[-1].value


def test_optimize_resumes_from_a_jax_mesh_checkpoint(tmp_path):
    path = str(tmp_path / "pop.npz")
    rj = bx.optimize(make_ctx(bx, checkpoint_path=path, checkpoint_every=0.0),
                     bx.parse_lp(LP))
    with np.load(path) as saved:
        assert saved["x"].shape[0] == 8 * 8  # 8 devices x P = 8
    raw = bt.parse_lp(LP)
    ctx = make_ctx(bt, checkpoint_path=path, checkpoint_every=1000.0)
    said = []
    ctx.notice = lambda msg, *a: said.append(msg.format(*a))
    rt = bt.optimize(ctx, raw, device="cpu")
    assert any("resumed population" in s for s in said)
    assert bt.is_valid_solution(raw, rt)
    assert rt.solutions[-1].value <= rj.solutions[-1].value


# --- contracts ---


def test_contracts_catch_a_nonfinite_probe():
    probe = dict(pi_absmax=1.0, P_absmax=2.0, x_min=0, x_max=1, kappa_max=0.2,
                 remaining_min=0, m=10)
    validate_replica_state(probe)
    for key, bad in (("P_absmax", np.inf), ("pi_absmax", np.nan), ("x_max", 2),
                     ("kappa_max", -1.0), ("remaining_min", 11)):
        with pytest.raises(ContractError):
            validate_replica_state(dict(probe, **{key: bad}))


def test_debug_optimize_checks_every_chunk(monkeypatch):
    probes = []
    real = topt.validate_replica_state

    def validate(probe, where):
        probes.append(copy.copy(probe))
        return real(probe, where)

    monkeypatch.setattr(topt, "validate_replica_state", validate)
    raw = bt.parse_lp(LP)
    r = bt.optimize(make_ctx(bt, debug=True, time_limit=0.0, limit=20,
                             chunk_size=5), raw, device="cpu")
    assert r.status == bt.ResultStatus.success and bt.is_valid_solution(raw, r)
    assert len(probes) == 4
    assert probes[-1]["m"] > 0 and np.isfinite(probes[-1]["P_absmax"])
