"""The ``BARYONYX_ABLATE`` hooks of the port's optimize, on the CPU.

The JAX package switches pieces of its evolution step off by the
comma-separated list ``BARYONYX_ABLATE`` (``compact``, ``value``,
``flips``, ``insert``, ``violw``) and warns whenever it is set. The port
reads the list once, when ``optimize_compiled`` starts, into
``EvolveInputs.ablate``.

- Unset, empty, or naming no hook, the variable changes nothing: the
  whole run (every field of the final state, the random stream, the
  Result) is the same bit for bit.
- ``value``, ``flips`` and ``insert`` fix something that both packages
  show whatever their random streams: every member that entered the
  population has the value 0; the flip counter stays 0 (and no annoying
  variable is reported); the population stays the initial one.
- ``violw``: a restarting replica keeps the violated set its sweep
  returned. ``compact``: the fused sweep (its plain version here) gets
  ``n_rows = m`` and make_order's order unpermuted, whose sentinel ``m``
  stands only past index ``m``. (The JAX package decides both inside one
  traced step; the port is held to the JAX source's meaning.)
- ``insert`` still draws the victims: the generator ends where the plain
  step leaves it.
- Both packages warn when the variable is set.

The JAX package reads the variable when it traces, so its runs here clear
JAX's caches before and after (a graph traced earlier in the worker would
hide the ablation).
"""

import jax
import numpy as np
import pytest
import torch

import baryonyx_tpu as bx
from baryonyx_tpu.generators import random_set_cover_lp
from baryonyx_tpu.solver import optimize as jopt

import baryonyx_torch as bt
from baryonyx_torch.ops import psweep as tpw
from baryonyx_torch.solver import common as tcommon
from baryonyx_torch.solver import optimize as topt

LP = random_set_cover_lp(60, 240, 0.05, seed=11)  # the fused sweep's path
SWEEPS = 50  # one chunk (the default chunk_size)
SEED = 7


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def fresh_jax():
    """JAX reads BARYONYX_ABLATE when it traces: no graph of another
    test may stand in for this one's, nor this one's for a later one."""
    jax.clear_caches()
    yield
    jax.clear_caches()


def _set(monkeypatch, value):
    if value is None:
        monkeypatch.delenv("BARYONYX_ABLATE", raising=False)
    else:
        monkeypatch.setenv("BARYONYX_ABLATE", value)


def _ctx(mod, level=0):
    ctx = mod.make_context(level)
    ctx.parameters.seed = SEED
    ctx.parameters.limit = SWEEPS  # no time limit: a fixed sweep budget
    ctx.parameters.thread = 16
    return ctx


def _clone(v):
    if isinstance(v, torch.Tensor):
        return v.clone()
    if isinstance(v, torch.Generator):
        g = torch.Generator(device=v.device)
        g.set_state(v.get_state())
        return g
    if isinstance(v, tuple):
        return type(v)(*[_clone(u) for u in v])
    return v


def _fields(state):
    """Every leaf of an OptState, by name; the generator as its state."""
    out = {}
    for name, v in state._asdict().items():
        if isinstance(v, tuple):
            out.update({f"{name}.{k}": u for k, u in v._asdict().items()})
        elif isinstance(v, torch.Generator):
            out[name] = v.get_state()
        else:
            out[name] = v
    return out


def _assert_same_state(a, b):
    fa, fb = _fields(a), _fields(b)
    assert fa.keys() == fb.keys()
    for k in fa:
        u, v = fa[k], fb[k]
        if isinstance(u, torch.Tensor):
            assert u.dtype == v.dtype and torch.equal(u, v), k
        else:
            assert u == v, k


def _run_port(monkeypatch, ablate, lp=LP, level=0):
    """The port's optimize under BARYONYX_ABLATE=ablate (None: unset):
    the Result, the inputs every step read, and the state before the
    first step and after the last."""
    _set(monkeypatch, ablate)
    seen = {}
    real = topt.evolve

    def evolve(ev, st, k):
        seen.setdefault("ev", ev)
        seen.setdefault("first", _clone(st))
        seen["last"] = real(ev, st, k)
        return seen["last"]

    monkeypatch.setattr(topt, "evolve", evolve)
    r = bt.optimize(_ctx(bt, level), bt.parse_lp(lp), device="cpu")
    monkeypatch.setattr(topt, "evolve", real)
    return r, seen


def _run_jax(monkeypatch, ablate, lp=LP, level=0):
    """The JAX package's optimize under BARYONYX_ABLATE=ablate: the
    Result, its population before the first step and after the last
    (the tests' JAX runs on 8 virtual devices: evolve_sharded)."""
    _set(monkeypatch, ablate)
    seen = {}

    def wrap(real):
        def fn(*a, **kw):
            seen.setdefault("first", a[7])
            seen["last"] = real(*a, **kw)
            return seen["last"]
        return fn

    for name in ("evolve", "evolve_sharded"):
        monkeypatch.setattr(jopt, name, wrap(getattr(jopt, name)))
    r = bx.optimize(_ctx(bx, level), bx.parse_lp(lp))
    return r, seen


def _np_pop(pop):
    return {k: np.asarray(v) for k, v in pop._asdict().items()}


def _entered(first, last):
    """Members of the last population whose x no member of the first
    one has: bool[P]."""
    old = {row.tobytes() for row in first["x"]}
    return np.array([row.tobytes() not in old for row in last["x"]])


@pytest.mark.parametrize("value", ["", "nonsense", " , Compact,values "])
def test_hooks_off_change_nothing(monkeypatch, value):
    r0, s0 = _run_port(monkeypatch, None)
    r1, s1 = _run_port(monkeypatch, value)
    assert s0["ev"].ablate == s1["ev"].ablate == frozenset()
    _assert_same_state(s0["first"], s1["first"])
    _assert_same_state(s0["last"], s1["last"])
    assert r0.loop == r1.loop == SWEEPS
    assert [s.variables for s in r0.solutions] == [s.variables for s in r1.solutions]
    assert [s.value for s in r0.solutions] == [s.value for s in r1.solutions]
    assert r0.annoying_variable == r1.annoying_variable


def test_the_variable_is_read_once_when_optimize_starts(monkeypatch):
    reads = []
    real = topt._ablate

    def counted():
        reads.append(1)
        return real()

    monkeypatch.setattr(topt, "_ablate", counted)
    _, seen = _run_port(monkeypatch, " flips ,violw,, unknown")
    assert seen["ev"].ablate == frozenset({"flips", "violw"})
    assert len(reads) == 1


def test_value_zeroes_what_enters_the_population(monkeypatch, fresh_jax):
    rt, st = _run_port(monkeypatch, "value")
    rj, sj = _run_jax(monkeypatch, "value")
    for first, last in (
        (_np_pop(st["first"].pop), _np_pop(st["last"].pop)),
        (_np_pop(sj["first"].pop), _np_pop(sj["last"].pop)),
    ):
        new = _entered(first, last)
        assert new.any()
        np.testing.assert_array_equal(last["value"][new], 0.0)
        # the costs are positive, so a feasible member worth 0 is a
        # newcomer
        assert ((last["remaining"] == 0) & (last["value"] == 0.0)).any()
    # the Result reports the true objective of the member it returns
    raw = bx.parse_lp(LP)
    assert bx.compute_solution(raw, rt) == pytest.approx(rt.value)
    assert rt.value > 0
    assert rj.status.name == rt.status.name == "success"


def test_flips_leaves_the_counter_at_zero(monkeypatch, fresh_jax):
    rt0, st0 = _run_port(monkeypatch, None)
    assert float(st0["last"].flips.max()) > 0  # the counter counts
    rt, st = _run_port(monkeypatch, "flips")
    rj, sj = _run_jax(monkeypatch, "flips")
    assert not st["last"].flips.any()
    assert not np.asarray(sj["last"].flips).any()
    default = bt.Result().annoying_variable
    assert rt.annoying_variable == rj.annoying_variable == default


def test_insert_keeps_the_initial_population(monkeypatch, fresh_jax):
    rt, st = _run_port(monkeypatch, "insert")
    rj, sj = _run_jax(monkeypatch, "insert")
    for first, last in (
        (_np_pop(st["first"].pop), _np_pop(st["last"].pop)),
        (_np_pop(sj["first"].pop), _np_pop(sj["last"].pop)),
    ):
        for k in first:
            np.testing.assert_array_equal(last[k], first[k], err_msg=k)
    # the port's initial population is the JAX package's, so the Result's
    # solutions are too
    assert rt.value == rj.value
    # without the hook, replicas' finds enter the population
    _, s0 = _run_port(monkeypatch, None)
    assert _entered(_np_pop(s0["first"].pop), _np_pop(s0["last"].pop)).any()


def test_insert_leaves_the_random_stream_where_it_was(monkeypatch):
    _, seen = _run_port(monkeypatch, None)
    ev, state = seen["ev"], seen["first"]
    inserted = 0
    for _ in range(SWEEPS):
        a = topt.one_step(ev, _clone(state))
        b = topt.one_step(ev._replace(ablate=frozenset({"insert"})), _clone(state))
        assert torch.equal(a.gen.get_state(), b.gen.get_state())
        _assert_same_state(b.pop, state.pop)
        inserted += not torch.equal(a.pop.x, state.pop.x)
        state = a
    assert inserted


def test_violw_keeps_the_sweeps_violated_set(monkeypatch):
    _, seen = _run_port(monkeypatch, None)
    ev, state = seen["ev"], _clone(seen["first"])
    swept = {}
    real = tpw.psweep

    def psweep(*a, **kw):
        out = real(*a, **kw)
        swept["viol"] = out[4].clone()
        return out

    monkeypatch.setattr(tpw, "psweep", psweep)
    restarted = 0
    for _ in range(SWEEPS):
        plain = topt.one_step(ev, _clone(state))
        viol_plain = swept["viol"]
        ablated = topt.one_step(ev._replace(ablate=frozenset({"violw"})), state)
        assert torch.equal(swept["viol"], viol_plain)
        r = ablated.replicas.restarts > state.replicas.restarts  # [R]
        restarted += int(r.sum())
        # restarting replicas: the sweep's set, not one recomputed from
        # the new x (which the plain step takes); the others: the sweep's
        assert torch.equal(ablated.replicas.viol, swept["viol"])
        want = topt.violated_mask(ev.cp, plain.replicas.x)
        assert torch.equal(plain.replicas.viol[:, r], want[:, r])
        assert torch.equal(plain.replicas.viol[:, ~r], swept["viol"][:, ~r])
        state = ablated
    assert restarted > 0


def test_compact_walks_every_row_block_unpermuted(monkeypatch):
    _set(monkeypatch, "compact")
    orders, calls = [], []
    real_order, real_sweep = tcommon.make_order, tpw.psweep

    def make_order(*a, **kw):
        orders.append(real_order(*a, **kw))
        return orders[-1]

    def psweep(*a, **kw):
        calls.append((a[6].clone(), kw["n_rows"]))
        return real_sweep(*a, **kw)

    monkeypatch.setattr(tcommon, "make_order", make_order)
    monkeypatch.setattr(tpw, "psweep", psweep)
    r, seen = _run_port(monkeypatch, "compact")
    cp = seen["ev"].cp
    assert r.status == bt.ResultStatus.success and r.loop == SWEEPS
    assert len(calls) == len(orders) == SWEEPS
    for order, (got, n_rows) in zip(orders, calls):
        assert n_rows == cp.m
        assert torch.equal(got, order)
        assert sorted(order[: cp.m].tolist()) == list(range(cp.m))
        assert (order[cp.m:] == cp.m).all()
    # the plain step compacts: the scheduled rows only (every row while a
    # replica pushes)
    calls.clear()
    _run_port(monkeypatch, None)
    assert min(int(n) for _, n in calls) < cp.m


def test_both_packages_warn_when_the_variable_is_set(monkeypatch, capsys,
                                                     fresh_jax):
    for run in (_run_port, _run_jax):
        run(monkeypatch, "value,insert", level=4)
        out = capsys.readouterr().out
        assert "BARYONYX_ABLATE=value,insert is set" in out
        assert "ablation studies only" in out
        run(monkeypatch, None, level=4)
        assert "BARYONYX_ABLATE" not in capsys.readouterr().out
