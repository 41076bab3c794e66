"""The port's spans and counts (``baryonyx_torch.spans``), on the CPU.

- Nesting: a span's parent is the span open around it, its self time its
  duration less its recorded children's; ``end`` closes the innermost
  span by name; a loop span records only under a profiler, and a new
  profiler session clears the traced totals.
- With no profiler running, a whole ``optimize`` and ``solve`` record no
  loop span or count and never enter ``record_function``; their set-up
  spans are recorded after one call.
- Under ``torch.profiler.profile`` the loop spans show among the
  profiler's events, the chunks' steps add up to the sweeps optimize ran,
  and solve's sweep and read spans count its sweeps.
- Two gloo ranks: ``parallel.bytes`` equals the bytes worked out from the
  shapes of the collectives that ``optimize`` makes (``spawn_ranks.py``).
"""

import io

import pytest
import torch

import baryonyx_torch as bt
from baryonyx_torch import spans
from baryonyx_torch.generators import random_set_cover_lp
from baryonyx_torch.solver import optimize as bopt
from spawn_ranks import spawn

COVER_LP = random_set_cover_lp(40, 160, 0.08, seed=7)
SWEEPS, CHUNK = 40, 10  # optimize's sweep budget and its fixed chunk
# under a profiler in this process: few sweeps, since reading the
# profiler's events takes about 60 us per event (8,000 per sweep here)
TRACED_SWEEPS, TRACED_CHUNK = 8, 2
SETUP = {"entry.parse", "entry.solver_init", "entry.preprocess", "entry.merge",
         "entry.compile", "entry.population"}
LOOP = {"optimize.chunk", "optimize.enqueue", "optimize.fetch", "optimize.fleet",
        "optimize.exchange", "solve.sweep", "solve.read", "parallel.bytes"}
TIMEOUT_S = 90.0


@pytest.fixture(autouse=True)
def fresh_spans():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    spans.reset()
    yield
    spans.reset()
    torch.set_num_threads(n)


def _profile():
    return torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU])


def _optimize(sweeps=SWEEPS, chunk=CHUNK, **params):
    ctx = bt.make_context(0)
    raw = bt.make_problem(ctx, io.StringIO(COVER_LP))
    p = ctx.parameters
    p.seed, p.limit, p.chunk_size, p.time_limit = 3, sweeps, chunk, 0
    for k, v in params.items():
        setattr(p, k, v)
    return bt.optimize(ctx, raw, device="cpu")


def _solve():
    ctx = bt.make_context(0)
    raw = bt.make_problem(ctx, io.StringIO(COVER_LP))
    ctx.parameters.seed, ctx.parameters.pushes_limit = 3, 2
    return bt.solve(ctx, raw, device="cpu")


def test_nesting_self_time_and_end():
    with spans.span("outer"):
        with spans.span("inner"):
            sum(range(20000))
        with spans.span("inner"):
            pass
        with spans.span("to_end"):
            spans.end("outer")  # not the innermost: nothing happens
            spans.end("to_end")
            sum(range(20000))  # after the end: not in the span
    rest = spans.snapshot()["rest"]
    outer, inner, ended = rest["outer"], rest["inner"], rest["to_end"]
    assert outer["calls"] == 1 and inner["calls"] == 2 and ended["calls"] == 1
    assert inner["self_s"] == inner["total_s"] > inner["first_s"] > 0
    assert outer["self_s"] == pytest.approx(
        outer["total_s"] - inner["total_s"] - ended["total_s"], abs=1e-9)
    assert outer["self_s"] > 0
    assert spans.snapshot()["traced"] == {}


def test_loop_spans_and_counts_only_under_a_profiler():
    with spans.loop("a", 3):
        spans.add("b", 5)
    assert spans.snapshot()["traced"] == {} and spans.snapshot()["rest"] == {}
    with _profile() as prof:
        with spans.span("setup"):
            with spans.loop("a", 3):
                spans.add("b", 5)
    snap = spans.snapshot()
    assert snap["traced"]["a"]["n"] == 3 and snap["traced"]["a"]["calls"] == 1
    assert snap["traced"]["b"] == {"calls": 1, "total_s": 0.0, "self_s": 0.0, "n": 5,
                                   "first_s": 0.0}
    assert snap["traced"]["setup"]["self_s"] < snap["traced"]["setup"]["total_s"]
    assert {"a", "setup"} <= {e.name for e in prof.events()}
    with spans.loop("a"):  # seen with no profiler running
        pass
    prof = _profile()
    with spans.loop("started_inside"):
        prof.start()
    spans.add("b", 2)
    with spans.loop("whole"):
        pass
    with spans.loop("stopped_inside"):
        prof.stop()
    traced = spans.snapshot()["traced"]
    assert set(traced) == {"b", "whole"}  # a session cleared the last one's
    assert traced["b"] == {"calls": 1, "total_s": 0.0, "self_s": 0.0, "n": 2, "first_s": 0.0}


def test_off_no_loop_span_and_no_record_function(monkeypatch):
    entered = []
    real = torch.profiler.record_function

    def counting(*a, **kw):
        entered.append(a)
        return real(*a, **kw)

    monkeypatch.setattr(torch.profiler, "record_function", counting)
    res = _optimize()
    assert res.loop == SWEEPS
    snap = spans.snapshot()
    assert snap["traced"] == {} and not LOOP & set(snap["rest"])
    assert SETUP | {"entry.replicas", "entry.greedy_cover", "entry.replica_starts"} == set(
        snap["rest"])
    spans.reset()
    res = _solve()
    assert res.sweeps > 0
    snap = spans.snapshot()
    assert snap["traced"] == {} and set(snap["rest"]) == SETUP
    assert entered == []
    # the set-up spans nest under the entry's
    init = snap["rest"]["entry.solver_init"]
    children = sum(snap["rest"][k]["total_s"] for k in SETUP - {"entry.parse", "entry.solver_init"})
    assert init["self_s"] == pytest.approx(init["total_s"] - children, abs=1e-9)
    assert snap["launches"] == {"psweep": 0, "dpselect": 0}


def test_optimize_under_a_profiler():
    with _profile() as prof:
        res = _optimize(TRACED_SWEEPS, TRACED_CHUNK)
    traced = spans.snapshot()["traced"]
    assert traced["optimize.chunk"]["n"] == res.loop == TRACED_SWEEPS
    assert traced["optimize.chunk"]["calls"] == TRACED_SWEEPS // TRACED_CHUNK
    for name in ("optimize.enqueue", "optimize.fetch"):
        assert traced[name]["calls"] == TRACED_SWEEPS // TRACED_CHUNK
    chunk = traced["optimize.chunk"]
    children = traced["optimize.enqueue"]["total_s"] + traced["optimize.fetch"]["total_s"]
    assert chunk["self_s"] == pytest.approx(chunk["total_s"] - children, abs=1e-9)
    assert not {"optimize.fleet", "optimize.exchange", "parallel.bytes"} & set(traced)
    names = {e.name for e in prof.events()}
    assert {"optimize.chunk", "optimize.enqueue", "optimize.fetch", "entry.compile"} <= names


def test_solve_under_a_profiler():
    with _profile() as prof:
        res = _solve()
    traced = spans.snapshot()["traced"]
    assert traced["solve.sweep"]["calls"] == res.sweeps
    # one read per sweep but the push rounds' first, amplified, sweeps
    assert 0 < traced["solve.read"]["calls"] < res.sweeps
    assert {"solve.sweep", "solve.read"} <= {e.name for e in prof.events()}


def _two_rank_optimize():
    """Optimize under a profiler on this rank; its traced totals, and the
    width of the compiled problem (the population's rows)."""
    widths = []
    real = bopt.compile_problem

    def compile_problem(*a, **kw):
        cp = real(*a, **kw)
        widths.append(cp.n)
        return cp

    bopt.compile_problem = compile_problem
    torch.set_num_threads(1)
    with _profile():
        res = _optimize(init_population_size=24)
    return spans.snapshot()["traced"], widths[0], res.loop


def test_two_rank_collective_bytes():
    out = spawn(_two_rank_optimize, 2, device="cpu", timeout_s=TIMEOUT_S)
    for traced, n, loop in out:
        assert loop == SWEEPS
        chunks = SWEEPS // CHUNK
        P, K = 24, min(bopt.EXCHANGE_K, 24)
        per_chunk = (
            4 * n  # the flip counts' all-reduce, float32 [n]
            + K * (4 * n + 4 + 4)  # the exchange: x int32, value float32, remaining int32
            + 7 * 8  # the host loop's stats and decisions, float64 [1, 7]
        )
        final = P * (4 * n + 4 + 4 + 8)  # the populations gathered at the end (hash int64)
        assert traced["parallel.bytes"]["n"] == chunks * per_chunk + final
        assert traced["parallel.bytes"]["calls"] == chunks * 5 + 4
        assert traced["optimize.fleet"]["calls"] == chunks
        assert traced["optimize.exchange"]["calls"] == chunks
        assert traced["optimize.chunk"]["n"] == SWEEPS
