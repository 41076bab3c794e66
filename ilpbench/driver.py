"""One run of one cell against the program, on one rank: the instance from
the seed, the program's public entry (``make_context``, ``register``,
``make_problem``, then ``optimize`` or ``solve``), the window on the
host's clock, the benchmark's own spans, the probes that keep one sweep's
state (and, across ranks, its population exchanges) from the window, the
profiler over whole chunks when traced, and then the reference's checks.

Returns a plain record that the metric readers (``metrics/``) read."""

from __future__ import annotations

import functools
import importlib.util
import io
import time
from pathlib import Path
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from ilpbench import host
from ilpbench import trace as tracing
from ilpbench.reference import check, tables
from ilpbench.reference.instance import Instance, permuted
from ilpbench.reference.sweep_fused import fused_sweep
from ilpbench.reference.sweep_general import general_sweep
from ilpbench.reference.sweep_z import z_sweep
from ilpbench.roofline import dpselect_bound, psweep_bound


HERE = Path(__file__).resolve().parent


def make_instance(config: dict, seed: int, here: Path = HERE) -> Instance:
    """The configuration's instance (``generators/<generator>.py``), its
    rows and columns in the order ``seed`` draws."""
    path = here / "generators" / f"{config['generator']}.py"
    spec = importlib.util.spec_from_file_location(f"ilpbench_gen_{config['generator']}", path)
    gen = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(gen)
    base = gen.generate(config["instance_seed"], **config["args"])
    return permuted(base, seed)


def _cpu(v):
    return v.detach().to("cpu", copy=True) if isinstance(v, torch.Tensor) else v


LAYOUT = ("row_vars", "row_factor", "r_size", "bmin", "bmax", "is_eq", "neg_count")


class SweepProbe:
    """Wraps the program's sweep dispatchers (``targets``: (module, attr)
    pairs; the instance decides which of them the program calls): once
    ``armed``, keeps the inputs and outputs of the first call that
    schedules a row and, unless it is the Z sweep (``z_sweep``, which
    keeps no column sums across sweeps), carries its column sums
    (``S_fresh``), copied to the host before and after the call (the Z
    sweep updates P and pi in place), with the generator's state for a
    sweep that draws from one. While ``recording`` (the traced chunks or
    sweeps), holds on to the schedule, order and row count of every fused
    sweep (the program makes them anew for each sweep and does not change
    them afterwards), for the bound of each traced sweep, and wraps the
    knapsack DP (``zs.dp_select``) to hold each call's row list, replica
    count and score size, for kernel B's bound. Counts calls."""

    def __init__(self, *targets):
        self.targets = [(module, attr, getattr(module, attr)) for module, attr in targets]
        self.armed = False
        self.kept: Optional[dict] = None
        self.calls = 0
        self.t_first: Optional[float] = None
        self.on_call: Optional[Callable[[int], None]] = None
        self._recording = False
        self.traced: List[dict] = []
        self.dp_calls: List[tuple] = []

    @property
    def recording(self) -> bool:
        return self._recording

    @recording.setter
    def recording(self, on: bool):
        from baryonyx_torch.ops import zsweep as zs

        if on and not self._recording:
            real = zs.dp_select

            def dp_select(cp, rows_c, r, *a, **kw):
                self.dp_calls.append((rows_c, r.shape[-1], r.element_size()))
                return real(cp, rows_c, r, *a, **kw)

            self._dp_real, zs.dp_select = real, dp_select
        elif not on and self._recording:
            zs.dp_select = self._dp_real
        self._recording = on

    def _call(self, kind: str, real, *a, **kw):
        if self.t_first is None:
            self.t_first = time.monotonic()
        self.calls += 1
        if self.on_call is not None:
            self.on_call(self.calls)
        z = kind == "z_sweep"
        if self.recording and kind == "psweep":
            self.traced.append({"sched": a[5], "order": a[6], "n_rows": kw.get("n_rows")})
        if not (self.armed and self.kept is None and (z or kw.get("S_fresh"))
                and bool(a[5].any())):
            return real(*a, **kw)
        gen = a[10]
        state = {
            "kind": kind,
            "args": [_cpu(v) for v in a[1:10]] + [None, _cpu(a[11])],
            "kw": {k: _cpu(v) for k, v in kw.items()},
            "gen_state": gen.get_state() if isinstance(gen, torch.Generator) else _cpu(gen),
        }
        cp = a[0]
        state["cp"] = {k: _cpu(getattr(cp, k)) for k in LAYOUT + (tables.Z_KEYS if z else ())}
        state["cp"].update(m=cp.m, n=cp.n, Kr=cp.Kr, m_real=cp.m_real, J_bot=cp.J_bot,
                           J_top=cp.J_top, has_quad=cp.has_quad, has_z=cp.has_z, Wdp=cp.Wdp,
                           z_needs_walk=cp.z_needs_walk)
        out = real(*a, **kw)
        state["out"] = [_cpu(v) for v in out[:4]]
        self.kept = state
        return out

    def __enter__(self):
        for module, attr, real in self.targets:
            setattr(module, attr, functools.partial(self._call, attr, real))
        return self

    def __exit__(self, *exc):
        self.recording = False
        for module, attr, real in self.targets:
            setattr(module, attr, real)


class ExchangeProbe:
    """Wraps the population exchange between ranks: while armed, keeps
    each exchange's population before and after it (up to ``keep``),
    with the rank's stream seed and step count."""

    def __init__(self, module, keep: int = 64):
        self.module = module
        self.real = module.exchange_top_k
        self.armed = False
        self.keep = keep
        self.kept: List[dict] = []

    def __call__(self, ev, state):
        out = self.real(ev, state)
        if self.armed and len(self.kept) < self.keep:
            self.kept.append({
                "before": {"x": _cpu(state.pop.x), "remaining": _cpu(state.pop.remaining),
                           "initial_seed": state.gen.initial_seed(),
                           "sweeps": int(state.sweeps)},
                "after": {"x": _cpu(out.x), "remaining": _cpu(out.remaining)},
            })
        return out

    def __enter__(self):
        self.module.exchange_top_k = self
        return self

    def __exit__(self, *exc):
        self.module.exchange_top_k = self.real


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _context(bt, params: dict, seed: int, update=None):
    ctx = bt.make_context(0)
    for k, v in params.items():
        setattr(ctx.parameters, k, v)
    ctx.parameters.seed = seed
    if update is not None:
        ctx.register(update=update)
    return ctx


def run_optimize(bt, raw, traffic: dict, seed: int, seconds: float, trace: bool,
                 device, world: int, rec: dict) -> dict:
    """optimize for warm-up, the window and a margin; the window opens at
    the first progress callback at or past ``warmup_sweeps`` (a count
    every rank shares) and closes at the first callback ``seconds`` later
    on this rank's clock. Traced: the profiler covers ``traced_chunks``
    whole chunks, starting one chunk after the window opens (the chunk in
    which the sweep probe copies its state). On one rank the window's
    close ends the run (the program's interrupt returns the best
    population); over a group every rank runs to the time budget, which
    covers warm-up, the window and a margin."""
    from baryonyx_torch.ops import psweep as pw
    from baryonyx_torch.ops import zsweep as zs
    from baryonyx_torch.solver import optimize as opt

    warm = traffic["warmup_sweeps"]
    calls: List[tuple] = []  # (host time, sweeps, elapsed, process CPU time)
    marks: Dict[str, int] = {}
    prof = tracing.Profiler() if trace else None
    probe = SweepProbe((pw, "psweep"), (zs, "z_sweep"))
    xprobe = ExchangeProbe(opt)

    def on_update(remaining, value, loop, elapsed, restarts):
        now = time.monotonic()
        calls.append((now, loop, elapsed, time.process_time()))
        i = len(calls) - 1
        if "open" not in marks and loop >= warm:
            marks["open"] = i
            probe.armed = xprobe.armed = True
        elif ("open" in marks and "close" not in marks and now - calls[marks["open"]][0] >= seconds
              and (prof is None or "trace_stop" in marks)):
            marks["close"] = i
            xprobe.armed = False
            if world == 1:
                if prof is not None and prof.running:
                    prof.stop()
                raise KeyboardInterrupt
        if prof is not None and "open" in marks:
            if i == marks["open"] + 1:
                prof.start()
                probe.recording = True
                marks["trace_start"] = i
            elif i == marks["open"] + 1 + traffic["traced_chunks"] and prof.running:
                prof.stop()
                probe.recording = False
                marks["trace_stop"] = i

    ctx = _context(bt, traffic["params"], seed + 1, on_update)
    ctx.parameters.time_limit = traffic["warmup_budget_s"] + seconds + 3.0
    t_call = time.monotonic()
    with probe, xprobe:
        result = bt.optimize(ctx, raw, device=device)
    _sync(device)
    if prof is not None and prof.running:
        prof.stop()
    probe.recording = False
    if "close" not in marks:
        raise RuntimeError(f"optimize: the window never closed ({len(calls)} chunks)")
    t0, s0, _, c0 = calls[marks["open"]]
    t1, s1, _, c1 = calls[marks["close"]]
    rec.update(
        t_open=t0, window_s=t1 - t0, window_cpu_s=c1 - c0, sweeps=s1 - s0,
        replicas=result.replicas,
        attempted=1, result=result,
        solver_setup_s=(calls[0][0] - calls[0][2]) - t_call,
        sweep_state=probe.kept, exchange=xprobe.kept, traced_states=probe.traced,
        dp_calls=probe.dp_calls,
    )
    if prof is not None:
        a, b = marks["trace_start"], marks["trace_stop"]
        rec["trace"] = prof.summary(
            window_s=calls[b][0] - calls[a][0] - prof.start_cost_s,
            steps=calls[b][1] - calls[a][1],
        )
    return rec


def run_solve(bt, raw, traffic: dict, seed: int, seconds: float, trace: bool,
              device, world: int, rec: dict) -> dict:
    """One short solve to warm up, then whole solves back to back, with
    solver seeds seed + 1, seed + 2, ..., until ``seconds`` have passed.
    The sweep probe keeps one sweep of the first timed solve at or past
    its ``probe_sweep``-th sweep; traced, the profiler covers the
    ``traced_sweeps`` sweeps after it."""
    from baryonyx_torch.ops import zsweep as zs
    from baryonyx_torch.solver import solve as sv

    ctx = _context(bt, {**traffic["params"], **traffic["warmup_params"]}, seed + 1)
    bt.solve(ctx, raw, device=device)
    probe = SweepProbe((sv, "sweep"), (zs, "z_sweep"))
    prof = tracing.Profiler() if trace else None
    first, span = traffic["probe_sweep"], traffic.get("traced_sweeps", 0)
    marks: Dict[str, float] = {}

    def on_call(i: int):
        if not probe.armed and i >= first:
            probe.armed = True
        if prof is None:
            return
        if i == first + 2:
            _sync(device)
            prof.start()
            probe.recording = True
            marks["a"], marks["ia"] = time.monotonic(), i
        elif i == first + 2 + span and prof.running:
            _sync(device)
            marks["b"], marks["ib"] = time.monotonic(), i
            prof.stop()
            probe.recording = False

    probe.on_call = on_call
    results = []
    t_open, c_open = time.monotonic(), time.process_time()
    with probe:
        k = 0
        while (not results or time.monotonic() - t_open < seconds
               or (prof is not None and "b" not in marks)):
            ctx = _context(bt, traffic["params"], seed + 1 + k)
            if k == 0:
                t_call = time.monotonic()
            results.append(bt.solve(ctx, raw, device=device))
            if k == 0:
                rec["solver_setup_s"] = probe.t_first - t_call
            k += 1
    t_close, c_close = time.monotonic(), time.process_time()
    if prof is not None and prof.running:
        prof.stop()
    rec.update(
        t_open=t_open, window_s=t_close - t_open, window_cpu_s=c_close - c_open,
        sweeps=sum(r.sweeps for r in results), replicas=1, attempted=len(results),
        result=results, sweep_state=probe.kept, exchange=None, dp_calls=probe.dp_calls,
    )
    if prof is not None:
        rec["trace"] = prof.summary(
            window_s=marks["b"] - marks["a"],
            steps=int(marks["ib"] - marks["ia"]),
        )
    return rec


def run_rank(config: dict, traffic: dict, seed: int, seconds: float, trace: bool,
             device, t_start: float, world: int = 1, here: Path = HERE,
             control=None) -> dict:
    """This rank's part of a run: the window, the peak memory, then the
    checks that need this rank's device (its kept sweep). ``control``: a
    float type in which the reference also works the kept sweep out, in
    the program's place (``control.py``)."""
    import baryonyx_torch as bt

    rec: Dict[str, object] = {}
    inst = make_instance(config, seed, here)
    ctx = bt.make_context(0)
    t = time.monotonic()
    raw = bt.make_problem(ctx, io.StringIO(inst.lp))
    rec["parse_s"] = time.monotonic() - t
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    run = {"optimize": run_optimize, "solve": run_solve}[traffic["mode"]]
    run(bt, raw, traffic, seed, seconds, trace, device, world, rec)
    rec["setup_s"] = rec["t_open"] - t_start
    rec["host"] = dict(host.report(), window_cpu_s=rec.pop("window_cpu_s"))
    rec["memory_peak_bytes"] = (
        torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    )
    results = rec.pop("result")
    results = results if isinstance(results, list) else [results]
    del raw
    if device.type == "cuda":
        torch.cuda.empty_cache()
    rec.update(judge(inst, results, rec.pop("sweep_state"), device, control,
                     rec.pop("traced_states", None), rec.pop("dp_calls")))
    return rec


def judge(inst: Instance, results: list, kept: Optional[dict], device, control=None,
          traced: Optional[List[dict]] = None, dp_calls: Optional[List[tuple]] = None) -> dict:
    """The reference's readings of this rank's answers and kept sweep:
    rows the answers leave unsatisfied, the objective each reports against
    the one worked out again, the program's tables against the
    instance's, and the kept sweep worked out again. With the traced
    sweeps' states (optimize, on a card with published peaks): the sum of
    their least times (``bound``); with the traced DP calls (a Z instance,
    on such a card): the sum of theirs (``dp_bound``)."""
    out = {"failed": 0, "infeasible_rows": 0, "objective_err": 0.0, "objectives": []}
    for res in results:
        if not res.solutions or res.remaining_constraints != 0:
            out["failed"] += 1
            continue
        x, missing = check.solution_vector(inst, res.solution_map())
        out["infeasible_rows"] += check.violated_rows(inst, x) + missing
        value = check.objective(inst, x)
        out["objective_err"] = max(out["objective_err"], abs(value - float(res.value)))
        out["objectives"].append(value)
    names = results[0].variable_name if results else None
    out["n_vars"] = len(names or [])
    if kept is None or not names:
        out["table_mismatch"] = out["sweep_mismatch"] = None
        return out
    cp = {k: (v.numpy() if isinstance(v, torch.Tensor) else v) for k, v in kept["cp"].items()}
    ref, bad = tables.reference_tables(
        inst, names, cp["row_vars"], cp["r_size"].astype(np.int64), cp["m_real"], cp["n"],
    )
    program = dict(cp, cost=kept["args"][3].numpy())
    out["table_mismatch"] = bad + tables.held_against(ref, program, cp["m_real"])
    out["sweep_mismatch"] = sweep_mismatch(ref, kept, device)
    if control is not None:
        out["control_sweep_mismatch"] = sweep_mismatch(ref, kept, device, control)
    if device.type == "cuda":
        kind = torch.cuda.get_device_name(device)
        if traced:
            out["bound"] = traced_bound(ref, cp, traced, kind)
        if dp_calls and ref.get("Wdp"):
            out["dp_bound"] = dp_bound(ref, dp_calls, kind)
    return out


def traced_bound(ref: dict, cp: dict, traced: List[dict], kind: str) -> Optional[dict]:
    """The least times of the traced sweeps, summed: {"ms", "sweeps"}."""
    total = 0.0
    for st in traced:
        b = psweep_bound(ref, cp, st, kind)
        if b is None:
            return None
        total += b["ms"]
    return {"ms": total, "sweeps": len(traced)}


def dp_bound(ref: dict, calls: List[tuple], kind: str) -> Optional[dict]:
    """The least times of the traced DP calls, summed: {"ms", "calls"}."""
    total = 0.0
    rows = torch.stack([c[0] for c in calls]).cpu()  # one copy from the device
    for r, (_, R, itemsize) in zip(rows, calls):
        b = dpselect_bound(ref, r, R, itemsize, kind)
        if b is None:
            return None
        total += b["ms"]
    return {"ms": total, "calls": len(calls)}


def sweep_state(kept: dict) -> dict:
    """The kept sweep's inputs by name."""
    x, P, pi, cost, sched, order, kappa, delta, theta, _, amp = kept["args"]
    kw = kept["kw"]
    return dict(
        x=x, P=P, pi=pi, S=kw.get("S"), sched=sched, order=order, n_rows=kw.get("n_rows"),
        kappa=kappa, amp=amp, delta=delta, theta=theta, minimize=kw.get("minimize", True),
        block_size=kw.get("block_size", 8),
        **({"seed": [int(v) for v in kept["gen_state"]]} if kept["kind"] == "psweep"
           else {"gen_state": kept["gen_state"]}),
    )


def sweep_mismatch(ref: dict, kept: dict, device, dtype=torch.float32):
    """Entries of the kept sweep's outputs (x, P, pi and S, or the Z
    sweep's violated rows) that differ from the reference's sweep of the
    same kind from the same inputs in ``dtype``."""
    st = sweep_state(kept)
    t = tables.on_device(ref, dtype, device)
    st = {k: (v.to(device) if isinstance(v, torch.Tensor) and k != "gen_state" else v)
          for k, v in st.items()}
    fn = {"psweep": fused_sweep, "sweep": general_sweep, "z_sweep": z_sweep}[kept["kind"]]
    got = fn(t, st, dtype)
    return sum(tables.mismatches(a, b) for a, b in zip(got, kept["out"]))
