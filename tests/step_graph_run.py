"""One optimize run whose budget loop is a fixed plan of chunks and
cataclysms, with the state copied to the host after each item: the step
graphs' tests (``test_torch_step_graph.py``) and ``chip_smoke.py`` hold a
run through ``StepGraphs`` against one through ``one_step`` with it.

No JAX here: the card's machine has none."""

from __future__ import annotations

import time

import torch

# 40 steps: two column-sum recomputes (steps 16 and 32), a chunk
# boundary and a cataclysm between chunks
PLAN = (13, 13, "diversify", 14)


def snapshot(state) -> dict:
    """Every tensor of an optimizer state on the host, the step count and
    the random stream's state."""
    from baryonyx_torch.solver import optimize as topt

    names = [*state.replicas._fields, *(f"pop.{k}" for k in state.pop._fields),
             "order_code", "flips"]
    out = {k: t.detach().cpu().clone() for k, t in zip(names, topt._state_tensors(state))}
    out["sweeps"] = state.sweeps
    out["gen_state"] = state.gen.get_state()
    return out


def run_plan(bt, raw, device, graphed: bool, plan=PLAN, seed: int = 7, **params) -> dict:
    """``bt.optimize`` of ``raw`` on ``device`` with its budget loop
    replaced by ``plan`` (a number: a chunk of that many steps; "diversify":
    the cataclysm), with the steps' graphs where ``graphed`` (the rule
    ``step_graphs_apply`` answers ``graphed``). Returns the snapshots after
    each item, each item's seconds (the device synchronized before and
    after), what the real rule answered and the Result."""
    from baryonyx_torch.solver import optimize as topt

    rec = {"snaps": [], "seconds": [], "rule": None, "graphs": None}
    cuda = torch.device(device).type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize(device)

    def loop(ctx, params, state, run_evolve, stats_fn, chunk, *a, diversify_fn=None, **kw):
        for item in plan:
            sync()
            t = time.perf_counter()
            state = diversify_fn(state) if item == "diversify" else run_evolve(state, item)
            sync()
            rec["seconds"].append(time.perf_counter() - t)
            rec["snaps"].append(snapshot(state))
        return state

    def rule(ev, *a):
        rec["rule"] = real_rule(ev, *a)
        return graphed

    real_loop, real_rule = topt._budget_loop, topt.step_graphs_apply
    topt._budget_loop, topt.step_graphs_apply = loop, rule
    try:
        ctx = bt.make_context(0)
        ctx.parameters.seed = seed
        ctx.parameters.time_limit = 1000.0
        for k, v in params.items():
            setattr(ctx.parameters, k, v)
        rec["result"] = bt.optimize(ctx, raw, device=device)
    finally:
        topt._budget_loop, topt.step_graphs_apply = real_loop, real_rule
    return rec


def mismatches(a: dict, b: dict) -> dict:
    """Fields of two runs' snapshots that differ anywhere (tensors bit for
    bit), by item of the plan."""
    out = {}
    for i, (sa, sb) in enumerate(zip(a["snaps"], b["snaps"])):
        bad = [k for k in sa if not _same(sa[k], sb[k])]
        if bad:
            out[i] = bad
    if len(a["snaps"]) != len(b["snaps"]):
        out["items"] = [len(a["snaps"]), len(b["snaps"])]
    return out


def _same(u, v) -> bool:
    if not isinstance(u, torch.Tensor):
        return u == v
    if u.dtype != v.dtype or u.shape != v.shape:
        return False
    if u.is_floating_point():  # the bits: NaN equals NaN, -0.0 not 0.0
        bits = {torch.float32: torch.int32, torch.float64: torch.int64}[u.dtype]
        u, v = u.view(bits), v.view(bits)
    return torch.equal(u, v)
