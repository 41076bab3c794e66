"""Meta-optimizers: manual grid, Nelder-Mead, recursive branch.

reference: lib/src/manual-optimizer.cpp (5-dim odometer grid),
lib/src/nlopt-optimizer.cpp (Nelder-Mead over the same 5 parameters),
lib/src/branch-optimizer.cpp (best-first recursive splitting).

All three tune/partition around repeated calls to the batched optimizer
(solver/optimize.py), on one device (CUDA unless ``device="cpu"``). The
tuned dimensions are (theta, delta, kappa_min, kappa_step,
init_policy_random), with the Nelder-Mead bounds of the reference
(nlopt-optimizer.cpp:101-103).
"""

from __future__ import annotations

import copy
import itertools
import time
from typing import List, Tuple

import numpy as np

from baryonyx_torch.core.context import Context
from baryonyx_torch.core.errors import BaryonyxError
from baryonyx_torch.core.model import ObjectiveType, Problem, RawProblem
from baryonyx_torch.core.params import ModeType, PreprocessorOptions
from baryonyx_torch.core.result import Result, ResultStatus
from baryonyx_torch.device import DeviceLike, resolve_device
from baryonyx_torch.parallel.distributed import from_rank0, world_size
from baryonyx_torch.preprocess.fixing import preprocess, split, unpreprocess
from baryonyx_torch.solver import optimize as opt

_PARAM_NAMES = ("theta", "delta", "kappa_min", "kappa_step", "init_policy_random")
_LOW = np.array([0.0, 0.0001, 0.0, 1e-7, 0.0])
_UP = np.array([1.0, 0.1, 0.5, 0.01, 1.0])


def _prepare(ctx: Context, raw: RawProblem) -> Problem:
    # unlike api._prepare, linearized products are not folded here
    if ctx.parameters.preprocessor == PreprocessorOptions.all:
        return preprocess(ctx, raw)
    return unpreprocess(ctx, raw)


def _internal(ctx: Context) -> Context:
    """A copy of ``ctx`` with its own parameters and no meta mode."""
    internal = copy.copy(ctx)
    internal.parameters = copy.copy(ctx.parameters)
    internal.parameters.mode = ModeType.none
    return internal


def _run_with(ctx: Context, pb: Problem, values, device: DeviceLike = None) -> Result:
    internal = _internal(ctx)
    for name, v in zip(_PARAM_NAMES, values):
        setattr(internal.parameters, name, float(v))
    return opt.optimize_compiled(internal, pb, device=device)


def _score(res: Result, minimize: bool) -> float:
    """Objective of the run, +inf when no solution — the scalar the tuners
    minimize (sign-flipped for maximize problems)."""
    if res.status != ResultStatus.success or not res.solutions:
        return float("inf")
    v = res.solutions[-1].value
    return v if minimize else -v


def manual_optimize(
    ctx: Context, raw: RawProblem, grid_len: int = 5, device: DeviceLike = None
) -> Result:
    """grid_len^5 odometer grid, evaluated as a batch axis on the device:
    grid combos tile cyclically onto the replicas (per-replica
    theta/delta/kappa-schedule/init-policy — optimize_compiled's
    hp_vectors), so one optimize run scores up to R combos at once and
    the whole 5^5 grid costs ceil(C/R) runs instead of 3125 sequential
    optimizes. Per-combo score = best feasible value among its replicas;
    the winner is re-run with the full budget.

    reference: manual-optimizer.cpp:31-174 — the reference runs a full
    multi-threaded optimize per combo (its axis-fill loops also reuse the
    theta array by copy-paste, a bug not replicated)."""
    dev = resolve_device(device)
    pb = _prepare(ctx, raw)
    p = ctx.parameters
    L = grid_len

    def axis(start, span):
        start = max(start, 0.0)
        return [start + i * span / L for i in range(L)]

    axes = [
        axis(p.theta, 1.0),
        axis(p.delta if p.delta > 0 else 0.001, 0.1),
        axis(p.kappa_min, 1e-2),
        axis(p.kappa_step, 1e-3),
        axis(p.init_policy_random, 0.9),
    ]
    combos = np.array(list(itertools.product(*axes)))  # [C, 5]
    C = len(combos)
    # the replica count optimize_compiled will run, over every rank
    R = opt.default_replicas(p, dev, world_size())
    n_chunks = max(1, -(-C // R))
    budget = p.time_limit if p.time_limit > 0 else 10.0

    internal = _internal(ctx)
    internal.parameters.time_limit = max(budget / n_chunks, 1.0)

    scores = np.full(C, np.inf)
    for ci in range(n_chunks):
        chunk = combos[ci * R : (ci + 1) * R]
        hp_vectors = {
            name: chunk[:, j] for j, name in enumerate(_PARAM_NAMES)
        }
        res = opt.optimize_compiled(
            internal, pb, device=dev, hp_vectors=hp_vectors
        )
        rb = res.replica_best_values
        if rb is None:
            continue
        Cc = len(chunk)
        for r, v in enumerate(rb):
            c = ci * R + (r % Cc)
            if v < scores[c]:
                scores[c] = v
        ctx.notice(
            "  - manual sweep chunk {}/{}: best so far {}\n",
            ci + 1, n_chunks, float(np.min(scores)),
        )

    best_values = combos[int(np.argmin(scores))]
    ctx.notice(
        "  - manual sweep best params: {}\n",
        [round(float(v), 6) for v in best_values],
    )
    return _run_with(ctx, pb, best_values, dev)


NM_BUDGET_EVALS = 40


def nelder_mead_optimize(
    ctx: Context, raw: RawProblem, device: DeviceLike = None
) -> Result:
    """Derivative-free Nelder-Mead over the 5 parameters with the
    reference's bounds (reference: nlopt-optimizer.cpp:34-168). A
    self-contained simplex implementation stands in for NLopt;
    evaluations are full batched-optimizer runs."""
    dev = resolve_device(device)
    pb = _prepare(ctx, raw)
    minimize = pb.type == ObjectiveType.minimize
    p = ctx.parameters

    x0 = np.array(
        [
            p.theta,
            p.delta if p.delta > 0 else 0.001,
            p.kappa_min,
            p.kappa_step,
            p.init_policy_random,
        ]
    )
    x0 = np.clip(x0, _LOW, _UP)

    budget_evals = NM_BUDGET_EVALS
    evals = [0]

    # Each evaluation gets a slice of the caller's wall budget (plus one
    # slice reserved for the final best-params rerun) instead of the full
    # budget per eval — the reference runs a full optimize per NLopt
    # evaluation under a separate 1 h cap (nlopt-optimizer.cpp:106-110),
    # which multiplies the user's limit by the evaluation count.
    total = p.time_limit if p.time_limit > 0 else 10.0
    eval_ctx = copy.copy(ctx)
    eval_ctx.parameters = copy.copy(ctx.parameters)
    eval_ctx.parameters.time_limit = max(total / (budget_evals + 1), 0.5)

    def f(x) -> float:
        x = np.clip(x, _LOW, _UP)
        evals[0] += 1
        return _score(_run_with(eval_ctx, pb, x, dev), minimize)

    # simplex init: x0 plus per-dimension nudges
    simplex = [x0]
    for i in range(5):
        xi = x0.copy()
        step = 0.1 * (_UP[i] - _LOW[i])
        xi[i] = xi[i] + step if xi[i] + step <= _UP[i] else xi[i] - step
        simplex.append(xi)
    fvals = [f(x) for x in simplex]

    alpha, gamma, rho, sigma = 1.0, 2.0, 0.5, 0.5
    while evals[0] < budget_evals:
        idx = np.argsort(fvals)
        simplex = [simplex[i] for i in idx]
        fvals = [fvals[i] for i in idx]
        centroid = np.mean(simplex[:-1], axis=0)

        xr = centroid + alpha * (centroid - simplex[-1])
        fr = f(xr)
        if fr < fvals[0]:
            xe = centroid + gamma * (xr - centroid)
            fe = f(xe)
            if fe < fr:
                simplex[-1], fvals[-1] = xe, fe
            else:
                simplex[-1], fvals[-1] = xr, fr
        elif fr < fvals[-2]:
            simplex[-1], fvals[-1] = xr, fr
        else:
            xc = centroid + rho * (simplex[-1] - centroid)
            fc = f(xc)
            if fc < fvals[-1]:
                simplex[-1], fvals[-1] = xc, fc
            else:
                simplex = [simplex[0]] + [
                    simplex[0] + sigma * (s - simplex[0]) for s in simplex[1:]
                ]
                fvals = [fvals[0]] + [f(s) for s in simplex[1:]]

    best = simplex[int(np.argmin(fvals))]
    ctx.notice("  - nelder-mead best params: {}\n", list(np.round(best, 6)))
    return _run_with(ctx, pb, best, dev)


def _annoying_variable(res: Result, pb: Problem) -> int:
    """Pick the split variable. The reference reads
    ``result.annoying_variable``, which its solvers never set (declared
    core:740, read only by branch-optimizer.cpp:155-168, always 0). Here
    the optimizer measures it: ``OptState.flips`` counts sweep-induced
    per-variable bit flips across all replicas (solver/optimize.py), and
    its argmax arrives on the result. Fallback when the counter never
    fired: highest constraint degree."""
    degree: dict[int, int] = {}
    for _, cst in pb.all_constraints():
        for el in cst.elements:
            degree[el.variable_index] = degree.get(el.variable_index, 0) + 1
    # res.annoying_variable indexes res's OWN compacted variable space;
    # pb may be a subproblem with a different compaction after split() —
    # map through the variable NAME, which is stable across compactions
    if res.annoying_variable and res.variable_name:
        if 0 <= res.annoying_variable < len(res.variable_name):
            name = res.variable_name[res.annoying_variable]
            try:
                return pb.vars.names.index(name)
            except ValueError:
                pass  # variable was fixed away in this node; fall through
    if not degree:
        return 0
    return max(degree, key=degree.get)


def branch_optimize(
    ctx: Context, raw: RawProblem, device: DeviceLike = None
) -> Result:
    """Best-first recursive splitting (reference: branch-optimizer.cpp:84-228):
    keep a set of subproblems ordered by (remaining, value), repeatedly
    optimize the best, split it on the chosen variable and re-queue both
    halves. The reference loop has no termination condition beyond an
    empty queue; here the node budget is bounded."""
    dev = resolve_device(device)
    pb = _prepare(ctx, raw)
    minimize = pb.type == ObjectiveType.minimize
    node_limit = 16
    t0 = time.monotonic()
    # The user's time_limit is the TOTAL branch budget, sliced across
    # node evaluations like nelder_mead_optimize slices its budget across
    # simplex evaluations — the loop stops once the total is spent, so
    # wall clock <= time_limit + one node's slice. (The reference gives
    # every node a full budget with no termination condition at all,
    # branch-optimizer.cpp:159-212.)
    wall_budget = ctx.parameters.time_limit if ctx.parameters.time_limit > 0 else 10.0

    internal = _internal(ctx)
    internal.parameters.time_limit = max(wall_budget / 8.0, 0.5)

    best_res = opt.optimize_compiled(internal, pb, device=dev)
    best_score = _score(best_res, minimize)

    # queue entries carry the node's OWN result so the split statistic is
    # read in the node's index space (then name-mapped by
    # _annoying_variable)
    nodes: List[Tuple[int, float, Problem, Result]] = []
    if len(pb.vars.names) > 1:
        nodes.append((best_res.remaining_constraints, best_score, pb, best_res))

    processed = 0
    while nodes and processed < node_limit:
        # rank 0's clock decides for every rank of a process group: a rank
        # that stopped here alone would leave the others' collectives
        # waiting
        if from_rank0(int(time.monotonic() - t0 > wall_budget), dev):
            break
        nodes.sort(key=lambda t: (t[0], t[1]))
        _, _, node_pb, node_res = nodes.pop(0)
        processed += 1

        var = _annoying_variable(node_res, node_pb)
        try:
            hi, lo = split(internal, node_pb, var)
        except BaryonyxError:  # the pinning contradicts a row
            continue

        for sub in (hi, lo):
            if not sub.vars.names:
                continue
            # a node the solver refuses is skipped; a failure of the
            # device or of a kernel is not
            try:
                res = opt.optimize_compiled(internal, sub, device=dev)
            except (BaryonyxError, NotImplementedError):
                continue
            score = _score(res, minimize)
            if score < best_score:
                best_score = score
                best_res = res
            if res.status == ResultStatus.success and len(sub.vars.names) > 1:
                nodes.append((res.remaining_constraints, score, sub, res))

    return best_res
