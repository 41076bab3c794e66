"""Optimize mode: evolutionary multi-start as batched solver replicas, on
one device.

The reference spawns N threads, each looping restart → annealed run → push
phase, sharing one solution population under a mutex
(reference: itm-optimizer-common.hpp:620-751 optimize_functor,
:776-908 optimize_problem). Here each "thread" is a replica on the trailing
axis R of every state tensor: one evolution step advances every replica by
one sweep (the fused sweep of ops/psweep.py, or ops/zsweep.py's for
instances with integer factors) and runs its per-replica restart state
machine; population insertion, crossover and mutation are batched tensor
ops inside the same step.

Replica phases: ANNEAL (kappa-annealed feasibility run), PUSH (one
objective-amplified sweep), PUSH_ITER (recovery sweeps after a push, kappa
reset to kappa_start). A finished replica reports its result to the
population and is re-seeded in the same step via the kappa-improve ladder
or population crossover + mutation (reference: best_solution_recorder::
reinit, :528-554). P and pi persist across restarts.

A step never waits for the device: every per-step quantity (the schedule,
the row count, the order code, the tie-noise seed) stays on the device,
and the host loop only fetches one small stats vector per chunk.

Deviations from the reference, on purpose:
- the row schedule is shared across replicas; the state-dependent ordering
  policies aggregate over replicas, and the `cycle` policy advances
  globally per step instead of per thread;
- push sweeps process every row.
"""

from __future__ import annotations

import time
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from baryonyx_torch.core.context import Context
from baryonyx_torch.core.errors import InfeasibleConstraintError
from baryonyx_torch.core.model import ObjectiveType, Problem
from baryonyx_torch.core.params import (
    ConstraintOrder,
    FloatType,
    ObserverType,
    SolverParameters,
    SolverType,
    StorageType,
)
from baryonyx_torch.core.result import Result, ResultStatus, Solution
from baryonyx_torch.device import DeviceLike, resolve_device
from baryonyx_torch.memory import estimated_peak_bytes
from baryonyx_torch.ops import psweep as pw
from baryonyx_torch.ops import zsweep as zs
from baryonyx_torch.ops.layout import CompiledProblem, compile_problem
from baryonyx_torch.ops.sweep import violated_mask
from baryonyx_torch.preprocess.merge import make_merged_constraints
from baryonyx_torch.solver import common
from baryonyx_torch.solver.population import (
    Population,
    batch_insert,
    draw_victims,
    hash_x,
    init_population_host,
    make_hash_weights,
    sort_population,
)

PHASE_ANNEAL, PHASE_PUSH, PHASE_PUSH_ITER = 0, 1, 2
FLIP_DECAY = 0.9  # per host chunk (see evolve)
INT_MAX = 2**31 - 1


class ReplicaState(NamedTuple):
    x: torch.Tensor  # int32[n, R]
    P: torch.Tensor  # f32[m, Kr, R]
    pi: torch.Tensor  # f32[m, R]
    S: torch.Tensor  # f32[n, R] — carried merged column sums
    viol: torch.Tensor  # bool[m, R]
    kappa: torch.Tensor  # f32[R]
    kappa_start: torch.Tensor  # f32[R]
    kappa_append: torch.Tensor  # f32[R] — the per-thread ladder position
    iter_i: torch.Tensor  # int32[R] — counter within the current phase
    phase: torch.Tensor  # int32[R]
    push_idx: torch.Tensor  # int32[R]
    best_remaining: torch.Tensor  # int32[R] — per-restart min
    restarts: torch.Tensor  # int32[R] — reference: m_call_number
    best_value: torch.Tensor  # f32[R] — lifetime best feasible score
    # (minimize-oriented; +inf until the replica finds a feasible x)


class OptState(NamedTuple):
    replicas: ReplicaState
    pop: Population
    gen: torch.Generator  # the step's random stream, on the state's device
    order_code: torch.Tensor  # int32 scalar — shared scheduling policy
    sweeps: int  # evolution steps executed (counted on the host)
    flips: torch.Tensor  # f32[n] — decayed per-variable flip counter
    # summed over replicas (Result.annoying_variable)


class EvolveInputs(NamedTuple):
    """What every evolution step reads and never changes."""

    cp: CompiledProblem
    cost_norm: torch.Tensor  # f32[n]
    cost_orig: torch.Tensor  # f32[n]
    cost_constant: float
    bastert_x: torch.Tensor  # int32[n]
    hash_weights: torch.Tensor  # int64[n]
    hp: dict  # scalar hyperparameters (Python numbers)
    minimize: bool
    block_size: int
    order_policy: Optional[ConstraintOrder] = None


def one_step(ev: EvolveInputs, state: OptState) -> OptState:
    """Every replica does one sweep plus its state-machine transition;
    finished replicas report to the population and restart."""
    cp, hp, minimize = ev.cp, ev.hp, ev.minimize
    rs = state.replicas
    gen = state.gen
    m, n = cp.m, cp.n
    R = rs.kappa.shape[0]
    dev = rs.P.device
    dtype = rs.P.dtype
    B = ev.block_size
    mp = ((m + B - 1) // B) * B

    is_push = rs.phase == PHASE_PUSH
    # the push kappa scales kappa_start like the solve-mode push does
    # (itm-solver-common.hpp:171-179): the push processes every row here
    kappa_eff = torch.where(
        is_push, hp["pushing_k_factor"] * rs.kappa_start, rs.kappa
    )
    amp = torch.where(is_push, hp["pushing_objective_amplifier"], 0.0)

    order = common.make_order(
        cp, state.order_code, rs.x, rs.pi, gen, mp,
        static_policy=ev.order_policy,
    )
    process_all = (
        state.order_code
        == common.ORDER_CODES[ConstraintOrder.pi_sign_change]
    )
    sched = rs.viol | is_push[None, :] | process_all  # [m, R]
    # schedule dither: the row order is shared across replicas, which
    # correlates their trajectories; half the lanes randomly sit out 15%
    # of their scheduled rows per sweep. Push lanes never skip.
    dither_lane = (torch.arange(R, device=dev) % 2 == 1)[None, :]
    skip = (
        (torch.rand((m, R), generator=gen, device=dev) < 0.15)
        & dither_lane
        & ~is_push[None, :]
        & ~process_all  # pi_sign_change is exact only over ALL rows
    )
    sched = sched & ~skip

    # compact the scheduled rows (union over replicas) to the front of
    # the order; n_rows bounds the kernel's block loop on the device. The
    # sentinel m is never used as an index.
    sched_any = sched.any(dim=1)  # [m]
    padded = torch.cat([sched_any, sched_any.new_zeros(1)])[
        order.long().clamp(max=m)
    ]
    order2 = order[torch.argsort((~padded).to(torch.int8), stable=True)]

    if cp.has_z:
        # the Z sweep walks every block (no row count read on the host)
        # and keeps no column sums across sweeps
        x, P, pi, viol, remaining = zs.z_sweep(
            cp, rs.x, rs.P, rs.pi, ev.cost_norm, sched, order2, kappa_eff,
            hp["delta"], hp["theta"], gen, amp, minimize=minimize,
            block_size=B,
        )
        S = rs.S
    else:
        n_rows = padded.sum(dtype=torch.int32)
        seed = torch.randint(
            0, INT_MAX, (2,), generator=gen, device=dev, dtype=torch.int32
        )
        x, P, pi, S, viol, remaining = pw.psweep(
            cp, rs.x, rs.P, rs.pi, ev.cost_norm, sched, order2, kappa_eff,
            hp["delta"], hp["theta"], seed, amp, n_rows=n_rows,
            minimize=minimize, block_size=B, S=rs.S,
            S_fresh=(state.sweeps % 16) != 0,
        )

    value = ev.cost_orig @ x.to(dtype) + ev.cost_constant
    found = remaining == 0  # [R]
    # per-variable instability: sweep-induced bit flips summed over
    # replicas (before any restart reseeding below)
    flips = state.flips + (x != rs.x).to(torch.float32).sum(dim=1)
    score = value if minimize else -value
    best_value = torch.where(
        found & (score < rs.best_value), score, rs.best_value
    )
    it1 = rs.iter_i + 1

    # --- ANNEAL transitions (reference: :668-699) ---
    in_anneal = rs.phase == PHASE_ANNEAL
    best_rem = torch.where(
        in_anneal, torch.minimum(rs.best_remaining, remaining), rs.best_remaining
    )
    anneal_kappa = rs.kappa + hp["kappa_step"] * torch.pow(
        remaining.to(dtype) / float(cp.m_real), hp["alpha"]
    )
    do_anneal = (rs.iter_i > hp["w"]) & ~found
    kappa = torch.where(in_anneal & do_anneal, anneal_kappa, rs.kappa)
    anneal_fail = in_anneal & ~found & (
        (kappa > hp["kappa_max"]) | (it1 >= hp["limit"])
    )
    anneal_found = in_anneal & found

    # --- PUSH_ITER transitions (reference: :724-749) ---
    in_pi = rs.phase == PHASE_PUSH_ITER
    kappa = torch.where(in_pi & do_anneal, anneal_kappa, kappa)
    pi_end = in_pi & (
        found | (kappa > hp["kappa_max"]) | (it1 >= hp["push_iters"])
    )
    push_idx = torch.where(pi_end, rs.push_idx + 1, rs.push_idx)
    push_exhausted = pi_end & (push_idx >= hp["pushes_limit"])

    restart = anneal_fail | push_exhausted

    # --- population inserts (pre-reinit x): feasible x in any phase →
    # try_update; failed anneal → try_advance (reference: :556-585)
    cand_mask = found | anneal_fail
    cand_remaining = torch.where(found, 0, best_rem).to(torch.int32)
    Psize = state.pop.x.shape[0]
    pop = batch_insert(
        state.pop, x.T, value, cand_remaining, cand_mask,
        draw_victims(gen, R, Psize, dev), ev.hash_weights, minimize,
    )

    # --- reinit for restarting replicas (reference: :528-554) ---
    ladder = rs.kappa_append < hp["kappa_improve_stop"]
    new_append = torch.where(
        restart,
        torch.where(
            ladder,
            rs.kappa_append + hp["kappa_improve_increase"],
            hp["kappa_improve_start"],
        ),
        rs.kappa_append,
    )
    ladder_kappa = (
        hp["kappa_min"] + (hp["kappa_max"] - hp["kappa_min"]) * new_append
    )

    def pick():
        v = (
            hp["sel_mean"]
            + hp["sel_stddev"] * torch.randn(R, generator=gen, device=dev)
        ).abs()
        return (v.clamp(max=0.999) * Psize).long()

    def coin(shape, p):
        return torch.rand(shape, generator=gen, device=dev) < p

    i1 = pick()
    i2 = pick()
    i2 = torch.where(i2 == i1, (i1 + 1) % Psize, i2)
    first = pop.x[i1].T  # [n, R]
    # exploration stream: a fixed 1/8 of the replica lanes never
    # crossover — they restart from bastert/random every time
    explore = torch.arange(R, device=dev) < max(R // 8, 1)
    use_special = explore | coin((R,), hp["bastert_insertion"])
    special = torch.where(
        coin((R,), 0.5)[None, :],
        ev.bastert_x[:, None],
        coin((n, R), 0.5).to(torch.int32),
    )
    other = torch.where(use_special[None, :], special, pop.x[i2].T)
    take2 = coin((n, R), 0.5)
    crossed = torch.where(take2 & (first != other), other, first)
    crossed = torch.where(explore[None, :], special, crossed)

    # ladder restarts keep x; crossover restarts replace it
    nx = torch.where((~ladder)[None, :], crossed, x)

    # mutation (reference: :494-526); truncated-normal resampling
    # approximated by |N| + clip, with independent rate draws
    if hp["mut_enabled"]:
        var_p = (
            hp["mut_var_mean"]
            + hp["mut_var_stddev"] * torch.randn(R, generator=gen, device=dev)
        ).abs().clamp(1e-7, 0.999)
        val_p = (
            hp["mut_val_mean"]
            + hp["mut_val_stddev"] * torch.randn(R, generator=gen, device=dev)
        ).abs().clamp(0.0, 1.0)
        mutate = coin((n, R), var_p[None, :])
        mval = coin((n, R), val_p[None, :]).to(torch.int32)
        nx = torch.where(mutate, mval, nx)

    x = torch.where(restart[None, :], nx, x)

    new_kappa_start = torch.where(
        restart,
        torch.where(ladder, ladder_kappa, hp["kappa_min"]),
        rs.kappa_start,
    )
    kappa = torch.where(restart, new_kappa_start, kappa)

    # phase transitions
    enter_pi = is_push  # the amplified sweep just ran
    phase = torch.where(
        anneal_found,
        PHASE_PUSH,
        torch.where(
            enter_pi,
            PHASE_PUSH_ITER,
            torch.where(pi_end & ~push_exhausted, PHASE_PUSH, rs.phase),
        ),
    )
    phase = torch.where(restart, PHASE_ANNEAL, phase).to(torch.int32)

    # after the amplified sweep kappa resets to kappa_start (reference: :722)
    kappa = torch.where(enter_pi, rs.kappa_start, kappa)
    iter_i = torch.where(
        enter_pi | restart | anneal_found | (pi_end & ~push_exhausted), 0, it1
    ).to(torch.int32)
    push_idx = torch.where(restart | anneal_found, 0, push_idx).to(torch.int32)
    best_rem = torch.where(restart, INT_MAX, best_rem).to(torch.int32)

    # cycle advances globally when any replica pushed
    order_code = state.order_code
    if hp["use_cycle"]:
        order_code = torch.where(
            is_push.any(), (order_code + 1) % common.N_CYCLE_STATES, order_code
        ).to(torch.int32)

    # restarting replicas recompute their violated set from the new x
    viol = torch.where(restart[None, :], violated_mask(cp, x), viol)

    new_rs = ReplicaState(
        x=x, P=P, pi=pi, S=S, viol=viol, kappa=kappa,
        kappa_start=new_kappa_start, kappa_append=new_append,
        iter_i=iter_i, phase=phase, push_idx=push_idx,
        best_remaining=best_rem,
        restarts=rs.restarts + restart.to(torch.int32),
        best_value=best_value,
    )
    return OptState(new_rs, pop, gen, order_code, state.sweeps + 1, flips)


def evolve(ev: EvolveInputs, state: OptState, n_steps: int) -> OptState:
    """``n_steps`` evolution steps, then the per-chunk flip-counter decay
    (an exponential decay keeps it biased to recent instability)."""
    flips0 = state.flips
    for _ in range(n_steps):
        state = one_step(ev, state)
    return state._replace(flips=FLIP_DECAY * flips0 + (state.flips - flips0))


def default_replicas(params: SolverParameters, device: torch.device) -> int:
    """reference: get_thread_number (itm-optimizer-common.hpp:757-774) —
    thread <= 0 means auto: 512 replicas on a CUDA device, 16 on the CPU
    (tests)."""
    if params.thread > 0:
        return params.thread
    return 512 if device.type == "cuda" else 16


def device_budget_bytes(device: torch.device) -> Optional[int]:
    """Bytes the optimize state may use on a CUDA device: three quarters
    of its memory; None on the CPU."""
    if device.type != "cuda":
        return None
    _free, total = torch.cuda.mem_get_info(device)
    return int(total * 0.75)


def replica_batch(
    ctx: Context, cp: CompiledProblem, params: SolverParameters,
    device: torch.device,
) -> Tuple[int, int]:
    """The replica batch R and the row block size the optimizer runs
    with: on CUDA the largest of (2048, 4), (1024, 4), (1024, 8) the
    fused sweep takes (an explicit thread count or block size wins); Z
    instances keep ``default_replicas`` and the requested block size, as
    the JAX package does. Then R is halved while the state overflows the
    device budget."""
    dtype = torch.float32
    R = default_replicas(params, device)
    block_size = params.block_size
    if not cp.has_z and params.thread <= 0 and device.type == "cuda":
        # grow the replica batch to the largest the fused sweep takes;
        # honor an explicit user block_size
        user_B = params.block_size != SolverParameters().block_size
        for cand_R, cand_B in ((2048, 4), (1024, 4), (1024, 8)):
            bs = params.block_size if user_B else cand_B
            if cand_R > R and pw.supports(cp, cand_R, dtype, device):
                R = cand_R
                block_size = bs
                break
    if not cp.has_z and not pw.supports(cp, R, dtype, device):
        _refuse(
            f"this instance at R={R} (Kr={cp.Kr}; R % 32 on CUDA)",
            "Queue 1 item 2, the general sweep",
        )

    # size the replica batch by the device budget; past it at R=128 the
    # JAX package shards rows across devices, which is not ported
    budget = device_budget_bytes(device)
    if budget is not None:
        def peak(R):
            return estimated_peak_bytes(cp, R, B=block_size)

        while peak(R) > budget and R > 128:
            R //= 2
        if peak(R) > budget:
            _refuse(
                f"an optimize state over the device budget "
                f"({peak(R)} bytes at R={R}, budget "
                f"{budget}), which needs row sharding,",
                "Queue 1 item 11",
            )
    return R, block_size


def _budget_loop(
    ctx: Context,
    state: OptState,
    run_evolve,
    stats_fn,
    chunk: int,
    time_limit: float,
    sweep_budget: float,
    budget_t0: float,
    bound_fn=None,
    diversify_fn=None,
    value_sign: float = 1.0,
) -> OptState:
    """The host-side chunk loop: run `chunk` evolve steps at a time until
    the wall-clock budget or the total sweep budget is exhausted
    (reference terminator: itm-optimizer-common.hpp:836-859). The chunk
    length adapts so each host round trip buys ~0.5 s of device work.
    Ctrl-C returns the best population found so far."""
    best_lb = float("-inf")  # bound_fn orientation: higher is tighter
    best_seen = (np.inf, np.inf)  # (remaining, value) of the pool head
    stagnant = 0
    try:
        while True:
            t_chunk = time.monotonic()
            state = run_evolve(state, chunk)
            # one small fetch per chunk synchronizes with the device
            stats = stats_fn(state)
            dt_chunk = time.monotonic() - t_chunk
            # cataclysm on stagnation: when the pool head stops improving
            # for several chunks, keep the elite fifth and re-randomize
            # the rest
            cur = (float(stats[0]), value_sign * float(stats[1]))
            if cur < best_seen:
                best_seen = cur
                stagnant = 0
            else:
                stagnant += 1
            if diversify_fn is not None and stagnant >= 6:
                state = diversify_fn(state)
                stagnant = 0
            # sweep-budget mode (no time limit) keeps the chunk FIXED so
            # runs are reproducible
            if time_limit != float("inf"):
                if dt_chunk < 0.35 and chunk < (1 << 14):
                    chunk = min(chunk * 4, 1 << 14)
                elif dt_chunk > 1.5 and chunk > 1:
                    chunk = max(chunk // 2, 1)
            if ctx.update_cb:
                ctx.update_cb(
                    int(stats[0]),
                    float(stats[1]),
                    int(stats[2]),
                    time.monotonic() - budget_t0,
                    int(stats[3]),
                )
            if bound_fn is not None:
                # dual-bound/gap print; only improvements print
                # (reference: itm-common.hpp:501-625)
                lb, score = bound_fn(state)
                if score > best_lb:
                    best_lb = score
                    best = float(stats[1])
                    gap = (
                        abs(best - lb) / max(abs(best), 1e-9) * 100.0
                        if int(stats[0]) == 0
                        else float("nan")
                    )
                    ctx.info(
                        "  - sweeps {}: dual-bound {:.6g} best {:.6g} "
                        "gap {:.2f}%\n",
                        int(stats[2]), lb, best, gap,
                    )
            if (time.monotonic() - budget_t0) >= time_limit:
                break
            if float(stats[2]) >= sweep_budget:
                break
    except KeyboardInterrupt:
        ctx.notice("optimize: interrupted; returning best population\n")
    return state


def _refuse(what: str, item: str) -> None:
    raise NotImplementedError(
        f"{what} is not ported to the PyTorch solver yet (ROADMAP.md "
        f"{item})"
    )


def optimize_compiled(
    ctx: Context, pb: Problem, device: DeviceLike = None
) -> Result:
    """reference: optimize_problem (itm-optimizer-common.hpp:776-908), on
    one device (CUDA unless ``device="cpu"``)."""
    t0 = time.monotonic()
    dev = resolve_device(device)
    params = ctx.parameters
    minimize = pb.type == ObjectiveType.minimize
    if params.float_type == FloatType.float64:
        _refuse("float64", "Queue 1 item 2, the general sweep")
    if params.solver == SolverType.random:
        _refuse("the random solver", "Queue 1 item 2, the general sweep")
    if params.checkpoint_path:
        _refuse("checkpointing", "Queue 1 item 10")
    dtype = torch.float32

    ret = Result(method="optimize")
    n = len(pb.vars.values)
    constraints = make_merged_constraints(ctx, pb)

    if not constraints or n == 0:
        ret.status = ResultStatus.success
        ret.solutions.append(Solution([], pb.objective.value))
        common.finalize(ret, pb, len(constraints), t0)
        return ret

    # observer/debug runs want the real loop's trace
    if params.observer == ObserverType.none and not params.debug:
        from baryonyx_torch.solver.exact import exact_enumerate

        exact = exact_enumerate(pb, constraints, n)
        if exact is not None:
            bits, value = exact
            ctx.info(
                "  - exact enumeration ({} variables): optimum {}\n", n, value
            )
            ret.method += "+exact-enum"
            ret.status = ResultStatus.success
            ret.solutions.append(Solution([int(b) for b in bits], value))
            common.finalize(ret, pb, len(constraints), t0)
            return ret

    seed = params.seed if params.seed else int(time.time())
    rng = np.random.default_rng(seed)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)

    try:
        cp = compile_problem(
            constraints, n, dtype=dtype, qelements=pb.objective.qelements,
            device=dev,
        )
    except InfeasibleConstraintError as e:
        ctx.warning("  - infeasible at compile time: {}\n", e)
        ret.status = ResultStatus.limit_reached
        ret.remaining_constraints = 1
        common.finalize(ret, pb, len(constraints), t0)
        return ret
    if cp.has_quad:
        _refuse("a quadratic objective", "Queue 1 item 9")
    if not cp.has_z and not cp.sel_reduction_ok:
        _refuse(
            "an instance whose selection needs the full sort",
            "Queue 1 item 2, the general sweep",
        )
    cost_orig_real = common.build_cost_vector(pb, n)
    cost_norm_real = common.normalize_costs(cost_orig_real, params.cost_norm, rng)
    pad = cp.n - n
    cost_orig = np.pad(cost_orig_real, (0, pad))
    cost_norm = np.pad(cost_norm_real, (0, pad))

    R, block_size = replica_batch(ctx, cp, params, dev)
    P_size = params.init_population_size

    # vectorized host oracle for the population init: flat (factor, var)
    # element arrays + reduceat per row
    _ef = np.concatenate(
        [[el.factor for el in cst.elements] for cst in constraints]
    ).astype(np.float64)
    _ev = np.concatenate(
        [[el.variable_index for el in cst.elements] for cst in constraints]
    ).astype(np.int64)
    _rptr = np.cumsum([0] + [len(c_.elements) for c_ in constraints])[:-1]
    _rmin = np.array([c_.min for c_ in constraints], np.float64)
    _rmax = np.array([c_.max for c_ in constraints], np.float64)

    def evaluate(x: np.ndarray):
        xf = x[:n].astype(np.float64)
        value = float(cost_orig_real @ xf) + pb.objective.value
        act = np.add.reduceat(_ef * xf[_ev], _rptr)
        rem = int(np.sum((act < _rmin) | (act > _rmax)))
        return value, rem

    pop_x, pop_val, pop_rem = init_population_host(
        params, cost_orig_real, constraints, minimize, rng, P_size, evaluate
    )
    pop_x = np.pad(pop_x, ((0, 0), (0, pad)))
    # sort best-first on the host (same key as sort_population)
    order0 = np.lexsort((pop_val if minimize else -pop_val, pop_rem))
    pop_x, pop_val, pop_rem = pop_x[order0], pop_val[order0], pop_rem[order0]
    # padded variables carry zero hash weight so stray bits there (e.g.
    # from mutation) cannot defeat the population dedup
    hw_np = make_hash_weights(cp.n, seed)
    hw_np[n:] = 0
    hw = torch.as_tensor(hw_np.astype(np.int64), device=dev)
    pop_x_t = torch.as_tensor(pop_x, dtype=torch.int32, device=dev)
    pop = Population(
        x=pop_x_t,
        value=torch.as_tensor(pop_val, dtype=dtype, device=dev),
        remaining=torch.as_tensor(pop_rem, dtype=torch.int32, device=dev),
        hash=hash_x(pop_x_t, hw),
    )

    bastert = torch.as_tensor(
        np.pad(common.init_bastert(cost_orig_real, minimize), (0, pad)),
        dtype=torch.int32, device=dev,
    )

    delta = (
        common.compute_delta(cost_norm, params.theta)
        if params.delta < 0
        else params.delta
    )
    # The reference's optimize-mode push walks the (empty) violated list,
    # so its nominal push budget is never spent there; ours re-optimizes
    # the incumbent over every row, so any requested budget maps onto its
    # active-push equivalent: one amplified round, up to 10 recovery
    # sweeps. Solve mode honors the request verbatim.
    pushes_limit = min(params.pushes_limit, 1)
    push_iters = min(params.pushing_iteration_limit, 10)
    if (params.pushes_limit, params.pushing_iteration_limit) not in (
        (100, 50),  # the defaults — remapping those is the documented policy
        (pushes_limit, push_iters),
    ):
        ctx.warning(
            "optimize mode maps pushes_limit={}/pushing_iteration_limit={} "
            "onto the active-push equivalent ({}/{}); solve mode honors the "
            "requested values verbatim\n",
            params.pushes_limit,
            params.pushing_iteration_limit,
            pushes_limit,
            push_iters,
        )
    def f32(v) -> float:
        return float(np.float32(v))

    hp = dict(
        delta=f32(delta),
        theta=f32(params.theta),
        kappa_min=f32(params.kappa_min),
        kappa_step=f32(params.kappa_step),
        kappa_max=f32(params.kappa_max),
        alpha=f32(params.alpha),
        w=int(params.w),
        limit=int(min(params.limit, INT_MAX)),
        pushes_limit=int(pushes_limit),
        push_iters=int(push_iters),
        pushing_k_factor=f32(params.pushing_k_factor),
        pushing_objective_amplifier=f32(params.pushing_objective_amplifier),
        kappa_improve_start=f32(params.init_kappa_improve_start),
        kappa_improve_increase=f32(params.init_kappa_improve_increase),
        kappa_improve_stop=f32(params.init_kappa_improve_stop),
        sel_mean=f32(params.init_crossover_solution_selection_mean),
        sel_stddev=f32(params.init_crossover_solution_selection_stddev),
        bastert_insertion=f32(params.init_crossover_bastert_insertion),
        mut_var_mean=f32(params.init_mutation_variable_mean),
        mut_var_stddev=f32(params.init_mutation_variable_stddev),
        mut_val_mean=f32(params.init_mutation_value_mean),
        mut_val_stddev=f32(params.init_mutation_value_stddev),
        mut_enabled=not (
            params.init_mutation_value_mean == 0.0
            and params.init_mutation_value_stddev == 0.0
        ),
        use_cycle=params.order == ConstraintOrder.cycle,
    )

    # replica init: a quarter of the replicas start from a zero x plus
    # the reinit mutation, like the reference's optimize threads
    # (itm-optimizer-common.hpp:627,661,528-554); the rest draw diverse
    # starting points from the population
    x0_np = np.zeros((R, cp.n), np.int32)
    n_pop_draw = R - max(R // 4, min(64, R // 2))
    if n_pop_draw:
        init_idx = np.minimum(
            np.abs(rng.normal(0, 0.5, n_pop_draw)) * P_size, P_size - 1
        ).astype(np.int32)
        x0_np[:n_pop_draw] = pop_x[init_idx]
    if hp["mut_enabled"]:
        var_p = np.clip(
            np.abs(
                rng.normal(
                    params.init_mutation_variable_mean,
                    params.init_mutation_variable_stddev,
                    (R, 1),
                )
            ),
            1e-7,
            0.999,
        )
        val_p = np.clip(
            np.abs(
                rng.normal(
                    params.init_mutation_value_mean,
                    params.init_mutation_value_stddev,
                    (R, 1),
                )
            ),
            0.0,
            1.0,
        )
        mut = rng.random((R, cp.n)) < var_p
        x0_np = np.where(mut, (rng.random((R, cp.n)) < val_p), x0_np).astype(
            np.int32
        )
        x0_np[:, n:] = 0
    x0 = torch.as_tensor(x0_np.T.copy(), device=dev)  # int32[n, R]
    # first ladder rung (reference reinit's first call bumps kappa_append
    # before the first inner run)
    append0 = params.init_kappa_improve_start + params.init_kappa_improve_increase
    kappa0 = params.kappa_min + (params.kappa_max - params.kappa_min) * (
        append0 if append0 < params.init_kappa_improve_stop else 0.0
    )
    order_code = common.ORDER_CODES.get(params.order, 0)

    def full(v, dt):
        return torch.full((R,), v, dtype=dt, device=dev)

    rs = ReplicaState(
        x=x0,
        P=torch.zeros((cp.m, cp.Kr, R), dtype=dtype, device=dev),
        pi=torch.zeros((cp.m, R), dtype=dtype, device=dev),
        S=torch.zeros((cp.n, R), dtype=dtype, device=dev),
        viol=violated_mask(cp, x0),
        kappa=full(kappa0, dtype),
        kappa_start=full(kappa0, dtype),
        kappa_append=full(append0, dtype),
        iter_i=full(0, torch.int32),
        phase=full(0, torch.int32),
        push_idx=full(0, torch.int32),
        best_remaining=full(INT_MAX, torch.int32),
        restarts=full(0, torch.int32),
        best_value=full(float("inf"), dtype),
    )
    state = OptState(
        rs, pop, gen,
        torch.tensor(order_code, dtype=torch.int32, device=dev),
        0, torch.zeros((cp.n,), dtype=torch.float32, device=dev),
    )
    co = torch.as_tensor(cost_orig, dtype=dtype, device=dev)
    ev = EvolveInputs(
        cp=cp,
        cost_norm=torch.as_tensor(cost_norm, dtype=dtype, device=dev),
        cost_orig=co,
        cost_constant=float(pb.objective.value),
        bastert_x=bastert,
        hash_weights=hw,
        hp=hp,
        minimize=minimize,
        block_size=block_size,
        order_policy=params.order,
    )

    # Stopping: with a time limit, run until it expires (reference:
    # itm-optimizer-common.hpp:836-859); without one the total sweep
    # budget falls back to `limit`.
    time_limit = params.time_limit if params.time_limit > 0 else float("inf")
    sweep_budget = float("inf")
    if params.time_limit <= 0:
        sweep_budget = min(params.limit, INT_MAX)
        ctx.notice(
            "optimize: no time limit; running {} sweeps (the loop limit) — "
            "interrupt to stop early\n",
            sweep_budget,
        )

    def stats_fn(st: OptState) -> np.ndarray:
        dev_stats = torch.stack(
            [
                st.pop.remaining[0].to(torch.float64),
                st.pop.value[0].to(torch.float64),
                st.replicas.restarts.sum().to(torch.float64),
            ]
        ).cpu().numpy()
        return np.array([dev_stats[0], dev_stats[1], st.sweeps, dev_stats[2]])

    # the kernels build at first use: keep that out of the time budget
    if dev.type == "cuda":
        if not cp.has_z:
            pw.psweep_kernel.load()
        elif cp.Wdp:
            zs.dp_select_kernel.load()
    budget_t0 = time.monotonic()
    chunk = max(1, params.chunk_size)

    n_keep = max(P_size // 5, 1)
    pad_mask = (torch.arange(cp.n, device=dev) < n).to(torch.int32)

    def diversify(st: OptState) -> OptState:
        Psz = st.pop.x.shape[0]
        rnd = (
            torch.rand((Psz - n_keep, cp.n), generator=st.gen, device=dev) < 0.5
        ).to(torch.int32) * pad_mask[None, :]
        newx = torch.cat([st.pop.x[:n_keep], rnd])
        value = newx.to(dtype) @ co + ev.cost_constant
        rem = violated_mask(cp, newx.T).sum(dim=0, dtype=torch.int32)
        pop2 = sort_population(
            Population(x=newx, value=value, remaining=rem, hash=hash_x(newx, hw)),
            minimize,
        )
        return st._replace(pop=pop2)

    bound_fn = None
    if params.print_level > 0:
        def bound_fn(st):
            lb = common.dual_bound(
                cp, st.replicas.pi[:, 0].cpu().numpy(), cost_norm, minimize
            )
            # second element: tightness score (higher = tighter)
            return lb, (lb if minimize else -lb)

    state = _budget_loop(
        ctx, state, lambda st, k: evolve(ev, st, k), stats_fn, chunk,
        time_limit, sweep_budget, budget_t0, bound_fn=bound_fn,
        diversify_fn=diversify, value_sign=1.0 if minimize else -1.0,
    )

    # extraction (reference: :869-900); best LAST to match Result.best
    pop = state.pop
    rem0 = int(pop.remaining[0])
    if rem0 == 0:
        ret.status = ResultStatus.success
    elif params.time_limit > 0:
        ret.status = ResultStatus.time_limit_reached
    else:
        ret.status = ResultStatus.limit_reached
    ret.remaining_constraints = rem0
    ret.loop = state.sweeps
    fl = state.flips[:n].cpu().numpy()
    if fl.size and fl.max() > 0:
        ret.annoying_variable = int(np.argmax(fl))

    if params.storage == StorageType.one:
        want = [0]
    elif params.storage == StorageType.bound:
        want = [P_size - 1, 0]
    else:
        want = [4, 3, 2, 1, 0]
    pop_x_head = pop.x[: max(want) + 1].cpu().numpy()

    def to_solution(i: int) -> Solution:
        xi = pop_x_head[i][:n]
        val = common.objective_value(pb, xi)
        return Solution([int(v) for v in xi], val)

    ret.solutions = [to_solution(i) for i in want]
    ret.replicas = R
    ret.block_size = block_size

    common.finalize(ret, pb, len(constraints), t0)
    if ctx.finish_cb:
        ctx.finish_cb(ret)
    return ret
