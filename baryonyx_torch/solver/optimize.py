"""Optimize mode: evolutionary multi-start as batched solver replicas, on
one device or over the ranks of a process group.

The reference spawns N threads, each looping restart → annealed run → push
phase, sharing one solution population under a mutex
(reference: itm-optimizer-common.hpp:620-751 optimize_functor,
:776-908 optimize_problem). Here each "thread" is a replica on the trailing
axis R of every state tensor: one evolution step advances every replica by
one sweep (the fused sweep of ops/psweep.py where it applies, else the
general sweep of ops/sweep.py; ops/zsweep.py's for instances with integer
factors) and runs its per-replica restart state machine; population
insertion, crossover and mutation are batched tensor ops inside the same
step. Quadratic objectives add c(j, x) = c_j + sum of the set neighbors'
normalized factors to the costs (a dense CQ = quad_mat @ x at sweep entry
for the fused sweep, per-slot gathers in the general and Z sweeps) and
their quadratic term to every replica's objective value.

The meta-optimizers (solver/meta.py) give ``optimize_compiled`` a
hyperparameter combo per replica (``hp_vectors``: theta, delta,
kappa_min, kappa_step, init_policy_random) and read back each replica's
best score. ``checkpoint_path`` saves the population every
``checkpoint_every`` seconds and resumes from it at start.

Under a process group (parallel/distributed.py: one process per card,
``torchrun`` or ``init_distributed``) each rank runs this optimizer on its
slice of the replica axis with its own random stream and its own full
population; the ranks meet once per chunk (the top-K population exchange,
the flip-counter sum, the host loop's stats and decisions) and, with the
``cycle`` order, once per step. A state over the device budget even at
128 replicas per rank shards the constraint rows instead
(parallel/rowshard.py).

Replica phases: ANNEAL (kappa-annealed feasibility run), PUSH (one
objective-amplified sweep), PUSH_ITER (recovery sweeps after a push, kappa
reset to kappa_start). A finished replica reports its result to the
population and is re-seeded in the same step via the kappa-improve ladder
or population crossover + mutation (reference: best_solution_recorder::
reinit, :528-554). P and pi persist across restarts.

A step never waits for the device: every per-step quantity (the schedule,
the row count, the order code, the tie-noise seed) stays on the device
(the general sweep walks every block of the order instead of reading the
row count),
and the host loop only fetches one small stats vector per chunk.

Deviations from the reference, on purpose:
- the row schedule is shared across replicas; the state-dependent ordering
  policies aggregate over replicas, and the `cycle` policy advances
  globally per step instead of per thread;
- push sweeps process every row.
"""

from __future__ import annotations

import os
import time
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from baryonyx_torch.checkpoint import load_population, save_population
from baryonyx_torch.core.context import Context
from baryonyx_torch.core.contracts import validate_replica_state
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
from baryonyx_torch.parallel.mesh import Mesh, make_mesh
from baryonyx_torch.parallel.rowshard import hbm_budget_bytes, optimize_row_sharded
from baryonyx_torch.ops import psweep as pw
from baryonyx_torch.ops import zsweep as zs
from baryonyx_torch.ops.layout import CompiledProblem, compile_problem
from baryonyx_torch.ops.sweep import sweep, violated_mask
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
EXCHANGE_K = 16  # population members each rank sends per chunk
# the ablation-study hooks of one_step (see _ablate)
ABLATE_TOKENS = frozenset({"compact", "value", "flips", "insert", "violw"})


def _ablate() -> frozenset:
    """The hooks that the comma-separated ``BARYONYX_ABLATE`` list names,
    matching each token exactly after stripping whitespace; other tokens
    are ignored. Each switches off one piece of the evolution step, for
    ablation studies only:

    - ``compact``: the scheduled rows are not compacted to the front of
      the order; the fused sweep walks every row block (``n_rows = m``);
    - ``value``: every replica's objective value is 0 (the quadratic term
      is still added);
    - ``flips``: the per-variable flip counter is not advanced;
    - ``insert``: no candidate enters the population (the victims are
      still drawn, so the random stream does not move);
    - ``violw``: restarting replicas keep the sweep's violated set.

    ``optimize_compiled`` reads it once, when it starts; ``one_step`` then
    reads ``EvolveInputs.ablate`` and never the environment."""
    v = os.environ.get("BARYONYX_ABLATE", "")
    return frozenset(t.strip() for t in v.split(",")) & ABLATE_TOKENS


class ReplicaState(NamedTuple):
    x: torch.Tensor  # int32[n, R]
    P: torch.Tensor  # f[m, Kr, R]
    pi: torch.Tensor  # f[m, R]
    S: torch.Tensor  # f[n, R] — carried merged column sums
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
    hp: dict  # hyperparameters: Python numbers; theta, delta, kappa_min
    # and kappa_step may be [R] tensors (one combo per replica)
    minimize: bool
    block_size: int
    order_policy: Optional[ConstraintOrder] = None
    random_solver: bool = False
    # quadratic objectives: the normalized factors per variable [n, Qmax]
    # (general and Z sweeps), the dense normalized [n, n] matrix (fused
    # sweep; None past pw.QUAD_DENSE_MAX_N) and the terms (qa, qb, factor)
    # of the objective value
    quad_fac: Optional[torch.Tensor] = None
    quad_mat: Optional[torch.Tensor] = None
    quad_terms: Optional[Tuple[torch.Tensor, torch.Tensor, torch.Tensor]] = None
    # the process group whose ranks share the replica axis (None: this
    # process runs every replica)
    mesh: Optional[Mesh] = None
    # the ablation hooks switched on (_ablate); empty in a real run
    ablate: frozenset = frozenset()


def fused_sweep_applies(
    cp: CompiledProblem, R: int, dtype, device, random_solver: bool
) -> bool:
    """Does a 0/1 or ±1 instance run the fused sweep (ops/psweep.py)? Not
    what it does not take (float64, the full sort, a replica count off a
    multiple of 32 on CUDA), and not the random solver: those run the
    general sweep (ops/sweep.py)."""
    return not random_solver and pw.supports(cp, R, dtype, device)


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

    if "compact" in ev.ablate:
        # every row block in make_order's order: the sentinel m stands
        # only past index m, so the fused sweep's m rows never reach it
        order2, padded = order, None
    else:
        # compact the scheduled rows (union over replicas) to the front
        # of the order; n_rows bounds the kernel's block loop on the
        # device. The sentinel m is never used as an index.
        sched_any = sched.any(dim=1)  # [m]
        padded = torch.cat([sched_any, sched_any.new_zeros(1)])[
            order.long().clamp(max=m)
        ]
        order2 = order[torch.argsort((~padded).to(torch.int8), stable=True)]

    if cp.has_z:
        if ev.random_solver:
            # the reference's dispatch has no random solver for Z problems
            # (itm.hpp:181-200 raises internal_error)
            raise NotImplementedError("random solver for Z problems")
        # the Z sweep walks every block (no row count read on the host)
        # and keeps no column sums across sweeps
        x, P, pi, viol, remaining = zs.z_sweep(
            cp, rs.x, rs.P, rs.pi, ev.cost_norm, sched, order2, kappa_eff,
            hp["delta"], hp["theta"], gen, amp, minimize=minimize,
            block_size=B, quad_fac=ev.quad_fac,
        )
        S = rs.S
    elif not (
        # the fused sweep reads quadratic costs from the dense matrix only
        (ev.quad_mat is not None or not cp.has_quad)
        and fused_sweep_applies(cp, R, dtype, dev, ev.random_solver)
    ):
        # the general sweep, over every block of the order (no row count
        # read on the host)
        x, P, pi, S, viol, remaining = sweep(
            cp, rs.x, rs.P, rs.pi, ev.cost_norm, sched, order2, kappa_eff,
            hp["delta"], hp["theta"], gen, amp, minimize=minimize,
            block_size=B, random_solver=ev.random_solver,
            quad_fac=ev.quad_fac, S=rs.S, S_fresh=(state.sweeps % 16) != 0,
        )
    else:
        n_rows = m if padded is None else padded.sum(dtype=torch.int32)
        seed = torch.randint(
            0, INT_MAX, (2,), generator=gen, device=dev, dtype=torch.int32
        )
        x, P, pi, S, viol, remaining = pw.psweep(
            cp, rs.x, rs.P, rs.pi, ev.cost_norm, sched, order2, kappa_eff,
            hp["delta"], hp["theta"], seed, amp, n_rows=n_rows,
            minimize=minimize, block_size=B, quad_mat=ev.quad_mat, S=rs.S,
            S_fresh=(state.sweeps % 16) != 0,
        )

    if "value" in ev.ablate:
        value = torch.zeros((R,), dtype=dtype, device=dev)
    else:
        value = ev.cost_orig @ x.to(dtype) + ev.cost_constant
    if ev.quad_terms is not None:
        value = value + quad_value(ev.quad_terms, x, dtype)
    found = remaining == 0  # [R]
    # per-variable instability: sweep-induced bit flips summed over
    # replicas (before any restart reseeding below)
    flips = state.flips
    if "flips" not in ev.ablate:
        flips = flips + (x != rs.x).to(torch.float32).sum(dim=1)
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
    # drawn under "insert" too, so the later draws stay where they are
    victims = draw_victims(gen, R, Psize, dev)
    pop = state.pop
    if "insert" not in ev.ablate:
        pop = batch_insert(
            pop, x.T, value, cand_remaining, cand_mask, victims,
            ev.hash_weights, minimize,
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

    # cycle advances globally when any replica pushed; over a process
    # group any() must agree across the ranks (the order code is shared)
    order_code = state.order_code
    if hp["use_cycle"]:
        any_push = is_push.any()
        if ev.mesh is not None:
            any_push = ev.mesh.all_reduce(any_push.to(torch.int32), "max") > 0
        order_code = torch.where(
            any_push, (order_code + 1) % common.N_CYCLE_STATES, order_code
        ).to(torch.int32)

    # restarting replicas recompute their violated set from the new x
    if "violw" not in ev.ablate:
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


def quad_value(quad_terms, x: torch.Tensor, dtype) -> torch.Tensor:
    """The objective's quadratic term for every replica: sum over terms
    q of f_q * x[a_q] * x[b_q]. x int32[n, R] → [R]. Transient: the two
    int32 [Q, R] gathers, their product and its cast."""
    qa, qb, qfv = quad_terms
    return qfv @ (x[qa] * x[qb]).to(dtype)


def evolve(ev: EvolveInputs, state: OptState, n_steps: int) -> OptState:
    """``n_steps`` evolution steps, then the per-chunk flip-counter decay
    (an exponential decay keeps it biased to recent instability).

    Over a process group the steps run on the rank's replica slice and
    population with no collective (but the ``cycle`` policy's); then the
    ranks sum their flip counts, and every rank's top-K members go to
    every rank's population (``exchange_top_k``)."""
    flips0 = state.flips
    for _ in range(n_steps):
        state = one_step(ev, state)
    # in-chunk accumulation stays linear so the ranks' counts sum exactly
    flip_delta = state.flips - flips0
    if ev.mesh is not None:
        flip_delta = ev.mesh.all_reduce(flip_delta, "sum")
    state = state._replace(flips=FLIP_DECAY * flips0 + flip_delta)
    if ev.mesh is not None:
        state = state._replace(pop=exchange_top_k(ev, state))
    return state


def exchange_top_k(ev: EvolveInputs, state: OptState) -> Population:
    """The once-per-chunk population exchange: every rank's best
    K = min(EXCHANGE_K, P) members (x, value, remaining) gathered in rank
    order, then inserted into this rank's population. This rank's own
    members fall to the hash dedup, so a one-rank group changes nothing.
    K·D of the population per chunk instead of R every step (the JAX
    package's round-2 design).

    The victims, one uniform draw per candidate among the worst 4/5 as in
    ``one_step`` (two candidates may draw one slot: the later one takes
    it), come from a generator seeded from this rank's stream and the
    step count, which leaves that stream where it was (as the JAX
    package's ``fold_in(key, 0x5EED)``)."""
    pop, mesh = state.pop, ev.mesh
    K = min(EXCHANGE_K, pop.x.shape[0])
    gx = mesh.all_gather(pop.x[:K])
    gv = mesh.all_gather(pop.value[:K])
    gr = mesh.all_gather(pop.remaining[:K])
    dev = pop.x.device
    g = torch.Generator(device=dev)
    g.manual_seed(
        (state.gen.initial_seed() * 0x5EED + state.sweeps * 0x9E3779B9)
        & ((1 << 63) - 1)
    )
    n_cand = gx.shape[0]
    victims = draw_victims(g, n_cand, pop.x.shape[0], dev)
    return batch_insert(
        pop, gx, gv, gr, torch.ones(n_cand, dtype=torch.bool, device=dev),
        victims, ev.hash_weights, ev.minimize,
    )


def default_replicas(
    params: SolverParameters, device: torch.device, n_ranks: int = 1
) -> int:
    """reference: get_thread_number (itm-optimizer-common.hpp:757-774) —
    thread <= 0 means auto: 512 replicas per rank on a CUDA device, 16 in
    all on the CPU (tests). The replica axis splits evenly over the
    ranks: the count rounds up to a multiple of ``n_ranks``."""
    if params.thread > 0:
        r = params.thread
    else:
        r = 512 * n_ranks if device.type == "cuda" else 16
    return -(-r // n_ranks) * n_ranks


def replica_batch(
    ctx: Context, cp: CompiledProblem, params: SolverParameters,
    device: torch.device, grow: bool = True, n_ranks: int = 1,
) -> Tuple[int, int]:
    """The replica batch R (over all ``n_ranks`` ranks) and the row block
    size the optimizer runs with: on CUDA each rank runs the largest of
    (2048, 4), (1024, 4), (1024, 8) the fused sweep takes (an explicit
    thread count or block size wins, and ``grow=False`` keeps
    ``default_replicas``: the meta-optimizers must predict R); Z
    instances, and those the general sweep runs, keep ``default_replicas``
    and the requested block size, as the JAX package does. Then R per
    rank is halved while the state overflows the device budget and stays
    above 128 (``optimize_compiled`` decides what happens past that)."""
    f64 = params.float_type == FloatType.float64
    dtype = torch.float64 if f64 else torch.float32
    R = default_replicas(params, device, n_ranks) // n_ranks
    block_size = params.block_size
    fused = not cp.has_z and fused_sweep_applies(
        cp, R, dtype, device, params.solver == SolverType.random
    )
    if fused and grow and params.thread <= 0 and device.type == "cuda":
        # grow the replica batch to the largest the fused sweep takes;
        # honor an explicit user block_size
        user_B = params.block_size != SolverParameters().block_size
        for cand_R, cand_B in ((2048, 4), (1024, 4), (1024, 8)):
            bs = params.block_size if user_B else cand_B
            if cand_R > R and pw.supports(cp, cand_R, dtype, device):
                R = cand_R
                block_size = bs
                break

    budget = hbm_budget_bytes(device)
    while state_peak_bytes(cp, R, params, device, block_size) > budget and R > 128:
        R //= 2
    return R * n_ranks, block_size


def state_peak_bytes(
    cp: CompiledProblem, R: int, params: SolverParameters,
    device: torch.device, block_size: int,
) -> int:
    """``estimated_peak_bytes`` of one rank's optimize state at R replicas,
    through the sweep ``one_step`` would pick."""
    f64 = params.float_type == FloatType.float64
    fused = not cp.has_z and fused_sweep_applies(
        cp, R, torch.float64 if f64 else torch.float32, device,
        params.solver == SolverType.random,
    )
    return estimated_peak_bytes(
        cp, R, itemsize=8 if f64 else 4, B=block_size,
        general_sweep=not fused and not cp.has_z,
    )


def _budget_loop(
    ctx: Context,
    params: SolverParameters,
    state: OptState,
    run_evolve,
    stats_fn,
    chunk: int,
    time_limit: float,
    sweep_budget: float,
    budget_t0: float,
    last_ckpt: float,
    bound_fn=None,
    probe_fn=None,
    diversify_fn=None,
    value_sign: float = 1.0,
    save_fn=None,
    fleet_fn=None,
) -> OptState:
    """The host-side chunk loop: run `chunk` evolve steps at a time until
    the wall-clock budget or the total sweep budget is exhausted
    (reference terminator: itm-optimizer-common.hpp:836-859). The chunk
    length adapts so each host round trip buys ~0.5 s of device work.
    After each chunk: the debug probe (``probe_fn``) and, every
    ``params.checkpoint_every`` seconds, the population checkpoint
    (``save_fn``). Ctrl-C returns the best population found so far.

    Over a process group every rank runs this loop, and the next
    collective hangs if one rank picks another chunk length or stops a
    chunk earlier. So each rank proposes its decisions (the next chunk
    length, a checkpoint, the end of the budget) from its own clock, and
    ``fleet_fn(stats, decisions)`` — the one collective of the per-chunk
    fetch — gives every rank the fleet's stats and rank 0's decisions;
    no other clock reading steers the loop."""
    best_lb = float("-inf")  # bound_fn orientation: higher is tighter
    best_seen = (np.inf, np.inf)  # (remaining, value) of the pool head
    stagnant = 0
    try:
        while True:
            t_chunk = time.monotonic()
            state = run_evolve(state, chunk)
            # one small fetch per chunk synchronizes with the device
            stats = stats_fn(state)
            now = time.monotonic()
            # sweep-budget mode (no time limit) keeps the chunk FIXED so
            # runs are reproducible
            next_chunk = chunk
            if time_limit != float("inf"):
                dt_chunk = now - t_chunk
                if dt_chunk < 0.35 and chunk < (1 << 14):
                    next_chunk = min(chunk * 4, 1 << 14)
                elif dt_chunk > 1.5 and chunk > 1:
                    next_chunk = max(chunk // 2, 1)
            decisions = (
                next_chunk,
                bool(params.checkpoint_path)
                and now - last_ckpt >= params.checkpoint_every,
                now - budget_t0 >= time_limit,
            )
            if fleet_fn is not None:
                stats, decisions = fleet_fn(stats, decisions)
            chunk, ckpt_due, out_of_time = decisions
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
            if probe_fn is not None:
                # --debug: device-state invariants per chunk
                # (reference: bx_assert layer, debug.hpp:75-117)
                validate_replica_state(probe_fn(state), "optimize chunk")
            if ckpt_due:
                save_fn(state)
                last_ckpt = time.monotonic()
            if out_of_time or float(stats[2]) >= sweep_budget:
                break
    except KeyboardInterrupt:
        ctx.notice("optimize: interrupted; returning best population\n")
    return state


def fleet_stats(mesh: Mesh, stats: np.ndarray, decisions, value_sign: float):
    """The host loop's per-chunk collective over a process group: every
    rank's [best remaining, best value, sweeps, restarts] and decisions in
    one all-gather. Returns the fleet's stats (its best (remaining, value)
    member, the sweeps, the restarts summed) and rank 0's decisions."""
    row = np.concatenate([stats, np.asarray(decisions, np.float64)])
    rows = mesh.all_gather(
        torch.as_tensor(row[None, :], dtype=torch.float64, device=mesh.device)
    ).cpu().numpy()
    best = min(
        range(len(rows)), key=lambda d: (rows[d, 0], value_sign * rows[d, 1])
    )
    fleet = np.array([rows[best, 0], rows[best, 1], rows[0, 2], rows[:, 3].sum()])
    chunk, ckpt_due, out_of_time = rows[0, 4:7]
    return fleet, (int(chunk), bool(ckpt_due), bool(out_of_time))


def optimize_compiled(
    ctx: Context, pb: Problem, device: DeviceLike = None,
    hp_vectors: Optional[dict] = None,
) -> Result:
    """reference: optimize_problem (itm-optimizer-common.hpp:776-908), on
    one device (CUDA unless ``device="cpu"``).

    ``hp_vectors`` (solver/meta.py): optional per-replica hyperparameter
    vectors — keys among {"theta", "delta", "kappa_min", "kappa_step",
    "init_policy_random"}, each a 1-D array of any length C; entries tile
    cyclically onto the R replicas (replica r runs combo r % C), and R is
    not grown past ``default_replicas``. The returned Result then carries
    ``replica_best_values`` (minimize-oriented [R] scores, +inf = that
    replica never found a feasible x) so the caller can score combos."""
    t0 = time.monotonic()
    dev = resolve_device(device)
    params = ctx.parameters
    minimize = pb.type == ObjectiveType.minimize
    f64 = params.float_type == FloatType.float64
    dtype = torch.float64 if f64 else torch.float32
    use_random = params.solver == SolverType.random
    # the ablation hooks, read once per run; the ranks of a process group
    # must all see the same value (torchrun gives them one environment)
    ablate = _ablate()
    if os.environ.get("BARYONYX_ABLATE"):
        # a leftover ablation flag silently corrupts real solves ("value"
        # zeroes the objective while the status still reports success)
        ctx.warning(
            "BARYONYX_ABLATE={} is set: this run executes ABLATED solver "
            "steps (results are for ablation studies only). The flag is "
            "read at the start of each optimize run.\n",
            os.environ["BARYONYX_ABLATE"],
        )

    ret = Result(method="optimize")
    n = len(pb.vars.values)
    constraints = make_merged_constraints(ctx, pb)

    if not constraints or n == 0:
        ret.status = ResultStatus.success
        ret.solutions.append(Solution([], pb.objective.value))
        common.finalize(ret, pb, len(constraints), t0)
        return ret

    # observer/debug runs want the real loop's trace; the --random
    # baseline must stay random; a hyperparameter sweep must run its combos
    if (
        hp_vectors is None
        and not use_random
        and params.observer == ObserverType.none
        and not params.debug
    ):
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

    # under a process group this rank runs a slice of the replicas with
    # a random stream of its own; the host's numpy draws (the population,
    # the replicas' starts, the row route's lanes) are the same on every
    # rank, so every rank takes rank 0's seed (the automatic one is each
    # rank's own clock)
    mesh = make_mesh(device=dev) if dist.is_initialized() else None
    n_ranks = mesh.size if mesh is not None else 1
    seed = params.seed if params.seed else int(time.time())
    if mesh is not None:
        seed = mesh.from_rank0(seed)
    rng = np.random.default_rng(seed)
    gen = torch.Generator(device=dev)
    gen.manual_seed(mesh.seed(seed) if mesh is not None else seed)

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
    if cp.has_z and use_random:
        raise NotImplementedError("random solver for Z problems")
    cost_orig_real = common.build_cost_vector(pb, n)
    quad_fac_norm = None
    if cp.has_quad:
        cost_norm_real, q_norm = common.normalize_costs_quad(
            cost_orig_real,
            cp.quad_fac.cpu().numpy().astype(np.float64),
            params.cost_norm,
            rng,
        )
        quad_fac_norm = torch.as_tensor(q_norm, dtype=dtype, device=dev)
    else:
        cost_norm_real = common.normalize_costs(
            cost_orig_real, params.cost_norm, rng
        )
    pad = cp.n - n
    cost_orig = np.pad(cost_orig_real, (0, pad))
    cost_norm = np.pad(cost_norm_real, (0, pad))

    R, block_size = replica_batch(
        ctx, cp, params, dev, grow=hp_vectors is None, n_ranks=n_ranks
    )
    R_local = R // n_ranks
    # past the device budget at 128 replicas per rank, shard the
    # constraint rows over the ranks (0/1 and ±1 rows, linear costs);
    # otherwise say so and go on
    budget = hbm_budget_bytes(dev)
    peak = state_peak_bytes(cp, R_local, params, dev, block_size)
    if peak > budget:
        if n_ranks > 1 and not cp.has_z and not cp.has_quad:
            ctx.warning(
                "replicated state ({} per card at R={}) exceeds the device "
                "budget ({}); sharding constraint rows across {} ranks\n",
                peak, R, budget, n_ranks,
            )
            return _optimize_by_rows(
                ctx, pb, constraints, n, cost_norm_real, cost_orig_real,
                minimize, mesh, rng, ret, t0,
            )
        ctx.warning(
            "replicated optimize state exceeds the device memory budget "
            "and row sharding does not apply here (single device, or "
            "Z/quadratic rows); proceeding — the runtime may OOM\n"
        )
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
    qel = pb.objective.qelements
    _qa = np.array([q.variable_index_a for q in qel], np.int64)
    _qb = np.array([q.variable_index_b for q in qel], np.int64)
    _qf = np.array([q.factor for q in qel], np.float64)

    def evaluate(x: np.ndarray):
        xf = x[:n].astype(np.float64)
        value = float(cost_orig_real @ xf) + pb.objective.value
        if len(_qf):
            value += float(_qf @ (xf[_qa] * xf[_qb]))
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

    if params.checkpoint_path and os.path.exists(params.checkpoint_path):
        try:
            pop, pop_x = _resumed_population(
                params.checkpoint_path, pop, P_size, minimize, dtype, dev
            )
            ctx.notice("- resumed population from {}\n", params.checkpoint_path)
        except (OSError, KeyError, ValueError) as e:
            # a corrupted or foreign checkpoint: start fresh
            ctx.warning("- checkpoint load failed: {}\n", e)

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
        # rounded to the solver's type, as the sweep computes with it
        return float(v) if f64 else float(np.float32(v))

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

    quad_mat = quad_terms = None
    if cp.has_quad:
        if cp.n > pw.QUAD_DENSE_MAX_N:
            # the fused sweep's dense CQ would need an n x n matrix; past
            # the limit the general sweep's per-slot gathers take the
            # quadratic costs: correct, much slower
            ctx.warning(
                "quadratic objective with {} variables exceeds the fused "
                "kernel's {}-variable dense limit; using the (slower) "
                "unfused sweep\n",
                cp.n,
                pw.QUAD_DENSE_MAX_N,
            )
        else:
            quad_mat = dense_quad_matrix(cp, quad_fac_norm)
        quad_terms = (
            torch.as_tensor(_qa, device=dev),
            torch.as_tensor(_qb, device=dev),
            torch.as_tensor(_qf, dtype=dtype, device=dev),
        )

    # the host draws below cover all R replicas, the same on every rank;
    # the card gets only this rank's slice of them
    sl = mesh.replica_range(R) if mesh is not None else slice(None)

    # per-replica hyperparameter sweep axis (see docstring): combos tile
    # cyclically onto the replicas
    hp_r: dict = {}
    if hp_vectors:
        allowed = ("theta", "delta", "kappa_min", "kappa_step",
                   "init_policy_random")
        for k, v in hp_vectors.items():
            if k not in allowed:
                raise ValueError(f"hp_vectors key {k!r} not sweepable")
            hp_r[k] = np.resize(np.asarray(v, np.float64), R)
        for k in ("theta", "delta", "kappa_min", "kappa_step"):
            if k in hp_r:
                # rounded to the solver's type, as the sweep computes with it
                hp[k] = torch.as_tensor(hp_r[k][sl], dtype=dtype, device=dev)

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
    if "init_policy_random" in hp_r:
        # per-replica init policy: probability of a Bernoulli(0.5) start
        # instead of the population/zero start (reference semantics of
        # init_policy_random, itm-common.hpp:269-282)
        use_rand = rng.random(R) < hp_r["init_policy_random"]
        rand_x = (rng.random((R, cp.n)) < 0.5).astype(np.int32)
        rand_x[:, n:] = 0
        x0_np = np.where(use_rand[:, None], rand_x, x0_np)
    x0 = torch.as_tensor(x0_np[sl].T.copy(), device=dev)  # int32[n, R_local]
    # first ladder rung (reference reinit's first call bumps kappa_append
    # before the first inner run), from each replica's kappa_min
    append0 = params.init_kappa_improve_start + params.init_kappa_improve_increase
    kmin0 = hp_r["kappa_min"][sl] if "kappa_min" in hp_r else params.kappa_min
    kappa0 = kmin0 + (params.kappa_max - kmin0) * (
        append0 if append0 < params.init_kappa_improve_stop else 0.0
    )
    order_code = common.ORDER_CODES.get(params.order, 0)

    def full(v, dt):
        return torch.as_tensor(v, dtype=dt, device=dev).expand(R_local).contiguous()

    def zeros(*shape):
        return torch.zeros(shape, dtype=dtype, device=dev)

    rs = ReplicaState(
        x=x0,
        P=zeros(cp.m, cp.Kr, R_local),
        pi=zeros(cp.m, R_local),
        S=zeros(cp.n, R_local),
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
        random_solver=use_random,
        quad_fac=quad_fac_norm,
        quad_mat=quad_mat,
        quad_terms=quad_terms,
        mesh=mesh,
        ablate=ablate,
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

    last_ckpt = time.monotonic()
    # the kernels build at first use: keep that out of the time budget
    if dev.type == "cuda":
        if cp.has_z:
            if cp.Wdp:
                zs.dp_select_kernel.load()
        elif fused_sweep_applies(cp, R_local, dtype, dev, use_random):
            pw.psweep_kernel.load()
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
        if quad_terms is not None:
            value = value + quad_value(quad_terms, newx.T, dtype)
        rem = violated_mask(cp, newx.T).sum(dim=0, dtype=torch.int32)
        pop2 = sort_population(
            Population(x=newx, value=value, remaining=rem, hash=hash_x(newx, hw)),
            minimize,
        )
        return st._replace(pop=pop2)

    # the cataclysm, the debug probe and the dual-bound print run on one
    # process only, as in the JAX package: over a process group the
    # population and the replicas are the ranks' own
    probe_fn = None
    if params.debug and mesh is None:
        def probe_fn(st: OptState) -> dict:
            rs = st.replicas
            probe = torch.stack([
                rs.pi.abs().max().to(torch.float64),
                rs.P.abs().max().to(torch.float64),
                rs.x.min().to(torch.float64),
                rs.x.max().to(torch.float64),
                rs.kappa.max().to(torch.float64),
                rs.viol.sum(dim=0).min().to(torch.float64),
            ]).cpu().numpy()
            keys = ("pi_absmax", "P_absmax", "x_min", "x_max", "kappa_max",
                    "remaining_min")
            return dict(zip(keys, probe), m=cp.m_real)

    bound_fn = None
    if params.print_level > 0 and mesh is None:
        def bound_fn(st):
            lb = common.dual_bound(
                cp, st.replicas.pi[:, 0].cpu().numpy(), cost_norm, minimize
            )
            # second element: tightness score (higher = tighter)
            return lb, (lb if minimize else -lb)

    value_sign = 1.0 if minimize else -1.0

    def save_fn(st: OptState) -> None:
        # over a process group: the ranks' populations side by side
        # ([D·P, n], the JAX package's layout), written by rank 0
        pop_st = st.pop
        if mesh is not None:
            pop_st = Population(*[mesh.all_gather(t) for t in st.pop])
            if mesh.rank != 0:
                return
        save_population(params.checkpoint_path, pop_st)

    fleet_fn = None
    if mesh is not None:
        def fleet_fn(stats, decisions):
            return fleet_stats(mesh, stats, decisions, value_sign)

    state = _budget_loop(
        ctx, params, state, lambda st, k: evolve(ev, st, k), stats_fn, chunk,
        time_limit, sweep_budget, budget_t0, last_ckpt, bound_fn=bound_fn,
        probe_fn=probe_fn, diversify_fn=diversify if mesh is None else None,
        value_sign=value_sign, save_fn=save_fn, fleet_fn=fleet_fn,
    )

    # extraction (reference: :869-900); best LAST to match Result.best
    pop = state.pop
    if mesh is not None:
        # every rank's population, re-sorted as one on the host: every
        # rank returns the same Result
        g = [mesh.all_gather(t).cpu() for t in pop]
        idx = np.lexsort((value_sign * g[1].double().numpy(), g[2].numpy()))
        pop = Population(*[t[torch.as_tensor(idx)] for t in g])
    rem0 = int(pop.remaining[0])
    if rem0 == 0:
        ret.status = ResultStatus.success
    elif params.time_limit > 0:
        ret.status = ResultStatus.time_limit_reached
    else:
        ret.status = ResultStatus.limit_reached
    ret.remaining_constraints = rem0
    ret.loop = state.sweeps
    # the per-chunk sum leaves every rank the same flip counts
    fl = state.flips[:n].cpu().numpy()
    if fl.size and fl.max() > 0:
        ret.annoying_variable = int(np.argmax(fl))
    if hp_vectors is not None:
        # per-replica quality readout for the meta-optimizers
        best_values = state.replicas.best_value
        if mesh is not None:  # in replica order: rank by rank
            best_values = mesh.all_gather(best_values)
        ret.replica_best_values = best_values.cpu().numpy().astype(np.float64)

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


def _optimize_by_rows(
    ctx: Context, pb: Problem, constraints, n: int,
    cost_norm: np.ndarray, cost_orig: np.ndarray, minimize: bool,
    mesh: Mesh, rng: np.random.Generator, ret: Result, t0: float,
) -> Result:
    """``optimize_compiled``'s end on the row-sharded route
    (parallel/rowshard.py), its Result marked ``+rowshard``."""
    params = ctx.parameters
    x, rem, value, sweeps, _restarts = optimize_row_sharded(
        ctx, constraints, n, cost_norm, cost_orig,
        float(pb.objective.value), minimize, mesh, params, rng,
    )
    ret.method += "+rowshard"
    ret.loop = sweeps
    ret.remaining_constraints = int(rem)
    if rem == 0:
        ret.status = ResultStatus.success
        ret.solutions.append(Solution([int(v) for v in x], float(value)))
    else:
        ret.status = (
            ResultStatus.time_limit_reached
            if params.time_limit > 0
            else ResultStatus.limit_reached
        )
        ret.solutions.append(
            Solution(
                [int(v) for v in x], float("inf") if minimize else float("-inf")
            )
        )
    common.finalize(ret, pb, len(constraints), t0)
    if ctx.finish_cb:
        ctx.finish_cb(ret)
    return ret


def dense_quad_matrix(
    cp: CompiledProblem, quad_fac_norm: torch.Tensor
) -> torch.Tensor:
    """The dense normalized neighbor matrix [n, n] of the fused sweep's
    CQ = quad_mat @ x: entry (j, k) sums the normalized factors of j's
    neighbor k (the diagonal holds square terms), accumulated in float64
    on the host from the factors as the solver's type holds them, then
    cast to it."""
    qm = cp.quad_mask.cpu().numpy()
    qv = cp.quad_var.cpu().numpy()
    qf = quad_fac_norm.cpu().numpy().astype(np.float64)
    dq = np.zeros((cp.n, cp.n))
    jj = np.repeat(np.arange(cp.n), qm.shape[1]).reshape(qm.shape)
    np.add.at(dq, (jj[qm], qv[qm]), qf[qm])
    return torch.as_tensor(dq, dtype=quad_fac_norm.dtype, device=quad_fac_norm.device)


def _resumed_population(
    path: str, pop: Population, P_size: int, minimize: bool, dtype, dev
) -> Tuple[Population, np.ndarray]:
    """The population saved at ``path`` in place of ``pop``, sorted, and
    its x on the host; ``pop`` itself where the file's shape does not
    fit. A file of a multi-device run ([D·P, n]) keeps its best P."""
    saved = load_population(path)
    sx, sv = saved.x.numpy(), saved.value.numpy().astype(np.float64)
    sr, sh = saved.remaining.numpy(), saved.hash.numpy()
    if (
        sx.ndim == 2
        and sx.shape[1] == pop.x.shape[1]
        and sx.shape[0] > pop.x.shape[0]
        and sx.shape[0] % pop.x.shape[0] == 0
    ):
        sidx = np.lexsort((sv if minimize else -sv, sr))[:P_size]
        sx, sv, sr, sh = sx[sidx], sv[sidx], sr[sidx], sh[sidx]
    if sx.shape != tuple(pop.x.shape):
        raise ValueError(
            f"checkpoint population {sx.shape} does not fit {tuple(pop.x.shape)}"
        )
    pop = sort_population(
        Population(
            x=torch.as_tensor(sx, dtype=torch.int32, device=dev),
            value=torch.as_tensor(sv, dtype=dtype, device=dev),
            remaining=torch.as_tensor(sr, dtype=torch.int32, device=dev),
            hash=torch.as_tensor(sh, dtype=torch.int64, device=dev),
        ),
        minimize,
    )
    return pop, pop.x.cpu().numpy()
