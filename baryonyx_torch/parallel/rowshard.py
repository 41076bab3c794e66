"""Constraint (row) sharding: the problem itself split across ranks.

The reference never shards the problem — every thread owns the full
matrix; this route is for instances whose replicated state P [m, Kr, R]
overflows one card: the rows (constraints) split over the ranks, so P
[m, Kr, R] and pi [m, R] shard on the row axis while x [n, R] is the same
on every rank.

One sweep (``sweep_row_sharded``):
  - each rank runs the general sweep (ops/sweep.py) over ITS rows, from
    column sums of its own rows' prices, with tie noise from its own
    random stream — decisions see sweep-entry prices for the other
    shards' rows (shard-level Jacobi, as the row blocks of a sweep);
  - x merges by flip-union: a variable flipped by any shard takes the
    flipped value (binary variables make opposing flips identical, so
    the rule is deterministic and order-free) — one sum of the int32
    flips [n, R] over the ranks;
  - the violated rows of the merged x count with one more sum of [R].

Shards compile with identical padded shapes (short ones padded with
never-violated dummy rows, bounds [0, 1]) and come back stacked, every
tensor with a leading [D] shard axis; each rank keeps its own
(``shard_of``) and runs the single-card sweep on it unchanged.

Scope: 0/1 and ±1 rows, linear costs (Z rows and quadratic objectives
keep the replicated path). Feasibility and objective checks run on the
merged x, so the route is exact about *what* it accepts; only the sweep
trajectory differs.

The host loop (``solve_row_sharded``, ``optimize_row_sharded``) runs on
every rank with the same numpy draws (the same seed everywhere), so x
stays the same on every rank; the time-limit stop is rank 0's, shared.
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import List, Optional, Tuple

import numpy as np
import torch

from baryonyx_torch.device import DeviceLike, resolve_device
from baryonyx_torch.memory import device_budget_bytes
from baryonyx_torch.ops.layout import CompiledProblem, compile_problem
from baryonyx_torch.ops.sweep import SweepNoise, sweep, violated_mask
from baryonyx_torch.preprocess.merge import MergedConstraint

CPU_BUDGET_BYTES = 12 << 30  # the budget where no device reports one


def compile_row_shards(
    constraints: List[MergedConstraint],
    n_variables: int,
    n_shards: int,
    dtype=torch.float32,
    device: DeviceLike = None,
) -> CompiledProblem:
    """Split the constraints into ``n_shards`` row groups of ceil(m / D)
    and compile each with the same padded shapes; returns one stacked
    CompiledProblem whose tensors have a leading [D] shard axis."""
    m = len(constraints)
    per = (m + n_shards - 1) // n_shards
    groups: List[List[MergedConstraint]] = []
    for d in range(n_shards):
        grp = list(constraints[d * per : (d + 1) * per])
        while len(grp) < per:
            # never-violated single-element dummy row (bounds [0, 1] hold
            # for any binary assignment) pads short shards to ``per``
            grp.append(
                MergedConstraint(
                    elements=[type(constraints[0].elements[0])(1, 0)],
                    min=0,
                    max=1,
                    id=-1,
                )
            )
        groups.append(grp)
    # two passes: each shard's own buckets, then all recompiled at the
    # shared maxima so the stacked tensors agree in shape
    probe = [
        compile_problem(g, n_variables, dtype=dtype, device="cpu")
        for g in groups
    ]
    mm = max(c.m for c in probe)
    kr = max(c.Kr for c in probe)
    kc = max(c.Kc for c in probe)
    cps = [
        compile_problem(
            g, n_variables, dtype=dtype, min_m=mm, min_kr=kr, min_kc=kc,
            device=device,
        )
        for g in groups
    ]
    c0 = cps[0]
    for c in cps[1:]:
        assert (c.m, c.n, c.Kr, c.Kc) == (c0.m, c0.n, c0.Kr, c0.Kc)
    stacked = {
        name: torch.stack([getattr(c, name) for c in cps])
        for name in c0.tensor_fields()
    }
    # the selection's static analysis must hold for EVERY shard at once
    # (the sweep's parameters are shared)
    return dataclasses.replace(
        c0,
        **stacked,
        J_bot=max(c.J_bot for c in cps),
        J_top=max(c.J_top for c in cps),
        sel_reduction_ok=all(c.sel_reduction_ok for c in cps),
        all_unit_pos=all(c.all_unit_pos for c in cps),
    )


def shard_of(cp_stacked: CompiledProblem, d: int) -> CompiledProblem:
    """Shard ``d`` of a stacked CompiledProblem, as a plain one."""
    return dataclasses.replace(
        cp_stacked,
        **{name: getattr(cp_stacked, name)[d] for name in cp_stacked.tensor_fields()},
    )


def sweep_row_sharded(
    cp: CompiledProblem,  # this rank's shard
    x: torch.Tensor,  # int32[n, R], the same on every rank
    P: torch.Tensor,  # f[m_loc, Kr, R] (updated in place)
    pi: torch.Tensor,  # f[m_loc, R] (updated in place)
    cost: torch.Tensor,  # f[n]
    kappa,  # f[R] or scalar
    delta,
    theta,
    gen: Optional[torch.Generator],  # this rank's tie-noise stream
    mesh=None,  # parallel.mesh.Mesh; None: one shard
    minimize: bool = True,
    block_size: int = 8,
    noise: Optional[SweepNoise] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """One row-sharded sweep: the general sweep over this rank's violated
    rows in row order, x merged by flip-union, the merged x's violated
    rows counted over every shard. Returns (x, P, pi, remaining [R])."""
    m_loc = cp.m
    R = pi.shape[-1]
    B = block_size
    mp = -(-m_loc // B) * B
    dev = P.device
    viol = violated_mask(cp, x)
    order = torch.cat([
        torch.arange(m_loc, dtype=torch.int32, device=dev),
        torch.full((mp - m_loc,), m_loc, dtype=torch.int32, device=dev),
    ])
    x2, P, pi, _, _, _ = sweep(
        cp, x, P, pi, cost, viol, order, kappa, delta, theta, gen,
        torch.zeros(R, dtype=P.dtype, device=dev), minimize=minimize,
        block_size=B, noise=noise,
    )
    # flip-union merge: binary variables make opposing flips equal
    flips = (x2 != x).to(torch.int32)
    if mesh is not None:
        flips = mesh.all_reduce(flips, "sum")
    x_m = torch.where(flips > 0, 1 - x, x)
    # the dummy padding rows need no mask: one +1 element with bounds
    # [0, 1], which no binary assignment violates
    rem = violated_mask(cp, x_m).sum(dim=0, dtype=torch.int32)
    if mesh is not None:
        rem = mesh.all_reduce(rem, "sum")
    return x_m, P, pi, rem


def _setup(constraints, n, mesh, device, R):
    """This rank's shard on its device, and zero x, P, pi."""
    rank, D = (0, 1) if mesh is None else (mesh.rank, mesh.size)
    dev = mesh.device if mesh is not None else resolve_device(device)
    cp = shard_of(compile_row_shards(constraints, n, D, device="cpu"), rank).to(dev)
    x = torch.zeros((cp.n, R), dtype=torch.int32, device=dev)
    P = torch.zeros((cp.m, cp.Kr, R), device=dev)
    pi = torch.zeros((cp.m, R), device=dev)
    return cp, dev, x, P, pi


def _generator(dev, mesh, seed: int) -> torch.Generator:
    gen = torch.Generator(device=dev)
    gen.manual_seed(mesh.seed(seed) if mesh is not None else seed)
    return gen


def _rank0_says(mesh, flag: bool) -> bool:
    """Rank 0's ``flag``, on every rank."""
    return flag if mesh is None else bool(mesh.from_rank0(int(flag)))


def solve_row_sharded(
    constraints: List[MergedConstraint],
    n: int,
    cost_norm: np.ndarray,
    minimize: bool,
    mesh=None,
    R: int = 16,
    sweeps: int = 200,
    kappa_min: float = 0.0,
    kappa_step: float = 1e-3,
    kappa_max: float = 0.6,
    delta: float = 0.01,
    theta: float = 0.5,
    w: int = 10,
    alpha: float = 1.0,
    seed: int = 0,
    device: DeviceLike = None,
) -> Tuple[np.ndarray, int]:
    """A minimal annealed feasibility loop over the row-sharded sweep:
    returns (best x [n], best remaining)."""
    cp, dev, x, P, pi = _setup(constraints, n, mesh, device, R)
    gen = _generator(dev, mesh, seed)
    cost = torch.as_tensor(
        np.pad(cost_norm, (0, cp.n - len(cost_norm))), dtype=torch.float32,
        device=dev,
    )
    m_real = len(constraints)
    kappa = np.full(R, kappa_min, np.float32)
    best_rem = m_real + 1
    best_x = np.zeros(n, np.int32)
    for i in range(sweeps):
        x, P, pi, rem = sweep_row_sharded(
            cp, x, P, pi, cost, torch.as_tensor(kappa, device=dev),
            np.float32(delta), np.float32(theta), gen, mesh=mesh,
            minimize=minimize,
        )
        rem_np = rem.cpu().numpy()
        r0 = int(rem_np.min())
        if r0 < best_rem:
            best_rem = r0
            best_x = x[:n, int(rem_np.argmin())].cpu().numpy()
            if best_rem == 0:
                break
        if i > w:
            kappa = (
                kappa + kappa_step * (rem_np / max(m_real, 1)).astype(np.float32) ** alpha
            ).astype(np.float32)
            if float(kappa.max()) > kappa_max:
                break
    return best_x, best_rem


def hbm_budget_bytes(device: DeviceLike = None) -> int:
    """Per-card budget for the replicated optimize state.
    ``BARYONYX_HBM_BUDGET`` overrides it on every device, the CPU included
    (the tests force tiny budgets to take the row route); otherwise three
    quarters of a CUDA card's memory, and 12 GiB on the CPU."""
    env = os.environ.get("BARYONYX_HBM_BUDGET")
    if env:
        return int(float(env))
    dev = resolve_device(device) if device is not None else torch.device("cpu")
    budget = device_budget_bytes(dev)
    return CPU_BUDGET_BYTES if budget is None else budget


def optimize_row_sharded(
    ctx,
    constraints: List[MergedConstraint],
    n: int,
    cost_norm: np.ndarray,
    cost_orig: np.ndarray,
    cost_constant: float,
    minimize: bool,
    mesh,
    params,
    rng: np.random.Generator,
) -> Tuple[np.ndarray, int, float, int, int]:
    """Multi-start optimize over the row-sharded sweep, for instances whose
    replicated P [m, Kr, R] overflows one card.

    The population and restart machinery runs on the host on the merged x
    (the cards hold only the sharded sweep state): per-lane kappa
    annealing, kappa-ladder / crossover / mutation restarts against a host
    population with hash dedup — the replicated optimizer's restart
    semantics (solver/optimize.py), at host-loop granularity.

    Returns (best_x [n], best_remaining, best_value, sweeps, restarts)."""
    R = max(8, min(64, int(params.thread) if params.thread > 0 else 16))
    cp, dev, x, P_rows, pi = _setup(constraints, n, mesh, None, R)
    n_pad = cp.n
    m_real = len(constraints)
    t_end = time.monotonic() + (
        params.time_limit if params.time_limit > 0 else 10.0
    )
    cost_d = torch.as_tensor(
        np.pad(cost_norm, (0, n_pad - len(cost_norm))), dtype=torch.float32,
        device=dev,
    )
    cost_orig = np.asarray(cost_orig)
    delta = np.float32(params.delta if params.delta > 0 else 0.01)
    theta = np.float32(params.theta)

    # host-side init: bastert + random lanes (reference init policies,
    # itm-common.hpp:255-282)
    bastert = (cost_orig < 0 if minimize else cost_orig > 0).astype(np.int32)
    x_h = np.zeros((n_pad, R), np.int32)
    for r in range(R):
        if r % 2 == 0:
            mut = rng.random(n) < (0.1 + 0.8 * r / max(R - 1, 1))
            x_h[:n, r] = np.where(mut, rng.integers(0, 2, n), bastert)
        else:
            x_h[:n, r] = rng.integers(0, 2, n)
    x = torch.as_tensor(x_h, device=dev)

    kappa = np.full(R, params.kappa_min, np.float32)
    ladder = np.full(R, params.init_kappa_improve_start, np.float32)
    sweeps_in_restart = np.zeros(R, np.int32)

    # host population: (remaining, value, x) with hash dedup
    K = min(64, max(8, params.init_population_size))
    pop: List[Tuple[int, float, bytes]] = []

    def pop_insert(rem: int, val: float, xv: np.ndarray) -> None:
        key_b = xv.tobytes()
        for _rem, _val, p_x in pop:
            if p_x == key_b:
                return
        pop.append((rem, val if minimize else -val, key_b))
        pop.sort(key=lambda t: (t[0], t[1]))
        del pop[K:]

    best_rem, best_val = m_real + 1, np.inf
    best_x = np.zeros(n, np.int32)
    sweeps = restarts = 0
    gen = _generator(dev, mesh, params.seed if params.seed else 1)

    while _rank0_says(mesh, time.monotonic() < t_end):
        x, P_rows, pi, rem = sweep_row_sharded(
            cp, x, P_rows, pi, cost_d, torch.as_tensor(kappa, device=dev),
            delta, theta, gen, mesh=mesh, minimize=minimize,
        )
        sweeps += 1
        sweeps_in_restart += 1
        rem_np = rem.cpu().numpy()

        feas = np.flatnonzero(rem_np == 0)
        x_np = None
        if feas.size:
            x_np = x[:n].cpu().numpy()
            for lane in feas:
                xv = x_np[:, lane]
                val = float(cost_orig @ xv) + cost_constant
                pop_insert(0, val, xv.astype(np.int32))
                better = (val < best_val) if minimize else (val > best_val)
                if best_rem > 0 or better:
                    best_rem, best_val, best_x = 0, val, xv.copy()
        r0 = int(rem_np.min())
        if r0 < best_rem:
            best_rem = r0
            if x_np is None:
                x_np = x[:n].cpu().numpy()
            best_x = x_np[:, int(rem_np.argmin())].copy()

        # kappa anneal after warmup w (reference: itm-solver-common:152)
        warm = sweeps_in_restart > max(int(params.w), 1)
        kappa = np.where(
            warm,
            kappa + params.kappa_step
            * (rem_np / max(m_real, 1)) ** params.alpha,
            kappa,
        ).astype(np.float32)

        # restart lanes: feasible (reported) or kappa exhausted
        lanes = np.flatnonzero((rem_np == 0) | (kappa > params.kappa_max))
        if lanes.size:
            restarts += len(lanes)
            if x_np is None:
                x_np = x[:n].cpu().numpy()
            newx = np.zeros((n_pad, len(lanes)), np.int32)
            for j, lane in enumerate(lanes):
                if pop and ladder[lane] >= params.init_kappa_improve_stop:
                    # crossover of two population members + mutation
                    i1, i2 = rng.integers(0, len(pop), 2)
                    a = np.frombuffer(pop[i1][2], np.int32)
                    b = np.frombuffer(pop[i2][2], np.int32)
                    child = np.where(rng.random(n) < 0.5, a, b)
                    mut = rng.random(n) < 0.05
                    newx[:n, j] = np.where(mut, rng.integers(0, 2, n), child)
                else:
                    # kappa-improve ladder keeps x, bumps restart kappa
                    ladder[lane] = min(
                        ladder[lane] + params.init_kappa_improve_increase, 1.0
                    )
                    newx[:n, j] = x_np[:, lane]
            kappa[lanes] = params.kappa_min + (
                params.kappa_max - params.kappa_min
            ) * np.minimum(ladder[lanes], params.init_kappa_improve_stop)
            sweeps_in_restart[lanes] = 0
            lanes_d = torch.as_tensor(lanes, device=dev)
            x[:, lanes_d] = torch.as_tensor(newx, device=dev)
            # reset the restarted lanes' dual state (P, pi columns)
            keep = np.ones(R, np.float32)
            keep[lanes] = 0.0
            keep_d = torch.as_tensor(keep, device=dev)
            P_rows = P_rows * keep_d
            pi = pi * keep_d

    return best_x, best_rem, best_val, sweeps, restarts
