"""The top-K population exchange between ranks, worked out again: every
rank's best K members (in rank order) are candidates; each draws one
victim slot uniformly among the worst 4/5 of this rank's population, from
a generator seeded from this rank's stream seed and the step count; a
candidate whose x is already in the population is dropped (x over the
program's variables: the columns past them are padding); where two
candidates draw one slot the later one takes it. The population after
the exchange is compared as a multiset of (x, remaining) rows."""

from __future__ import annotations

from collections import Counter
from typing import List, Tuple

import torch

EXCHANGE_K = 16


def _key(row: torch.Tensor, n: int) -> bytes:
    return bytes(row[:n].numpy().astype("int8").tobytes())


def _rows(x: torch.Tensor, remaining: torch.Tensor, n: int) -> Counter:
    return Counter((_key(r, n), int(q)) for r, q in zip(x, remaining))


def exchanged(before: List[dict], rank: int, n: int, device) -> Tuple[Counter, int]:
    """The population of ``rank`` after the exchange, and how many
    candidates it took. ``before``: each rank's record: population x
    [P, n], remaining [P] (best first), its stream's initial seed and its
    step count; ``n``: the program's variables."""
    own = before[rank]
    x, rem = own["x"].clone(), own["remaining"].clone()
    pop_size = x.shape[0]
    K = min(EXCHANGE_K, pop_size)
    cand_x = torch.cat([b["x"][:K] for b in before])
    cand_r = torch.cat([b["remaining"][:K] for b in before])
    g = torch.Generator(device=device)
    g.manual_seed((own["initial_seed"] * 0x5EED + own["sweeps"] * 0x9E3779B9) & ((1 << 63) - 1))
    victims = torch.randint(
        pop_size // 5, pop_size, (cand_x.shape[0],), generator=g, device=device
    ).cpu()
    present = {_key(r, n) for r in x}
    winner = {}
    for c in range(cand_x.shape[0]):
        if _key(cand_x[c], n) not in present:
            winner[int(victims[c])] = c
    for slot, c in winner.items():
        x[slot], rem[slot] = cand_x[c], cand_r[c]
    return _rows(x, rem, n), len(winner)


def exchange_mismatch(exchanges: List[List[dict]], n: int, device) -> Tuple[int, int]:
    """(rows by which the ranks' populations after each kept exchange
    differ from the ones worked out again, candidates the exchanges took
    by the reference). ``exchanges[r]``: rank r's kept exchanges in order,
    each {"before", "after"}; every rank keeps the same calls."""
    bad = taken = 0
    for calls in zip(*exchanges):
        before = [c["before"] for c in calls]
        for rank, c in enumerate(calls):
            want, took = exchanged(before, rank, n, device)
            have = _rows(c["after"]["x"], c["after"]["remaining"], n)
            bad += sum(((want - have) + (have - want)).values())
            taken += took
    return bad, taken
