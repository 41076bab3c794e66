"""The program's knapsack DP (``ops/zsweep.py:dp_select_reference``, the
arithmetic of kernel B) on a table cut to each row's reachable window
chooses, bit for bit, what it chooses on the table over the row's whole
activity span: the ground for holding the program's Z tables to window
cover rather than to the span (``reference/tables.py``). Random long rows
with factors of both signs and <=, >= and = bounds, each set around the
activity of a random assignment so that every row is feasible; each row
on a table of exactly its own width, and all in one call on the widest
row's width rounded up as the program's layout rounds it."""

from __future__ import annotations

import math
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from baryonyx_torch.ops.layout import _bucket
from baryonyx_torch.ops.zsweep import dp_select_reference

B, KR, R = 8, 40, 16


def _rows(seed: int):
    """B rows of 16 to KR slots: factors in -9..9 without 0 (even in every
    fourth row), all of them positive in a quarter of the rows and most of
    them in another; bounds (<=, >= or =) clamped to the row's reach as the
    program's layout clamps them."""
    rng = np.random.default_rng(seed)
    fac = np.zeros((B, KR), dtype=np.int64)
    mask = np.zeros((B, KR), dtype=bool)
    bmin, bmax = np.zeros(B, dtype=np.int64), np.zeros(B, dtype=np.int64)
    for k in range(B):
        L = int(rng.integers(16, KR + 1))
        sign = np.where(rng.random(L) < (0.5, 0.0, 0.5, 0.1)[k % 4], -1, 1)
        fac[k, :L] = sign * rng.integers(1, 10, size=L) * (2 if k % 4 == 3 else 1)
        mask[k, :L] = True
        act = int(fac[k, :L] @ (rng.random(L) < 0.3))
        neg, pos = int(fac[k][fac[k] < 0].sum()), int(fac[k][fac[k] > 0].sum())
        kind = k % 3
        bmin[k] = neg if kind == 0 else act  # <=, >=, =
        bmax[k] = pos if kind == 1 else act
    return fac, mask, bmin, bmax


def _tables(fac, bmin, bmax, window: bool):
    """The DP tables of the rows: gcd-scaled factors and bounds, each row's
    table over its whole span (``window`` False) or over its reachable
    window, and each table's width."""
    dp_fac = np.zeros_like(fac)
    lo, blo, bhi, width = (np.zeros(B, dtype=np.int64) for _ in range(4))
    for k in range(B):
        g = math.gcd(*np.abs(fac[k]).tolist())
        dp_fac[k] = fac[k] // g
        neg, pos = int(dp_fac[k][dp_fac[k] < 0].sum()), int(dp_fac[k][dp_fac[k] > 0].sum())
        blo[k], bhi[k] = -(-int(bmin[k]) // g), int(bmax[k]) // g
        hi = min(pos, bhi[k] - neg) if window else pos
        lo[k] = max(neg, blo[k] - pos) if window else neg
        width[k] = hi - lo[k] + 1

    def i32(v):
        return torch.as_tensor(v, dtype=torch.int32)

    return SimpleNamespace(dp_row=torch.ones(B, dtype=torch.bool), dp_fac=i32(dp_fac),
                           dp_lo=i32(lo), dp_blo=i32(blo), dp_bhi=i32(bhi), width=width)


def _select(t, r, mask, minimize, bucketed: bool):
    """The DP of every row: all in one call on one table width (the widest
    row's, rounded up as the program's layout rounds it), or each row
    alone on a table of exactly its own width."""
    if bucketed:
        t.Wdp = _bucket(int(t.width.max()), 8)
        return dp_select_reference(t, torch.arange(B, dtype=torch.int32), r, mask, minimize)
    out = []
    for k in range(B):
        t.Wdp = int(t.width[k])
        rows = torch.tensor([k], dtype=torch.int32)
        out.append(dp_select_reference(t, rows, r[k:k + 1], mask[k:k + 1], minimize))
    return torch.cat(out)


@pytest.mark.parametrize("bucketed", [True, False])
@pytest.mark.parametrize("seed", [0, 1, 2**31 + 5])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("minimize", [True, False])
def test_the_dp_on_the_window_chooses_what_it_chooses_on_the_span(seed, dtype, minimize,
                                                                  bucketed):
    fac, mask, bmin, bmax = _rows(seed)
    span, cut = _tables(fac, bmin, bmax, False), _tables(fac, bmin, bmax, True)
    assert cut.width.sum() < span.width.sum()  # the cut leaves activities out
    g = torch.Generator().manual_seed(seed % 2**31)
    r = torch.randn((B, KR, R), generator=g, dtype=torch.float64).to(dtype)
    r[:, :, : R // 2] = r[:, :, : R // 2].round()  # ties between sets, for half the replicas
    m = torch.as_tensor(mask)
    want = _select(span, r, m, minimize, bucketed)
    got = _select(cut, r, m, minimize, bucketed)
    assert torch.equal(want, got)
    act = (torch.as_tensor(fac)[:, :, None] * got).sum(dim=1)
    assert ((act >= torch.as_tensor(bmin)[:, None]) & (act <= torch.as_tensor(bmax)[:, None])).all()
