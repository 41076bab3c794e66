"""A layout rule that the program does not have yet, applied to what its
``compile_problem`` returns: each long Z row's knapsack DP table sized to the
row's reachable window instead of its whole activity span, and every row
whose window fits ``DP_W_MAX`` sent to the DP. With gcd-scaled factor sums
N (negative) and Pz (positive) and scaled bounds [blo, bhi], the window is
[max(N, blo - Pz), min(Pz, bhi - N)]: a generalised assignment capacity
row needs b_i + 1 entries instead of sum_j a_ij + 1. The DP chooses on it
what it chooses on the whole span, so the benchmark's checks read 0 under
this layout as without it (``test_ilpbench_faults.py``, ``card_z.py``)."""

from __future__ import annotations

import contextlib
import dataclasses
import math

import numpy as np
import torch

from baryonyx_torch.ops.layout import DP_W_MAX, _bucket


def window_tables(cp):
    """``cp`` with its DP tables sized to the rows' windows: ``dp_lo`` the
    window's first activity, ``Wdp`` the widest window rounded up as the
    layout rounds it."""
    if not cp.has_z:
        return cp
    fac = cp.row_factor.cpu().numpy().astype(np.int64)
    r_size = cp.r_size.cpu().numpy()
    bmin, bmax = cp.bmin.cpu().numpy(), cp.bmax.cpu().numpy()
    enum = cp.enum_row.cpu().numpy()
    dp_row = np.zeros(cp.m, dtype=bool)
    dp_fac = np.zeros((cp.m, cp.Kr), dtype=np.int32)
    dp_lo, dp_blo, dp_bhi = (np.zeros(cp.m, dtype=np.int32) for _ in range(3))
    widest, walks = 0, False
    for k in range(cp.m_real):
        a = fac[k, : r_size[k]]
        if enum[k]:
            continue
        if not (np.abs(a) > 1).any():
            walks = True
            continue
        g = math.gcd(*np.abs(a).tolist())
        s = a // g
        blo, bhi = -(-int(bmin[k]) // g), int(bmax[k]) // g
        lo = max(int(s[s < 0].sum()), blo - int(s[s > 0].sum()))
        width = min(int(s[s > 0].sum()), bhi - int(s[s < 0].sum())) - lo + 1
        if width > DP_W_MAX:
            walks = True
            continue
        dp_row[k] = True
        dp_fac[k, : len(s)] = s
        dp_lo[k], dp_blo[k], dp_bhi[k] = lo, blo, bhi
        widest = max(widest, width)
    if not widest:
        return cp

    def tens(v):
        return torch.as_tensor(v).to(cp.device)

    return dataclasses.replace(
        cp, dp_row=tens(dp_row), dp_fac=tens(dp_fac), dp_lo=tens(dp_lo), dp_blo=tens(dp_blo),
        dp_bhi=tens(dp_bhi), Wdp=_bucket(widest, 8), z_needs_walk=walks,
    )


@contextlib.contextmanager
def program_layout(change):
    """While inside, the program's optimize and solve take ``change(cp)``
    for the layout ``cp`` that ``compile_problem`` returns."""
    from baryonyx_torch.solver import optimize as opt
    from baryonyx_torch.solver import solve as sv

    real = opt.compile_problem

    def compile_problem(*a, **kw):
        return change(real(*a, **kw))

    for module in (sv, opt):
        module.compile_problem = compile_problem
    try:
        yield
    finally:
        for module in (sv, opt):
            module.compile_problem = real
