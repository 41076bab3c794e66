"""Row activities, violation masks and merged column sums.

All solver state carries a trailing replica axis R (the multi-start axis
that replaces the reference's thread pool): ``x[n, R]``, ``P[m, Kr, R]``,
``pi[m, R]``. Row and column indices are shared across replicas.

The reference's column walks (sum of a*pi and a*P over every row touching
a variable — reference: itm-solver-equalities-101.cpp:161-195) become one
merged column-sum tensor ``S[n, R]``, recomputed exactly here and updated
incrementally inside the sweep (ops/psweep.py).
"""

from __future__ import annotations

import torch

from baryonyx_torch.ops.layout import CompiledProblem


def activities(cp: CompiledProblem, x: torch.Tensor) -> torch.Tensor:
    """Row activities A x. x: [n] or [n, R] → [m] or [m, R].

    One matmul against the dense factor matrix when the layout has one,
    else a gather over the padded rows."""
    if cp.dense_A is not None and x.ndim == 2:
        return cp.dense_A @ x.to(cp.dense_A.dtype)
    xg = x[cp.row_vars.long()].to(cp.row_factor.dtype)  # [m, Kr] or [m, Kr, R]
    a = cp.row_factor
    mask = cp.row_mask
    if x.ndim == 2:
        a = a[:, :, None]
        mask = mask[:, :, None]
    return torch.where(mask, a * xg, 0.0).sum(dim=1)


def violated_mask(cp: CompiledProblem, x: torch.Tensor) -> torch.Tensor:
    """Rows whose activity falls outside [bmin, bmax]
    (reference: is_valid_constraint, itm-common.hpp:76-115).
    x: [n] → [m]; x: [n, R] → [m, R]."""
    act = activities(cp, x)
    bmin = cp.bmin.to(act.dtype)
    bmax = cp.bmax.to(act.dtype)
    if x.ndim == 2:
        bmin = bmin[:, None]
        bmax = bmax[:, None]
    return (act < bmin) | (act > bmax)


def column_sums(
    cp: CompiledProblem, P: torch.Tensor, pi: torch.Tensor
) -> torch.Tensor:
    """Exact S[j] = sum_k a_kj (pi_k + P[k, s(k,j)]) by one index_add_
    over all elements; padded slots land in a dropped row n.
    P: [m, Kr, R], pi: [m, R] → [n, R]."""
    R = pi.shape[-1]
    contrib = (cp.row_factor[:, :, None] * (pi[:, None, :] + P)).reshape(-1, R)
    idx = torch.where(cp.row_mask, cp.row_vars, cp.n).reshape(-1).long()
    S = torch.zeros((cp.n + 1, R), dtype=P.dtype, device=P.device)
    S.index_add_(0, idx, contrib)
    return S[: cp.n]
