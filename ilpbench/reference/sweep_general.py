"""The general sweep's semantics (the program's solve-mode sweep), frozen
in plain PyTorch, for 0/1 and +-1 rows with a linear objective: rows in
blocks of B, Jacobi inside a block and in order across blocks; P decayed
by theta, reduced costs against the merged column sums, tie noise of
1e-6 of the block's largest reduced cost drawn from the run's generator
block by block; the selected rank's key from a full sort; the later row
of a block wins conflicting x writes. Column sums are added with one
accumulating ``index_put_``, whose order is fixed.

Works on any device and in any float type: the control runs it in
bfloat16."""

from __future__ import annotations

import torch


def _add_rows(S, idx, vals):
    if S.device.type == "cuda":
        return S.index_put_((idx,), vals, accumulate=True)
    return S.index_add_(0, idx, vals)


def general_sweep(t: dict, st: dict, dtype=torch.float32):
    """One sweep from state ``st`` (x, P, pi, S, sched, order, n_rows,
    kappa, amp, delta, theta, minimize, block_size and ``gen_state``, the
    generator's state at the call) with tables ``t``; returns
    (x, P, pi, S), new tensors."""
    dev = st["P"].device
    m, Kr = t["row_vars"].shape
    n = st["x"].shape[0]
    x = st["x"].to(dev).clone()
    P = st["P"].to(device=dev, dtype=dtype).clone()
    pi = st["pi"].to(device=dev, dtype=dtype).clone()
    S0 = st["S"].to(device=dev, dtype=dtype)
    R = pi.shape[-1]
    B = int(st["block_size"])
    order = st["order"].to(device=dev, dtype=torch.int32)
    mp = order.shape[0]
    n_blocks = mp // B
    if st["n_rows"] is not None:
        n_blocks = min((int(st["n_rows"]) + B - 1) // B, n_blocks)
    gen = torch.Generator(device=dev)
    gen.set_state(st["gen_state"])

    def vec(v):
        return torch.as_tensor(v, device=dev).to(dtype)

    theta, delta, kappa, amp = (vec(st[k]) for k in ("theta", "delta", "kappa", "amp"))
    kp = kappa / (1 - kappa)
    inf = float("inf")
    cost = t["cost"].to(dtype)
    row_mask = torch.arange(Kr, device=dev)[None, :] < t["r_size"][:, None]
    S = torch.cat([S0, S0.new_zeros((1, R))])
    has_sentinels = mp > m
    prio2 = 2 * torch.arange(B, device=dev)[:, None, None]
    minimize = st["minimize"]
    sched = st["sched"].to(dev)

    for b in range(n_blocks):
        rows = order[b * B:(b + 1) * B]
        row_ok = rows < m
        rl = torch.clamp(rows, max=m - 1).long()
        valid = sched[rl] & row_ok[:, None]
        vars0 = t["row_vars"][rl]
        a3 = t["row_factor"][rl][:, :, None]
        mask = row_mask[rl]
        live = mask[:, :, None]
        P_rows = P[rl]
        gvars = torch.where(mask, vars0, 0).long()
        cx = cost[gvars][:, :, None]
        Sg = S[gvars] + a3 * (theta - 1) * P_rows
        P_dec = theta * P_rows
        r = cx - Sg
        r = torch.where(a3 < 0, -r, r)
        r = r + amp * cx
        tb = torch.rand((B, Kr, R), generator=gen, device=dev, dtype=dtype)
        eps = 1e-6 * (1 + torch.where(live, r, 0.0).abs().max())
        r = r + (tb - 0.5) * eps
        sv = torch.where(live, r if minimize else -r, inf)

        r_size = t["r_size"][rl][:, None]
        c_size = t["neg_count"][rl][:, None]
        lo = t["bmin"][rl][:, None] + c_size
        hi = torch.minimum(t["bmax"][rl][:, None] + c_size, r_size)
        sel_eq = torch.minimum(lo, r_size) - 1
        cnt = (sv <= 0).sum(dim=1)
        sel_ineq = torch.minimum(torch.maximum(cnt, lo), hi) - 1
        selected = torch.where(t["is_eq"][rl][:, None], sel_eq, sel_ineq)
        svs = torch.sort(sv, dim=1).values
        sv_sel = svs.gather(1, selected.clamp(0, Kr - 1)[:, None, :])[:, 0]
        sv_sel1 = svs.gather(1, (selected + 1).clamp(0, Kr - 1)[:, None, :])[:, 0]
        sv0 = svs[:, 0]
        if minimize:
            Rs_sel, Rs_sel1, Rs0 = sv_sel, sv_sel1, sv0
        else:
            Rs_sel, Rs_sel1, Rs0 = -sv_sel, -sv_sel1, -sv0
        thr = torch.where(selected < 0, -inf, sv_sel)[:, None, :]
        case_none = selected < 0
        case_all = selected + 1 >= r_size
        d = delta + kp * torch.where(
            case_none, Rs0 * 0.5,
            torch.where(case_all, Rs_sel * 1.5, Rs_sel1 - Rs_sel),
        )
        dpi = torch.where(case_none | case_all, 0.0, (Rs_sel + Rs_sel1) * 0.5)
        s = torch.where(sv <= thr, 1.0, -1.0).to(dtype)
        new_P = P_dec + s * torch.sign(a3) * d[:, None, :]
        bits = (s * a3 > 0).to(torch.int64)
        vmask = valid[:, None, :] & live
        new_P = torch.where(vmask, new_P, P_rows)
        dpi = torch.where(valid, dpi, 0.0).to(dtype)

        if has_sentinels:  # sentinel rows clamp onto row m - 1: keep its new value
            same = (rl[:, None] == rl[None, :]) & row_ok[None, :]
            owner = torch.where(
                same.any(dim=1), same.to(torch.int8).argmax(dim=1),
                torch.arange(B, device=dev),
            )
            new_P_w = new_P[owner]
        else:
            new_P_w = new_P
        P.index_copy_(0, rl, new_P_w)
        pi.index_add_(0, rl, dpi)

        sidx = torch.where(mask & row_ok[:, None], vars0, n).reshape(-1).long()
        upd = torch.where(vmask, a3 * (dpi[:, None, :] + new_P - P_rows), 0.0)
        _add_rows(S, sidx, upd.reshape(-1, R))
        enc = torch.where(vmask, prio2 + bits, -1)
        tmp = torch.full((n + 1, R), -1, dtype=torch.int64, device=dev)
        tmp.scatter_reduce_(0, sidx[:, None].expand(-1, R), enc.reshape(-1, R), reduce="amax")
        x = torch.where(tmp[:n] >= 0, (tmp[:n] & 1).to(x.dtype), x)
    return x, P, pi, S[:n]
