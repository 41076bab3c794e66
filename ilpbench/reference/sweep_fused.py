"""The fused sweep's semantics (the program's kernel A), frozen in plain
PyTorch: one sweep over the scheduled rows in blocks of Bb, decisions of
a block against the column sums at block entry, then applied row by row
in block order; the tie noise from a splitmix counter hash of (seed pair,
row, slot, replica). The selected rank's key comes from a full sort of
the row's keys.

Works on any device and in any float type: the control runs it in
bfloat16."""

from __future__ import annotations

import torch

MAX_B = 16
_M32 = 0xFFFFFFFF


def hash_uniform(seed_u: int, rows, slots, reps) -> torch.Tensor:
    """u in [0, 1) for every (row, slot, replica), [L, K, R], float32."""
    h = (reps * 0x85EBCA6B) & _M32
    h = (h + seed_u) & _M32
    kk = (rows * 0xC2B2AE35) & _M32
    ss = (slots * 0x27D4EB2F) & _M32
    h = (h[None, None, :] + kk[:, None, None]) & _M32
    h = (h + ss[None, :, None]) & _M32
    h = h ^ (h >> 15)
    h = (h * 0x2C1B3C6D) & _M32
    h = h ^ (h >> 12)
    h = (h * 0x297A2D39) & _M32
    h = h ^ (h >> 15)
    return (h >> 8).to(torch.float32) * (2.0**-24)


def fused_sweep(t: dict, st: dict, dtype=torch.float32):
    """One sweep from state ``st`` (x, P, pi, S, sched, order, n_rows,
    kappa, amp, delta, theta, seed, minimize, block_size) with tables
    ``t`` (``tables.on_device``); returns (x, P, pi, S), new tensors."""
    dev = st["P"].device
    m, Kr = t["row_vars"].shape
    x = st["x"].to(device=dev, dtype=torch.int32).clone()
    P = st["P"].to(device=dev, dtype=dtype).clone()
    pi = st["pi"].to(device=dev, dtype=dtype).clone()
    S = st["S"].to(device=dev, dtype=dtype).clone()
    R = S.shape[1]

    def vec(v):
        return torch.as_tensor(v, dtype=torch.float32, device=dev).expand(R).to(dtype)

    kappa, amp, delta, theta = (vec(st[k]) for k in ("kappa", "amp", "delta", "theta"))
    cost = t["cost"].to(dtype)
    Bb = max(1, min(int(st["block_size"]), MAX_B))
    order = [int(v) for v in st["order"]]
    order += [m] * (-len(order) % Bb)
    n_rows = len(order) if st["n_rows"] is None else int(st["n_rows"])
    n_blocks = min((n_rows + Bb - 1) // Bb, len(order) // Bb)
    unit, minimize = t["unit"], st["minimize"]
    kp = kappa / (1.0 - kappa)
    s0, s1 = (int(v) & _M32 for v in st["seed"])
    seed_u = (s0 * 0x9E3779B9 + s1) & _M32
    rsz_h = t["r_size"].tolist()
    reps = torch.arange(R, dtype=torch.int64, device=dev)
    slots = torch.arange(Kr, dtype=torch.int64, device=dev)
    sched = st["sched"].to(dev)
    inf = float("inf")

    for blk in range(n_blocks):
        ks = [k for k in order[blk * Bb:(blk + 1) * Bb] if 0 <= k < m]
        if not ks:
            continue
        rows = torch.tensor(ks, dtype=torch.int64, device=dev)
        vars_ = t["row_vars"][rows]
        rsz = t["r_size"][rows]
        live = (slots[None, :] < rsz[:, None])[:, :, None]
        cj = cost[vars_][:, :, None]
        Sj = S[vars_]
        pr = P[rows]
        if unit:
            r = cj - (Sj + (theta - 1.0) * pr)
        else:
            af = t["row_factor"][rows][:, :, None]
            r = cj - (Sj + af * (theta - 1.0) * pr)
            r = torch.where(af < 0, -r, r)
        r = r + amp * cj
        sv = r if minimize else -r
        u = hash_uniform(seed_u, rows, slots, reps).to(dtype)
        sv = sv * (1.0 + (u - 0.5) * 2e-6) + (u - 0.5) * (delta * 1e-3)

        cnt = ((sv <= 0) & live).sum(dim=1)
        svs = torch.sort(torch.where(live, sv, inf), dim=1).values  # ascending

        rs2 = rsz[:, None]
        csz = t["neg_count"][rows][:, None]
        lo = t["bmin"][rows][:, None] + csz
        hi = torch.minimum(t["bmax"][rows][:, None] + csz, rs2)
        sel_eq = torch.minimum(lo, rs2) - 1
        sel_ineq = torch.minimum(torch.maximum(cnt, lo), hi) - 1
        selected = torch.where(t["is_eq"][rows][:, None], sel_eq, sel_ineq)
        sv_sel = svs.gather(1, selected.clamp(0, Kr - 1)[:, None, :])[:, 0]
        sv_sel1 = svs.gather(1, (selected + 1).clamp(0, Kr - 1)[:, None, :])[:, 0]
        sign = 1.0 if minimize else -1.0
        Rs_sel, Rs_sel1, Rs0 = sign * sv_sel, sign * sv_sel1, sign * svs[:, 0]
        case_none = selected < 0
        case_all = selected + 1 >= rs2
        d = delta + kp * torch.where(
            case_none, Rs0 * 0.5,
            torch.where(case_all, Rs_sel * 1.5, Rs_sel1 - Rs_sel),
        )
        dpi = torch.where(case_none | case_all, 0.0, (Rs_sel + Rs_sel1) * 0.5).to(dtype)
        valid = sched[rows]
        dpi = torch.where(valid, dpi, 0.0).to(dtype)
        thr = torch.where(case_none, -inf, sv_sel)

        for i, k in enumerate(ks):
            rs = rsz_h[k]
            v = vars_[i, :rs]
            p_i = pr[i, :rs]
            chosen = sv[i, :rs] <= thr[i]
            sgn = torch.where(chosen, 1.0, -1.0).to(dtype)
            if unit:
                new_p = theta * p_i + sgn * d[i]
            else:
                a_i = af[i, :rs]
                new_p = theta * p_i + (sgn * torch.where(a_i < 0, -1.0, 1.0)) * d[i]
            new_p = torch.where(valid[i], new_p, p_i)
            P[k, :rs] = new_p
            upd = (dpi[i] + new_p) - p_i
            if unit:
                bits = chosen
            else:
                upd = a_i * upd
                bits = sgn * a_i > 0
            S[v] = S[v] + torch.where(valid[i], upd, 0.0)
            x[v] = torch.where(valid[i], bits.to(torch.int32), x[v])
            pi[k] = pi[k] + dpi[i]
    return x, P, pi, S
