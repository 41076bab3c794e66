"""The Z sweep's semantics (the program's sweep for instances with integer
factors |a| > 1), frozen in plain PyTorch, for a linear objective: rows in
blocks of B over every block of the order, Jacobi inside a block and in
order across blocks.

- Column sums over |a|: S[j] = sum_k |a_kj| (pi_k + P[k, s]), worked out
  once at the sweep's start with one accumulating ``index_put_`` (fixed
  order) and updated after each block;
- reduced costs r = c - (S + |a| (theta - 1) P) + amp c, no sign flip;
- each row's set: rows the tables enumerate take the feasible assignment
  of least summed r (one ``bmm`` per block; the first of equal scores);
  DP rows the exact 0-1 knapsack over the gcd-scaled activity, the
  kernel's way (per slot one add and a strict compare, the answer at the
  lowest w of least score in the row's range); every other row the greedy
  prefix walk over r sorted with ties broken by noise from the run's
  generator (drawn for every block once any row walks) and then by slot;
- pi moves by half the least r (no slot chosen), 1.5 x the worst chosen r
  (every slot chosen) or the mean of the worst chosen and best unchosen r;
  P decays by theta, moves by +-d with d = kappa / (1 - kappa) + delta,
  and is repaired where the recomputed reduced cost disagrees with the
  choice;
- the later row of a block wins conflicting x writes; afterwards each
  row's violation against [bmin, bmax].

Works on any device and in any float type: the control runs it in
bfloat16."""

from __future__ import annotations

import torch

DP_BIG = 1e30  # the DP's "infinity" below float64, where it is +inf


def _add_rows(S, idx, vals):
    if S.device.type == "cuda":
        return S.index_put_((idx,), vals, accumulate=True)
    return S.index_add_(0, idx, vals)


def _walk(t, rl, r_masked, a, tb, minimize):
    """The greedy prefix walk: the longest prefix of the sorted slots
    within the row's bounds, cut before the first slot whose reduced cost
    has the stopping sign once a feasible prefix exists."""
    B, Kr, R = r_masked.shape
    dev = r_masked.device
    slots = torch.arange(Kr, device=dev)[None, :, None].expand(B, Kr, R)
    key = r_masked if minimize else -r_masked
    by_tb = torch.argsort(tb, dim=1, stable=True)
    by_key = torch.argsort(key.gather(1, by_tb), dim=1, stable=True)
    slot_at = by_tb.gather(1, by_key)
    key_sorted = key.gather(1, slot_at)
    r_sorted = key_sorted if minimize else -key_sorted
    rank = torch.empty_like(slot_at).scatter_(1, slot_at, slots)
    prefix = torch.cumsum(a[:, :, None].expand(B, Kr, R).gather(1, slot_at), dim=1)
    lo = t["bmin"][rl][:, None, None].to(r_masked.dtype)
    hi = t["bmax"][rl][:, None, None].to(r_masked.dtype)
    feasible = (prefix >= lo) & (prefix <= hi) & (slots < t["r_size"][rl][:, None, None])
    empty_ok = ((lo <= 0) & (hi >= 0))[:, 0, :]
    stop = r_sorted > 0 if minimize else r_sorted < 0
    first = torch.where(empty_ok, -1, torch.where(
        feasible.any(dim=1), feasible.to(torch.int8).argmax(dim=1), Kr))
    stop_after = stop & (slots > first[:, None, :])
    cut = torch.where(stop_after.any(dim=1), stop_after.to(torch.int8).argmax(dim=1) - 1, Kr - 1)
    ok = feasible & (slots <= cut[:, None, :])
    last = torch.where(ok.any(dim=1), (Kr - 1) - ok.flip(1).to(torch.int8).argmax(dim=1), -1)
    return rank <= last[:, None, :]


def _dp_row(t, k, r_row, live, minimize):
    """The knapsack DP of row ``k`` for every replica: r_row [Kr, R],
    live [Kr]. Returns the chosen slots bool[Kr, R]."""
    Kr, R = r_row.shape
    dev = r_row.device
    W = int(t["Wdp"])
    big = float("inf") if r_row.dtype == torch.float64 else DP_BIG
    rq = torch.where(live[:, None], r_row if minimize else -r_row, big)
    a = t["dp_fac"][k]
    lo = int(t["dp_lo"][k])
    wi = torch.arange(W, device=dev)
    f = torch.full((W, R), big, dtype=r_row.dtype, device=dev)
    f[-lo] = 0
    nw = (Kr + 31) // 32
    words = torch.zeros((nw, W, R), dtype=torch.int64, device=dev)
    for s in range(Kr):
        src = wi - a[s]
        inside = ((src >= 0) & (src < W))[:, None]
        src = src.clamp(0, W - 1)
        cand = torch.where(inside, f[src], big) + rq[s]
        take = cand < f
        moved = torch.where(inside, words[:, src], 0)
        moved[s // 32] |= 1 << (s % 32)
        words = torch.where(take, moved, words)
        f = torch.where(take, cand, f)
    in_range = ((wi >= int(t["dp_blo"][k]) - lo) & (wi <= int(t["dp_bhi"][k]) - lo))[:, None]
    f = torch.where(in_range, f, big)
    best = torch.where(f == f.amin(dim=0), wi[:, None], W).amin(dim=0)  # [R]
    w_best = words.gather(1, best[None, None, :].expand(nw, 1, R))[:, 0]  # [nw, R]
    s_iota = torch.arange(Kr, device=dev)
    return ((w_best[s_iota // 32] >> (s_iota % 32)[:, None]) & 1) > 0


def z_sweep(t: dict, st: dict, dtype=torch.float32):
    """One sweep from state ``st`` (x, P, pi, sched, order, kappa, amp,
    delta, theta, minimize, block_size and ``gen_state``, the generator's
    state at the call) with tables ``t`` (``tables.on_device`` of a Z
    instance); returns (x, P, pi, violated), new tensors."""
    dev = st["P"].device
    m, Kr = t["row_vars"].shape
    n = st["x"].shape[0]
    x = st["x"].to(dev).clone()
    P = st["P"].to(device=dev, dtype=dtype).clone()
    pi = st["pi"].to(device=dev, dtype=dtype).clone()
    R = pi.shape[-1]
    B = int(st["block_size"])
    order = st["order"].to(device=dev, dtype=torch.int32)
    mp = order.shape[0]
    gen = None
    if t["z_needs_walk"]:
        gen = torch.Generator(device=dev)
        gen.set_state(st["gen_state"])

    def vec(v):
        return torch.as_tensor(v, device=dev).to(dtype)

    theta, delta, kappa, amp = (vec(st[k]) for k in ("theta", "delta", "kappa", "amp"))
    d = kappa / (1 - kappa) + delta
    minimize = st["minimize"]
    big = float("inf") if minimize else float("-inf")
    inf = float("inf")
    cost = t["cost"].to(dtype)
    row_mask = torch.arange(Kr, device=dev)[None, :] < t["r_size"][:, None]
    absa = t["row_factor"].abs()
    sidx_all = torch.where(row_mask, t["row_vars"], n).reshape(-1)
    S = torch.zeros((n + 1, R), dtype=dtype, device=dev)
    _add_rows(S, sidx_all, (absa[:, :, None] * (pi[:, None, :] + P)).reshape(-1, R))
    prio2 = 2 * torch.arange(B, device=dev)[:, None, None]
    sched = st["sched"].to(dev)
    assign_bits = t["assign_bits"].to(dtype)

    for b in range(mp // B):
        rows = order[b * B:(b + 1) * B]
        row_ok = rows < m
        rl = torch.clamp(rows, max=m - 1).long()
        valid = sched[rl] & row_ok[:, None]
        vars0 = t["row_vars"][rl]
        a = t["row_factor"][rl]
        a3 = a.abs()[:, :, None]
        mask = row_mask[rl]
        live = mask[:, :, None]
        P_rows = P[rl]
        gvars = torch.where(mask, vars0, 0)
        cx = cost[gvars][:, :, None]
        r = cx - (S[gvars] + a3 * (theta - 1) * P_rows)
        r = r + amp * cx
        r_masked = torch.where(live, r, big)

        scores = torch.bmm(assign_bits[rl], torch.where(live, r, 0.0))
        scores = torch.where(t["assign_valid"][rl][:, :, None], scores, big)
        best = scores.argmin(dim=1) if minimize else scores.argmax(dim=1)
        chosen = t["assign_bits"][rl].transpose(1, 2).gather(
            2, best[:, None, :].expand(B, Kr, R)) > 0
        if gen is not None:
            tb = torch.rand((B, Kr, R), generator=gen, device=dev)
            chosen = torch.where(t["enum_row"][rl][:, None, None], chosen,
                                 _walk(t, rl, r_masked, a, tb, minimize))
        for i in range(B):
            k = int(rl[i])
            if int(t["Wdp"]) and bool(t["dp_row"][k]):
                chosen[i] = _dp_row(t, k, r[i], mask[i], minimize)
        chosen = chosen & live

        n_chosen = chosen.sum(dim=1, dtype=torch.int32)
        case_none = n_chosen == 0
        case_all = n_chosen >= t["r_size"][rl][:, None]
        if minimize:
            worst_chosen = torch.where(chosen, r, -inf).amax(dim=1)
            best_unchosen = torch.where(~chosen & live, r, inf).amin(dim=1)
            r0 = torch.where(live, r, inf).amin(dim=1)
        else:
            worst_chosen = torch.where(chosen, r, inf).amin(dim=1)
            best_unchosen = torch.where(~chosen & live, r, -inf).amax(dim=1)
            r0 = torch.where(live, r, -inf).amax(dim=1)
        dpi = torch.where(case_none, r0 * 0.5, torch.where(
            case_all, worst_chosen * 1.5, (worst_chosen + best_unchosen) * 0.5))
        dpi = torch.where(valid, dpi, 0.0)

        sgn = torch.where(chosen, 1.0, -1.0).to(dtype)
        P1 = theta * P_rows + sgn * d
        repair = r - a3 * (dpi[:, None, :] + sgn * d)
        P2 = torch.where(chosen & (repair >= 0), P1 - repair + d,
                         torch.where(~chosen & (repair <= 0), P1 + repair - d, P1))
        vmask = valid[:, None, :] & live
        P2 = torch.where(vmask, P2, P_rows)

        if mp > m:  # sentinel rows clamp onto row m - 1: keep its new value
            same = (rl[:, None] == rl[None, :]) & row_ok[None, :]
            owner = torch.where(same.any(dim=1), same.to(torch.int8).argmax(dim=1),
                                torch.arange(B, device=dev))
            P.index_copy_(0, rl, P2[owner])
        else:
            P.index_copy_(0, rl, P2)
        pi.index_add_(0, rl, dpi)

        sidx = torch.where(mask & row_ok[:, None], vars0, n).reshape(-1)
        dS = torch.where(vmask, a3 * (dpi[:, None, :] + (P2 - P_rows)), 0.0)
        _add_rows(S, sidx, dS.reshape(-1, R))
        enc = torch.where(vmask, prio2 + chosen.to(torch.int64), -1)
        tmp = torch.full((n + 1, R), -1, dtype=torch.int64, device=dev)
        tmp.scatter_reduce_(0, sidx[:, None].expand(-1, R), enc.reshape(-1, R), reduce="amax")
        x = torch.where(tmp[:n] >= 0, (tmp[:n] & 1).to(x.dtype), x)

    act = torch.where(row_mask[:, :, None],
                      t["row_factor"].double()[:, :, None] * x[t["row_vars"]].double(), 0.0).sum(1)
    violated = (act < t["bmin"][:, None]) | (act > t["bmax"][:, None])
    return x, P, pi, violated
