"""The least time a sweep of the fused kernel (kernel A) needs, and a call
of the knapsack DP (kernel B, ``dpselect_bound``), against the card's
published peaks (``peaks.json``): the bytes its inputs need over the memory
rate, or its operations over the float32 rate, whichever is larger.

Counted per sweep (the arithmetic of the program's ``chip_smoke.py``
bound): ``sched`` of the rows it walks; for each scheduled (row, replica)
pair its P row and pi read and written; S read and written and x written
once for each (variable, replica) a scheduled pair touches; the row
tables, costs and per-replica vectors. Per scheduled slot: the reduced
cost 6 operations, the splitmix hash 13, the tie noise 7, the count of
keys <= 0 2, the J_bot + J_top order statistics and the two keys nearest
0 2 each, phase B's threshold test and updates 7. What these inputs need,
whatever implements them."""

from __future__ import annotations

import json
from pathlib import Path
from typing import Optional

import numpy as np
import torch

PEAKS = json.loads((Path(__file__).parent / "peaks.json").read_text())


def psweep_bound(ref: dict, cp: dict, st: dict, kind: str) -> Optional[dict]:
    """{"ms", "by", "bytes", "ops"} of one sweep from state ``st`` with
    tables ``ref`` (row_vars, r_size) and the program's J_bot, J_top, on
    the card named ``kind``; None for a card without published peaks."""
    if kind not in PEAKS:
        return None
    sched = st["sched"]
    dev = sched.device
    m, n = len(ref["r_size"]), cp["n"]
    R = sched.shape[1]
    n_rows = len(st["order"]) if st["n_rows"] is None else int(st["n_rows"])
    order = torch.as_tensor(st["order"], device=dev).long()[:n_rows]
    rows = order[order < m]
    L = rows.numel()
    sch = sched[rows].float()
    rsz = torch.as_tensor(ref["r_size"], device=dev).long()[rows]
    Kr = ref["row_vars"].shape[1]
    live = torch.arange(Kr, device=dev)[None, :] < rsz[:, None]
    rv = torch.as_tensor(ref["row_vars"], device=dev).long()[rows]
    inc = torch.zeros((L, n + 1), device=dev)
    inc.scatter_(1, torch.where(live, rv, n), 1.0)
    touched = int(((inc[:, :n].T @ sch) > 0).sum())
    slots = float((rsz.float()[:, None] * sch).sum())
    pairs = float(sch.sum())
    nbytes = (
        L * R + 8 * slots + 8 * pairs + 12 * touched
        + 4 * int(rsz.sum()) + 20 * L + 4 * n + 16 * R
    )
    ops = (6 + 13 + 7 + 2 + 2 * (cp["J_bot"] + cp["J_top"] + 2) + 7) * slots
    p = PEAKS[kind]
    t_b = nbytes / p["hbm_bytes_per_s"] * 1e3
    t_o = ops / p["f32_ops_per_s"] * 1e3
    return {"ms": max(t_b, t_o), "by": "bytes" if t_b >= t_o else "operations",
            "bytes": nbytes, "ops": ops}


def dpselect_bound(ref: dict, rows, R: int, itemsize: int, kind: str) -> Optional[dict]:
    """{"ms", "by", "bytes", "ops"} of one call of the knapsack DP (kernel
    B) over the row block ``rows`` (the program's row indices) and R
    replicas, with scores of ``itemsize`` bytes, at the reference's tables
    with the program's routes (``dp_row``): each of the block's DP rows
    counted at its own reachable window (``win_w``) and its own slots
    (``r_size``), whatever table the program runs it on; None for a card
    without published peaks.

    Bytes: the row list and its DP flags read (5 per row of the block); per
    DP row r read and the chosen set written (``itemsize`` + 1 per slot and
    replica), its factors and slot mask read (5 per slot) and its offset
    and bounds (12). Operations per (DP row, replica): the table's set-up 1
    per w; per slot and w the shift test, the add, the compare and two
    selects 5; the argmin over w 4 per w; the read-out 2 per slot. The table
    itself stays on chip in an ideal kernel and is not counted. Float64
    scores run at half the float32 rate."""
    if kind not in PEAKS:
        return None
    rows = torch.as_tensor(rows).long().cpu().numpy()
    dp = rows[np.asarray(ref["dp_row"])[rows]]
    W = np.asarray(ref["win_w"], dtype=np.int64)[dp]
    L = np.asarray(ref["r_size"], dtype=np.int64)[dp]
    nbytes = 5 * len(rows) + int(((itemsize + 1) * L * R + 5 * L + 12).sum())
    ops = R * int((W * (1 + 5 * L + 4) + 2 * L).sum())
    p = PEAKS[kind]
    t_b = nbytes / p["hbm_bytes_per_s"] * 1e3
    t_o = ops / (p["f32_ops_per_s"] * 4 / itemsize) * 1e3
    return {"ms": max(t_b, t_o), "by": "bytes" if t_b >= t_o else "operations",
            "bytes": nbytes, "ops": ops}
