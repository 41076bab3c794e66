"""CSV benchmark harness.

Protocol-compatible with the reference's benchmark mode (reference:
app/src/benchmark.cpp): the CSV's first column is the model name (a
``<name>.lp`` file living next to the CSV), the second the best-known
objective (``status``/``optimum``), then one column per recorded solver
run. Running the harness appends a new column with this run's objectives
(reference: save, :317-331), prints a comparison grid (:503-610), and
writes ``<name>-stats.csv`` with per-model ranks, mean rank and final
rank per solver (:333-416).
"""

from __future__ import annotations

import csv
import os
import time
from typing import List, Optional

import baryonyx_torch as bx
from baryonyx_torch.device import DeviceLike


class BenchData:
    def __init__(self, header: List[str], rows: List[List[str]]):
        self.header = header
        self.rows = rows

    @classmethod
    def load(cls, path: str) -> "BenchData":
        with open(path) as fh:
            reader = csv.reader(fh)
            raw = [row for row in reader if row]
        return cls([c.strip() for c in raw[0]], [[c.strip() for c in r] for r in raw[1:]])

    def save(self, path: str) -> None:
        with open(path, "w", newline="") as fh:
            writer = csv.writer(fh)
            writer.writerow(self.header)
            writer.writerows(self.rows)

    @property
    def solvers(self) -> List[str]:
        return self.header[2:]


def _parse_value(s: str) -> Optional[float]:
    s = s.strip()
    if not s or s.lower() in ("inf", "nan", "-"):
        return None
    try:
        return float(s)
    except ValueError:
        return None


def benchmark(
    ctx: bx.Context, csv_path: str, name: str, device: DeviceLike = None
) -> int:
    """Run every model of the suite and append a result column
    (reference: benchmark, benchmark.cpp:781-855; try_benchmark :614-780).
    Runs on the first CUDA device unless ``device`` says otherwise."""
    data = BenchData.load(csv_path)
    if name in data.solvers:
        ctx.warning("benchmark: column {} already present, appending -2\n", name)
        name = name + "-2"
    base = os.path.dirname(os.path.abspath(csv_path))

    data.header.append(name)
    for row in data.rows:
        model = row[0]
        lp_path = os.path.join(base, model + ".lp")
        if not os.path.exists(lp_path):
            ctx.warning("benchmark: missing model {}\n", lp_path)
            row.append("inf")
            continue
        try:
            pb = bx.make_problem(ctx, lp_path)
            t0 = time.monotonic()
            res = bx.optimize(ctx, pb, device=device)
            dt = time.monotonic() - t0
        except bx.BaryonyxError as e:
            ctx.error("benchmark: {}: {}\n", model, e)
            row.append("inf")
            continue
        if res.status == bx.ResultStatus.success and res.solutions:
            value = res.solutions[-1].value
            row.append(f"{value:.10g}")
            ctx.notice("  - {}: {} in {:.1f}s\n", model, value, dt)
        else:
            row.append("inf")
            ctx.notice("  - {}: no solution ({})\n", model, res.status.name)

    data.save(csv_path)
    _show_grid(ctx, data)
    _save_stats(ctx, data, csv_path)
    return 0


def _show_grid(ctx: bx.Context, data: BenchData) -> None:
    """Comparison table (reference: show_to_console, benchmark.cpp:503-610)."""
    widths = [max(len(r[i]) for r in [data.header] + data.rows) for i in range(len(data.header))]
    line = "  ".join(h.ljust(w) for h, w in zip(data.header, widths))
    ctx.notice("{}\n", line)
    for row in data.rows:
        best = min(
            (v for v in (_parse_value(c) for c in row[1:]) if v is not None),
            default=None,
        )
        cells = []
        for i, c in enumerate(row):
            mark = ""
            if i >= 1 and best is not None and _parse_value(c) == best:
                mark = "*"
            cells.append((c + mark).ljust(widths[i] + 1))
        ctx.notice("{}\n", "  ".join(cells))


def _save_stats(ctx: bx.Context, data: BenchData, csv_path: str) -> None:
    """Rank table: per-model solver ranks, mean rank, final rank
    (reference: save_stats, benchmark.cpp:333-416)."""
    solvers = data.solvers
    if not solvers:
        return
    ranks_per_model: List[List[Optional[int]]] = []
    for row in data.rows:
        values = [(_parse_value(row[2 + i]), i) for i in range(len(solvers))]
        present = sorted([v for v in values if v[0] is not None])
        rank_of = {i: r + 1 for r, (_, i) in enumerate(present)}
        ranks_per_model.append([rank_of.get(i) for i in range(len(solvers))])

    means: List[float] = []
    for i in range(len(solvers)):
        rs = [m[i] for m in ranks_per_model if m[i] is not None]
        means.append(sum(rs) / len(rs) if rs else float("inf"))
    order = sorted(range(len(solvers)), key=lambda i: means[i])
    final_rank = {i: r + 1 for r, i in enumerate(order)}

    stats_path = os.path.splitext(csv_path)[0] + "-stats.csv"
    with open(stats_path, "w", newline="") as fh:
        writer = csv.writer(fh)
        writer.writerow(["model"] + solvers)
        for row, ranks in zip(data.rows, ranks_per_model):
            writer.writerow([row[0]] + ["" if r is None else r for r in ranks])
        writer.writerow(["mean-rank"] + [f"{m:.3f}" for m in means])
        writer.writerow(["final-rank"] + [final_rank[i] for i in range(len(solvers))])
    ctx.notice("- stats written to {}\n", stats_path)
