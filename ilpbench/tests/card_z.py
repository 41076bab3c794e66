"""The Z cells at OR-Library's gapd sizes on the card
(``tiny.card_z_benchmark``), on the program's own layout or on the
window-sized one (``window_layout.py``), each run in this process in turn.

    python3 -m ilpbench.tests.card_z --cells gap20x200.optimize \
        --layouts program,window --seeds 11,12 --seconds 10 --trace 0,1

appends one record per run to ``--out`` (the cell, layout, seed, trace,
the layout's DP rows, ``Wdp`` and ``z_needs_walk``, and the result line)
and prints it. Traced, the line also reads kernel B's launches and device
ms in the traced window and the sum of its least times over the traced
DP calls (``dp_bound``), through readers added to the copy as data."""

from __future__ import annotations

import argparse
import json
import sys
import tempfile
from pathlib import Path

from ilpbench.tests.tiny import Z_CARD, card_z_benchmark, z_cells
from ilpbench.tests.window_layout import program_layout, window_tables

READERS = {  # name: (unit, expression over the run record ``run`` and its trace ``t``)
    "kernel_b.launches": ("launches", "device_us(t, 'dpselect_kernel')[1]"),
    "kernel_b.ms": ("ms", "device_us(t, 'dpselect_kernel')[0] / 1e3"),
    "dp_bound.calls": ("calls", "run['dp_bound']['calls'] if run['dp_bound'] else None"),
    "dp_bound.ms": ("ms", "run['dp_bound']['ms'] if run['dp_bound'] else None"),
}


def benchmark(dst: Path) -> Path:
    """``card_z_benchmark`` with kernel B's readers as per-layer metrics of
    its Z cells, ``<reader>.<mode>``."""
    card_z_benchmark(dst)
    bench = json.loads((dst / "BENCHMARK.json").read_text())
    for name, (unit, expr) in READERS.items():
        for mode, moves in (("optimize", "replica_sweeps_per_s"), ("solve", "solve_ms_per_sweep")):
            (dst / "ilpbench" / "metrics" / f"{name}.{mode}.py").write_text(
                "from ilpbench.trace import device_us\n\n\ndef read(run):\n"
                f"    t = run['trace']\n    return {expr} if t else None\n")
            bench["per_layer"].append({
                "name": f"{name}.{mode}", "unit": unit, "better": "lower",
                "source": "device_trace", "layer": "kernel B", "moves": moves,
                "workloads": [c for c in z_cells(Z_CARD) if c.endswith("." + mode)]})
    (dst / "BENCHMARK.json").write_text(json.dumps(bench))
    return dst


def run_cell(root: Path, cell: str, layout: str, seed: int, seconds: float, trace: bool,
             **kw) -> dict:
    """One run of ``cell`` on ``layout`` ("program" or "window"): the
    layout's DP rows, ``Wdp`` and ``z_needs_walk``, and the result line."""
    from ilpbench import run

    seen = {}

    def change(cp):
        cp = window_tables(cp) if layout == "window" else cp
        seen.update(dp_rows=0 if cp.dp_row is None else int(cp.dp_row.sum()), Wdp=cp.Wdp,
                    z_needs_walk=cp.z_needs_walk)
        return cp

    with program_layout(change):
        line = run.run(cell, seed, seconds, trace, root=root, **kw)
    return {"cell": cell, "layout": layout, "seed": seed, "trace": int(trace), **seen,
            "line": line}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--cells", default=",".join(z_cells(Z_CARD)))
    ap.add_argument("--layouts", default="program,window")
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--trace", default="0")
    ap.add_argument("--out", default="chiprun_out/card_z.jsonl")
    args = ap.parse_args(argv)
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory() as tmp:
        root = benchmark(Path(tmp))
        for cell in args.cells.split(","):
            for trace in (int(t) for t in args.trace.split(",")):
                for seed in (int(s) for s in args.seeds.split(",")):
                    for layout in args.layouts.split(","):
                        rec = run_cell(root, cell, layout, seed, args.seconds, bool(trace))
                        with out.open("a") as fh:
                            fh.write(json.dumps(rec) + "\n")
                        line = rec.pop("line")
                        rec.update(correct=line["correct"], metrics=line["metrics"],
                                   checks=line["checks"],
                                   memory_peak_bytes=line["device"]["memory_peak_bytes"])
                        print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
