"""The control of a cell's comparison: the reference's sweep, worked out
in the float type below the configuration's (bfloat16 for float32), put
in the program's place at a state kept from a run at the cell's own size.
It has to come out not correct.

    python3 -m ilpbench.control --workload <cell> --seeds 1,2,3 --seconds 5

prints, per seed, the program's reading and the control's, each beside
its limit. The benchmark's own runs do not run it."""

from __future__ import annotations

import argparse
import json
import sys

import torch

from ilpbench import run

LOWER = {"float32": torch.bfloat16, "float64": torch.float32}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=5.0)
    args = ap.parse_args(argv)
    from ilpbench import manifest

    bench = manifest.load()
    cell = manifest.cell(bench, args.workload)
    dtype = LOWER[manifest.config(bench, cell["config"])["float_type"]]
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print("ilpbench.control: not enough CUDA devices", file=sys.stderr)
        return 2
    for seed in (int(s) for s in args.seeds.split(",")):
        line = run.run(args.workload, seed, args.seconds, False, control=dtype)
        print(json.dumps({"workload": args.workload, "seed": seed, "control": str(dtype),
                          "correct": line["correct"], "checks": line["checks"]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
