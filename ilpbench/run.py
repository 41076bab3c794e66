"""Run one cell of the benchmark once.

    python3 -m ilpbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. Prints, as the last line of standard output,
one JSON object: ``correct``, ``attempted``, ``failed``, ``metrics`` (the
cell's end-to-end metrics, or with ``--trace 1`` its per-layer ones),
``device``, with ``--trace 1`` ``breakdown``, ``host`` (each rank's cores
and its host's speed after the window, ``host.py``), and last ``checks``: each
number the reference compared, with its limit (also the last lines of
standard error). Exits non-zero, and prints no result, without enough
CUDA devices or when JAX or the JAX package was loaded.

A cell on N chips runs one process per card in one NCCL process group
(this process is rank 0) that meets at a free TCP port on localhost.
Each rank keeps to cores of its own."""

from __future__ import annotations

import time

T_START = time.monotonic()

import argparse  # noqa: E402
import json  # noqa: E402
import multiprocessing  # noqa: E402
import socket  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from typing import Callable, List, Optional  # noqa: E402

from ilpbench import host, manifest  # noqa: E402

FORBIDDEN = {"jax", "jaxlib", "flax", "baryonyx_tpu"}
THREADS = 2  # torch threads per process: few, for steady host timings
JOIN_TIMEOUT_S = 120.0


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's,
    compared whole."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & FORBIDDEN)


def card_lines(count: int) -> List[str]:
    """Name and power limit of the cards used, from nvidia-smi."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=index,name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=True,
        ).stdout
    except (OSError, subprocess.SubprocessError) as e:
        return [f"nvidia-smi: {e}"]
    return out.strip().splitlines()[:count]


def _rank(rank: int, world: int, address: str, device_type: str, job: tuple,
          prepare: Optional[Callable], t_start: float, here: Path, control=None,
          cores: Optional[List[int]] = None):
    """One rank of a run: keep to its cores (a rank of its own process,
    when ``cores`` are given), join the group, run, hand the record to
    rank 0."""
    if rank and cores:
        host.pin(rank, world, cores)
    import torch
    import torch.distributed as dist

    from ilpbench import driver

    torch.set_num_threads(THREADS)
    if device_type == "cuda":
        device = torch.device("cuda", rank)
        torch.cuda.set_device(device)
        backend, kw = "nccl", {"device_id": device}
    else:
        device, backend, kw = torch.device("cpu"), "gloo", {}
    if world > 1:
        dist.init_process_group(backend, init_method=address, world_size=world, rank=rank, **kw)
    try:
        if prepare is not None:
            prepare()
        rec = driver.run_rank(*job, device=device, t_start=t_start, world=world, here=here,
                              control=control)
        if world == 1:
            return [rec]
        recs = [None] * world if rank == 0 else None
        dist.gather_object(rec, recs, dst=0)
        return recs
    finally:
        if world > 1:
            dist.destroy_process_group()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def run(cell_name: str, seed: int, seconds: float, trace: bool, device_type: str = "cuda",
        prepare: Optional[Callable] = None, root: Path = manifest.ROOT,
        control=None, cores: Optional[List[int]] = None) -> dict:
    """One run of the cell: every rank's window and checks, then the result
    line. ``prepare`` (tests) runs in every rank before the program;
    ``control`` (``control.py``): the float type of the reference's sweep
    that takes the program's place in the comparison; ``cores``: the
    host's cores, which the ranks other than this process's divide
    (``host.cores_for``)."""
    bench = manifest.load(root)
    cell = manifest.cell(bench, cell_name)
    config = manifest.config(bench, cell["config"], root)
    here = root / "ilpbench"
    traffic = manifest.traffic(cell["traffic"], here)
    world = cell["chips"]
    if traffic.get("ranks", 1) != world:
        raise ValueError(f"{cell_name}: traffic {cell['traffic']} runs {traffic.get('ranks', 1)} "
                         f"ranks, the cell asks for {world} chips")
    job = (config, traffic, seed, seconds, trace)
    address = f"tcp://localhost:{_free_port()}"
    mp = multiprocessing.get_context("spawn")
    children = [
        mp.Process(target=_rank,
                   args=(r, world, address, device_type, job, prepare, T_START, here, control,
                         cores))
        for r in range(1, world)
    ]
    for p in children:
        p.start()
    try:
        recs = _rank(0, world, address, device_type, job, prepare, T_START, here, control)
    finally:
        for p in children:
            p.join(JOIN_TIMEOUT_S)
            if p.is_alive():
                p.kill()
                p.join()
    if any(p.exitcode for p in children):
        raise RuntimeError(f"a rank failed: exit codes {[p.exitcode for p in children]}")
    return compose(bench, cell, config, traffic, seed, trace, recs, here)


def compose(bench, cell, config, traffic, seed, trace, recs, here) -> dict:
    """The result line from every rank's record."""
    import torch

    from ilpbench import driver
    from ilpbench.reference.exchange import exchange_mismatch
    from ilpbench.reference.lagrangian import lower_bound

    r0 = recs[0]
    objectives = r0["objectives"]
    reported = manifest.metrics_for(bench, cell["name"], trace)
    run_rec = {
        "mode": traffic["mode"], "ranks": len(recs), "seconds": r0["window_s"],
        "setup_s": r0["setup_s"], "window_s": r0["window_s"], "sweeps": r0["sweeps"],
        "replicas": r0["replicas"], "parse_s": r0["parse_s"],
        "solver_setup_s": r0["solver_setup_s"], "failed": r0["failed"],
        "objective": min(objectives) if objectives else None, "lb": None,
        "bound": r0.get("bound"), "dp_bound": r0.get("dp_bound"), "trace": r0.get("trace"),
    }
    if objectives and any(m["name"] == "gap_pct" for m in reported):
        run_rec["lb"] = lower_bound(driver.make_instance(config, seed, here),
                                    config["lagrangian_iterations"])
    if trace:
        run_rec["trace"] = dict(r0["trace"])
        run_rec["trace"]["busy_s"] = sum(r["trace"]["busy_s"] for r in recs) / len(recs)
    metrics = {}
    for m in reported:
        value = manifest.reader(m["name"], here)(run_rec)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    readings = {
        "infeasible_rows": sum(r["infeasible_rows"] for r in recs),
        "objective_err": max(r["objective_err"] for r in recs),
        "table_mismatch": _sum(r["table_mismatch"] for r in recs),
        "sweep_mismatch": _sum(r.get("control_sweep_mismatch", r["sweep_mismatch"])
                               for r in recs),
    }
    if len(recs) > 1:
        # every kept exchange of the window, worked out again (where the
        # ranks' best members are all alike an exchange takes nothing, and
        # leaving it out changes nothing)
        ex = [r["exchange"] for r in recs]
        bad, _ = exchange_mismatch(
            ex, r0["n_vars"],
            torch.device("cuda", 0) if r0["memory_peak_bytes"] else torch.device("cpu"))
        readings["exchange_mismatch"] = bad if min(map(len, ex)) else None
    limits = manifest.limits(here)
    checks = {k: {"value": v, "limit": limits[k]} for k, v in readings.items()}
    correct = all(c["value"] is not None and c["value"] <= c["limit"] for c in checks.values())
    device = {
        "platform": "gpu" if r0["memory_peak_bytes"] else "cpu",
        "kind": torch.cuda.get_device_name(0) if r0["memory_peak_bytes"] else "cpu",
        "count": len(recs),
        "memory_peak_bytes": max(r["memory_peak_bytes"] for r in recs),
    }
    line = {
        "correct": correct,
        "attempted": r0["attempted"],
        "failed": r0["failed"],
        "metrics": metrics,
        "device": device,
    }
    if trace:
        t = run_rec["trace"]
        device.update(busy_s=t["busy_s"], window_s=t["window_s"])
        line["breakdown"] = {"device_ops": t["device_ops"], "idle_gaps": t["idle_gaps"]}
    line["host"] = [r["host"] for r in recs]
    line["checks"] = checks
    return line


def _sum(values):
    values = list(values)
    return None if None in values else sum(values)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    chips = manifest.cell(manifest.load(), args.workload)["chips"]
    cores = host.all_cores()
    host.pin(0, chips, cores)

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"ilpbench: the cell needs {chips} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} available",
              file=sys.stderr)
        return 2
    for line in card_lines(chips):
        print(f"card: {line}", file=sys.stderr)
    line = run(args.workload, args.seed, args.seconds, bool(args.trace), cores=cores)
    found = forbidden_modules()
    if found:
        print(f"ilpbench: JAX or the JAX package was loaded: {', '.join(found)}", file=sys.stderr)
        return 3
    for h in line["host"]:
        print(f"host: {json.dumps(h)}", file=sys.stderr)
    for name, c in line["checks"].items():
        print(f"check {name} {c['value']} limit {c['limit']}", file=sys.stderr)
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())
