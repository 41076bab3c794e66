"""Command-line interface.

Mirrors the reference CLI (reference: app/src/main.cpp — arg parsing
:895-1007, parameter assignment :565-893, callback wiring :64-238, result
file writing :1240-1270, --check :1227-1239):

  python -m baryonyx_torch [options] file.lp [file2.lp ...]

  --optimize | -O            optimize mode (default: feasibility solve)
  --param | -p name:value    set a solver parameter
  --limit int                loop limit
  --time-limit float         wall-clock limit (seconds)
  --disable-preprocessing | -np
  --device cuda|cpu|cuda:N   where the solver runs (default: the first
                             CUDA device; there is no quiet drop to the
                             CPU when none is present)
  --auto:manual|nlopt|branch meta-optimizer mode
  --check file.sol           validate a solution file against the model
  --warmup                   build and load the CUDA kernels the instance
                             needs and run it for 0.2 s (no result file);
                             later runs find the kernels built
  --random                   random baseline solver
  --bench file.csv           benchmark harness over a CSV suite
  --quiet / --verbose | -v N logging
  --seed int, --thread int (replicas), --block-size int

Single-file mode writes ``<file>-<pid>.sol``; multi-file mode appends to
``baryonyx-<pid>.res`` (reference: main.cpp:1240-1360).

On N cards of one host, one process each:

  torchrun --nproc-per-node=N -m baryonyx_torch --optimize file.lp

Under torchrun (``WORLD_SIZE`` > 1) every process joins one process group
(NCCL; gloo with ``--device cpu``) and runs its share of the replicas on
card ``LOCAL_RANK``; only rank 0 prints and writes the result file.
"""

from __future__ import annotations

import os
import sys
import time
from typing import List, Optional

import baryonyx_torch as bx
from baryonyx_torch.core.params import (
    ConstraintOrder,
    CostNormType,
    FloatType,
    InitPolicyType,
    ModeType,
    ObserverType,
    PreConstraintOrder,
    PreprocessorOptions,
    SolverParameters,
    SolverType,
    StorageType,
)

_ENUM_PARAMS = {
    "preprocessing": (
        "pre_order",
        {
            "none": PreConstraintOrder.none,
            "memory": PreConstraintOrder.memory,
            "less-greater-equal": PreConstraintOrder.less_greater_equal,
            "less-equal-greater": PreConstraintOrder.less_equal_greater,
            "greater-less-equal": PreConstraintOrder.greater_less_equal,
            "greater-equal-less": PreConstraintOrder.greater_equal_less,
            "equal-less-greater": PreConstraintOrder.equal_less_greater,
            "equal-greater-less": PreConstraintOrder.equal_greater_less,
            "p1": PreConstraintOrder.p1,
            "p2": PreConstraintOrder.p2,
            "p3": PreConstraintOrder.p3,
            "p4": PreConstraintOrder.p4,
        },
    ),
    "constraint-order": (
        "order",
        {
            "none": ConstraintOrder.none,
            "reversing": ConstraintOrder.reversing,
            "random-sorting": ConstraintOrder.random_sorting,
            "infeasibility-decr": ConstraintOrder.infeasibility_decr,
            "infeasibility-incr": ConstraintOrder.infeasibility_incr,
            "lagrangian-decr": ConstraintOrder.lagrangian_decr,
            "lagrangian-incr": ConstraintOrder.lagrangian_incr,
            "pi-sign-change": ConstraintOrder.pi_sign_change,
            "cycle": ConstraintOrder.cycle,
        },
    ),
    "norm": (
        "cost_norm",
        {
            "none": CostNormType.none,
            "random": CostNormType.random,
            "l1": CostNormType.l1,
            "l2": CostNormType.l2,
            "loo": CostNormType.loo,
        },
    ),
    "init-policy": (
        "init_policy",
        {
            "bastert": InitPolicyType.bastert,
            "pessimistic-solve": InitPolicyType.pessimistic_solve,
            "optimistic-solve": InitPolicyType.optimistic_solve,
        },
    ),
    "floating-point-type": (
        "float_type",
        {
            "float": FloatType.float32,
            "double": FloatType.float64,
            "longdouble": FloatType.float64,
        },
    ),
    "observer-type": (
        "observer",
        {
            "none": ObserverType.none,
            "pnm": ObserverType.pnm,
            "file": ObserverType.file,
        },
    ),
    "storage-type": (
        "storage",
        {
            "one": StorageType.one,
            "bound": StorageType.bound,
            "five": StorageType.five,
        },
    ),
}

_SCALAR_PARAMS = {
    # reference: assign_parameter, main.cpp:565-893
    "limit": ("limit", int),
    "time-limit": ("time_limit", float),
    "theta": ("theta", float),
    "delta": ("delta", float),
    "kappa-min": ("kappa_min", float),
    "kappa-step": ("kappa_step", float),
    "kappa-max": ("kappa_max", float),
    "alpha": ("alpha", float),
    "w": ("w", float),
    "seed": ("seed", int),
    "thread": ("thread", int),
    "print-level": ("print_level", int),
    "pushes-limit": ("pushes_limit", int),
    "pushing-objective-amplifier": ("pushing_objective_amplifier", float),
    "pushing-iteration-limit": ("pushing_iteration_limit", int),
    "pushing-k-factor": ("pushing_k_factor", float),
    "init-policy-random": ("init_policy_random", float),
    "init-population-size": ("init_population_size", int),
    "init-crossover-bastert-insertion": ("init_crossover_bastert_insertion", float),
    "init-crossover-solution-selection-mean": (
        "init_crossover_solution_selection_mean",
        float,
    ),
    "init-crossover-solution-selection-stddev": (
        "init_crossover_solution_selection_stddev",
        float,
    ),
    "init-mutation-variable-mean": ("init_mutation_variable_mean", float),
    "init-mutation-variable-stddev": ("init_mutation_variable_stddev", float),
    "init-mutation-value-mean": ("init_mutation_value_mean", float),
    "init-mutation-value-stddev": ("init_mutation_value_stddev", float),
    "init-kappa-improve-start": ("init_kappa_improve_start", float),
    "init-kappa-improve-increase": ("init_kappa_improve_increase", float),
    "init-kappa-improve-stop": ("init_kappa_improve_stop", float),
    # device-specific
    "block-size": ("block_size", int),
    "chunk-size": ("chunk_size", int),
}


def assign_parameter(params: SolverParameters, name: str, value: str) -> bool:
    """Set one ``--param name:value`` (reference: main.cpp:565-893)."""
    if name in _SCALAR_PARAMS:
        attr, conv = _SCALAR_PARAMS[name]
        try:
            setattr(params, attr, conv(value))
            return True
        except ValueError:
            return False
    if name in _ENUM_PARAMS:
        attr, mapping = _ENUM_PARAMS[name]
        if value in mapping:
            setattr(params, attr, mapping[value])
            return True
        return False
    return False


def _print_result_summary(ctx, res, pb) -> None:
    ctx.notice("- Solver finished: {}\n", res.status.name)
    if res.solutions:
        from baryonyx_torch.validate import is_valid_solution

        ctx.notice("  - Objective value: {}\n", res.solutions[-1].value)
        ctx.notice("  - Checked: {}\n", is_valid_solution(pb, res))


def main(argv: Optional[List[str]] = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    params = SolverParameters()
    verbose = 5
    optimize = False
    check_file: Optional[str] = None
    warmup = False
    bench_csv: Optional[str] = None
    bench_name = "bx-torch"
    device: Optional[str] = None
    files: List[str] = []

    i = 0
    while i < len(argv):
        arg = argv[i]
        if arg in ("--help", "-h"):
            print(__doc__)
            return 0
        elif arg in ("--optimize", "-O"):
            optimize = True
        elif arg in ("--disable-preprocessing", "-np"):
            params.preprocessor = PreprocessorOptions.none
        elif arg == "--random":
            params.solver = SolverType.random
        elif arg.startswith("--auto:") or arg.startswith("-a:"):
            mode = arg.split(":", 1)[1]
            optimize = True
            if mode == "manual":
                params.mode = ModeType.manual
            elif mode == "nlopt":
                params.mode = ModeType.nlopt
            elif mode == "branch":
                params.mode = ModeType.branch
            else:
                print(f"unknown auto mode {mode!r}", file=sys.stderr)
                return 1
        elif arg in ("--param", "-p"):
            i += 1
            kv = argv[i]
            for sep in (":", "="):
                if sep in kv:
                    name, _, value = kv.partition(sep)
                    break
            else:
                name, value = kv, ""
            if not assign_parameter(params, name, value):
                print(f"bad parameter {kv!r}", file=sys.stderr)
                return 1
        elif arg == "--limit":
            i += 1
            params.limit = int(argv[i])
        elif arg == "--time-limit":
            i += 1
            params.time_limit = float(argv[i])
        elif arg == "--seed":
            i += 1
            params.seed = int(argv[i])
        elif arg == "--check":
            i += 1
            check_file = argv[i]
        elif arg in ("--bench", "-b"):
            i += 1
            bench_csv = argv[i]
        elif arg == "--name":
            i += 1
            bench_name = argv[i]
        elif arg == "--quiet":
            verbose = 3
        elif arg in ("--verbose", "-v"):
            i += 1
            verbose = int(argv[i])
        elif arg == "--debug":
            params.debug = True
        elif arg == "--warmup":
            warmup = True
        elif arg == "--device":
            i += 1
            device = argv[i]
        elif arg.startswith("-"):
            print(f"unknown option {arg!r}", file=sys.stderr)
            return 1
        else:
            files.append(arg)
        i += 1

    rank0 = True
    in_group = int(os.environ.get("WORLD_SIZE", "1")) > 1
    if in_group:
        # torchrun: one process per card; rank 0 speaks and writes
        from baryonyx_torch.parallel import distributed

        distributed.init_distributed(
            device=None if device in (None, "cuda") else device
        )
        rank0 = distributed.rank() == 0
        if not rank0:
            verbose = 0
    try:
        return _run_files(
            params, verbose, optimize, check_file, warmup, bench_csv,
            bench_name, device, files, rank0,
        )
    finally:
        if in_group:
            distributed.shutdown()


def _run_files(
    params, verbose, optimize, check_file, warmup, bench_csv, bench_name,
    device, files, rank0,
) -> int:
    ctx = bx.make_context(verbose)
    ctx.set_parameters(params)
    if verbose >= 5:
        # the reference CLI echoes every parameter at start unless -q
        # (reference: solver_started_cb, main.cpp:64-238)
        from baryonyx_torch.core.out import format_parameters

        ctx.start_cb = lambda p: print(format_parameters(p), end="")

    if bench_csv:
        from baryonyx_torch.bench.harness import benchmark

        return benchmark(ctx, bench_csv, bench_name, device=device)

    if not files:
        print("no model file given", file=sys.stderr)
        return 1

    def run(c, pb):
        mode = bx.optimize if optimize else bx.solve
        return mode(c, pb, device=device)

    rc = 0
    multi = len(files) > 1
    res_path = f"baryonyx-{os.getpid()}.res"
    for path in files:
        try:
            pb = bx.make_problem(ctx, path)
        except bx.BaryonyxError as e:
            print(f"{path}: {e}", file=sys.stderr)
            rc = 1
            continue

        if check_file:
            # reference: main.cpp:1227-1239
            from baryonyx_torch.validate import compute_solution, is_valid_solution

            res = bx.make_result(ctx, check_file)
            ok = is_valid_solution(pb, res)
            print(f"{check_file}: {'valid' if ok else 'INVALID'}")
            if ok:
                print(f"objective: {compute_solution(pb, res)}")
            continue

        if warmup:
            # Build and load the kernels this instance's path needs (they
            # are cached on disk by source hash) and run it briefly, without
            # writing a result.
            t0 = time.monotonic()
            import copy as _copy

            wctx = bx.make_context(min(verbose, 4))
            wp = _copy.copy(ctx.parameters)
            wp.time_limit = 0.2
            wctx.set_parameters(wp)
            try:
                run(wctx, pb)
            except NotImplementedError as e:
                print(f"{path}: {e}", file=sys.stderr)
                return 1
            ctx.notice(
                "- warmed {} ({} mode) in {:.1f}s\n",
                path,
                "optimize" if optimize else "solve",
                time.monotonic() - t0,
            )
            continue

        t0 = time.monotonic()
        started = time.strftime("%Y-%m-%d %X")
        try:
            res = run(ctx, pb)
        except NotImplementedError as e:
            print(f"{path}: {e}", file=sys.stderr)
            return 1
        finished = time.strftime("%Y-%m-%d %X")
        _print_result_summary(ctx, res, pb)

        if multi and rank0:
            with open(res_path, "a") as fh:
                value = res.solutions[-1].value if res.solutions else float("nan")
                fh.write(
                    f"{path} {res.status.name} {value} "
                    f"{time.monotonic() - t0:.3f}\n"
                )
        elif rank0:
            # reference: main.cpp:1240-1270 — problem-statistics resume
            # block, start/finish timestamps, then the result resume
            from baryonyx_torch.io.sol_io import problem_resume

            sol_path = f"{path}-{os.getpid()}.sol"
            with open(sol_path, "w") as fh:
                fh.write(f"\\ solver..........: baryonyx-torch {bx.__version__}\n")
                fh.write(problem_resume(pb))
                fh.write(f"\\ solver starts: {started}\n")
                fh.write(f"\\ solver finishes: {finished}\n")
                if res.status == bx.ResultStatus.success and res.solutions:
                    fh.write(f"\\ Solution found: {res.solutions[-1].value:f}\n")
                else:
                    fh.write(
                        "\\ Solution not found. Missing constraints: "
                        f"{res.remaining_constraints}\n"
                    )
                bx.write_result(res, fh)
            ctx.notice("- solution written to {}\n", sol_path)
        if res.status != bx.ResultStatus.success:
            rc = 1
    return rc


if __name__ == "__main__":
    raise SystemExit(main())
