"""Library façade: preprocessing + mode routing.

reference: lib/src/lpcore.cpp:88-132 (solve/optimize entry points) and
lib/src/itm.hpp:94-254 (dispatch on problem type / solver type / meta mode).
"""

from __future__ import annotations

from baryonyx_torch.core.context import Context
from baryonyx_torch.core.model import Problem, RawProblem
from baryonyx_torch.core.params import ModeType, PreprocessorOptions
from baryonyx_torch.core.result import Result
from baryonyx_torch.device import DeviceLike, resolve_device
from baryonyx_torch.preprocess.fixing import preprocess as _preprocess
from baryonyx_torch.preprocess.fixing import unpreprocess as _unpreprocess
from baryonyx_torch.preprocess.products import fold_linearized_products


def _prepare(ctx: Context, raw: RawProblem) -> Problem:
    params = ctx.parameters
    if params.preprocessor == PreprocessorOptions.all:
        return fold_linearized_products(ctx, _preprocess(ctx, raw))
    return _unpreprocess(ctx, raw)


def solve(ctx: Context, raw: RawProblem, device: DeviceLike = None) -> Result:
    """reference: lpcore.cpp:88-98. Runs on CUDA unless ``device="cpu"``;
    raises when CUDA is missing and no device is given."""
    dev = resolve_device(device)
    if ctx.start_cb:
        ctx.start_cb(ctx.parameters)
    ctx.parameters = ctx.parameters.validated()
    pb = _prepare(ctx, raw)
    from baryonyx_torch.solver.solve import solve_compiled

    return solve_compiled(ctx, pb, device=dev)


def optimize(ctx: Context, raw: RawProblem, device: DeviceLike = None) -> Result:
    """reference: lpcore.cpp:100-132. Runs on CUDA unless
    ``device="cpu"``; raises when CUDA is missing and no device is given."""
    dev = resolve_device(device)
    if ctx.start_cb:
        ctx.start_cb(ctx.parameters)
    ctx.parameters = ctx.parameters.validated()
    if ctx.parameters.mode & (ModeType.branch | ModeType.nlopt | ModeType.manual):
        raise NotImplementedError(
            "the meta-optimizer modes are not ported to the PyTorch solver "
            "yet (ROADMAP.md Queue 1 item 10)"
        )
    pb = _prepare(ctx, raw)
    from baryonyx_torch.solver.optimize import optimize_compiled

    return optimize_compiled(ctx, pb, device=dev)
