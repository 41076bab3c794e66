"""baryonyx_torch: the 0-1 integer linear program solver in PyTorch, with
its fused sweep and its knapsack DP row selector (for rows with integer
factors) as hand-written CUDA kernels for Hopper.

A Wedelin-style Lagrangian dual-descent heuristic (reference:
quesnel/baryonyx v0.5.0). This package imports torch, numpy and the
standard library only.

- ``make_context``, ``parse_lp``, ``make_problem``: the LP reader;
- ``optimize(ctx, problem, device=None)``: the evolutionary multi-start
  optimizer, on the first CUDA device unless ``device="cpu"``;
- ``is_valid_solution``, ``compute_solution``: the numpy oracle.
"""

from baryonyx_torch.core.context import Context, make_context
from baryonyx_torch.core.errors import (
    BaryonyxError,
    FileFormatError,
    ProblemDefinitionError,
    SolverError,
)
from baryonyx_torch.core.model import ObjectiveType, Problem, RawProblem
from baryonyx_torch.core.params import (
    ConstraintOrder,
    CostNormType,
    FloatType,
    ModeType,
    PreprocessorOptions,
    SolverParameters,
    SolverType,
    StorageType,
)
from baryonyx_torch.core.result import Result, ResultStatus, Solution
from baryonyx_torch.io.lp_parse import make_problem, parse_lp
from baryonyx_torch.solver.api import optimize, solve
from baryonyx_torch.validate import compute_solution, is_valid_solution

__version__ = "0.1.0"
