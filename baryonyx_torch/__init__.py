"""baryonyx_torch: the 0-1 integer linear program solver in PyTorch, with
its fused sweep and its knapsack DP row selector (for rows with integer
factors) as hand-written CUDA kernels for Hopper.

A Wedelin-style Lagrangian dual-descent heuristic (reference:
quesnel/baryonyx v0.5.0). This package imports torch, numpy and the
standard library only.

- ``make_context``, ``parse_lp``, ``make_problem``, ``write_problem``: the
  LP reader and writer; ``make_result``, ``write_result``: solution files;
- ``solve(ctx, problem, device=None)``: one kappa-annealed run to a
  feasible solution plus the push phase;
- ``optimize(ctx, problem, device=None)``: the evolutionary multi-start
  optimizer (linear or quadratic objectives), or the meta-optimizer mode
  that ``ctx.parameters.mode`` names (manual grid, Nelder-Mead, branch);
  both run on the first CUDA device unless ``device="cpu"``;
- ``is_valid_solution``, ``compute_solution``: the numpy oracle;
- ``python -m baryonyx_torch file.lp``: the command line (cli.py);
  ``baryonyx_torch.rbinding``: the R-style binding.
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
    InitPolicyType,
    ModeType,
    ObserverType,
    PreConstraintOrder,
    PreprocessorOptions,
    SolverParameters,
    SolverType,
    StorageType,
)
from baryonyx_torch.core.result import Result, ResultStatus, Solution
from baryonyx_torch.io.lp_parse import make_problem, parse_lp
from baryonyx_torch.io.lp_write import write_problem
from baryonyx_torch.io.sol_io import make_result, write_result
from baryonyx_torch.solver.api import optimize, solve
from baryonyx_torch.validate import (
    compute_min_max_objective_function,
    compute_solution,
    is_valid_solution,
)

__version__ = "0.1.0"
