"""I/O: the CPLEX LP-format reader and writer and the solution files
(pure Python).

reference: lib/src/parser.cpp.
"""

from baryonyx_torch.io.lp_parse import make_problem, parse_lp
from baryonyx_torch.io.lp_write import write_problem
from baryonyx_torch.io.sol_io import make_result, write_result
