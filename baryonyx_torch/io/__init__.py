"""I/O: the CPLEX LP-format reader (pure Python).

reference: lib/src/parser.cpp.
"""

from baryonyx_torch.io.lp_parse import make_problem, parse_lp
