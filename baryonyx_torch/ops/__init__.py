"""Device-side compute: the padded problem layout and the Wedelin sweep.

reference: lib/src/itm-solver-*.cpp, lib/src/itm-common.hpp,
lib/src/sparse-matrix.hpp, re-designed as masked dense updates over a
padded row/column layout.
"""

from baryonyx_torch.ops.layout import CompiledProblem, compile_problem
