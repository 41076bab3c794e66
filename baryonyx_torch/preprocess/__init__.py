"""Preprocessing: variable fixing, constraint merging, product folding.

reference: lib/src/preprocessor.cpp, lib/src/merged-constraint.cpp.
"""

from baryonyx_torch.preprocess.fixing import affect, preprocess, split, unpreprocess
from baryonyx_torch.preprocess.merge import MergedConstraint, make_merged_constraints
