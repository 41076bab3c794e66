"""Parity of the PyTorch port's host pipeline and padded layout with the
JAX package: parse_lp → preprocess → make_merged_constraints →
compile_problem, each package through its own code, must give equal
CompiledProblem fields (exact: the layout is integer bookkeeping and an
f64 → f32 cast of the same factors)."""

import dataclasses

import numpy as np
import pytest
import torch

import baryonyx_tpu.core.context as jctx
import baryonyx_tpu.io.lp_parse as jlp
import baryonyx_tpu.ops.layout as jlayout
import baryonyx_tpu.preprocess.fixing as jfix
import baryonyx_tpu.preprocess.merge as jmerge
from baryonyx_tpu.generators import (
    n_queens_lp,
    random_knapsack_101_lp,
    random_set_cover_lp,
    random_z_multiknapsack_lp,
)

import baryonyx_torch.core.context as tctx
import baryonyx_torch.io.lp_parse as tlp
import baryonyx_torch.ops.layout as tlayout
import baryonyx_torch.preprocess.fixing as tfix
import baryonyx_torch.preprocess.merge as tmerge

INSTANCES = {
    "scp": lambda: random_set_cover_lp(40, 160, 0.06, seed=5),
    "nqueens": lambda: n_queens_lp(8),
    "knapsack101": lambda: random_knapsack_101_lp(16, 40, seed=3),
    "zmultiknapsack": lambda: random_z_multiknapsack_lp(12, 40, seed=2),
}


def compile_both(lp: str):
    ctx = jctx.make_context(0)
    pb = jfix.preprocess(ctx, jlp.parse_lp(lp))
    jcp = jlayout.compile_problem(
        jmerge.make_merged_constraints(ctx, pb), len(pb.vars.values)
    )
    ctx = tctx.make_context(0)
    pb = tfix.preprocess(ctx, tlp.parse_lp(lp))
    tcp = tlayout.compile_problem(
        tmerge.make_merged_constraints(ctx, pb), len(pb.vars.values),
        device="cpu",
    )
    return jcp, tcp


@pytest.mark.parametrize("name", list(INSTANCES))
def test_compiled_problem_fields_equal(name):
    jcp, tcp = compile_both(INSTANCES[name]())
    if name == "knapsack101":
        assert not tcp.all_unit_pos and not tcp.has_z
    if name == "zmultiknapsack":
        assert tcp.has_z and tcp.dp_row is not None
    for f in dataclasses.fields(jcp):
        a = getattr(jcp, f.name)
        b = getattr(tcp, f.name)
        if a is None:
            assert b is None, f.name
        elif isinstance(b, torch.Tensor):
            a = np.asarray(a)
            assert b.device.type == "cpu"
            assert tuple(b.shape) == a.shape, f.name
            assert b.numpy().dtype == a.dtype, f.name
            np.testing.assert_array_equal(b.numpy(), a, err_msg=f.name)
        else:
            assert a == b, f.name
