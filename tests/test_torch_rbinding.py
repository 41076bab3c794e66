"""The port's R-style binding against the JAX package's, on the CPU.

Both bindings take the same keywords and enum codes and return dicts with
the same keys; on a small set cover, in solve and in optimize mode, both
find a solution, with the same statuses, counts and sense. A missing file
takes the error path in both. The port's functions also take ``device``.
"""

import os

import pytest
import torch

from baryonyx_tpu import rbinding as jrb
from baryonyx_tpu.generators import random_set_cover_lp

from baryonyx_torch import rbinding as trb

KEYS = {"solution_found", "error_found", "value", "duration", "variables",
        "constraints", "remaining_constraints", "minimize", "solutions"}


@pytest.fixture(autouse=True)
def one_torch_thread():
    """Eager torch ops on these small tensors gain nothing from threads,
    and the test workers share the machine's cores: one thread each."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def lp_path(tmp_path):
    path = os.path.join(tmp_path, "scp.lp")
    with open(path, "w") as fh:
        fh.write(random_set_cover_lp(10, 30, 0.2, seed=5))
    return path


@pytest.mark.parametrize("entry", ["solve_01lp_problem", "optimize_01lp_problem"])
def test_binding_matches_jax(entry, lp_path):
    kw = dict(time_limit=2.0, seed=7, float_type=0, verbose=False)
    j = getattr(jrb, entry)(lp_path, **kw)
    t = getattr(trb, entry)(lp_path, device="cpu", **kw)
    assert set(t) == set(j) == KEYS
    for k in ("solution_found", "error_found", "variables", "constraints",
              "remaining_constraints", "minimize"):
        assert t[k] == j[k], k
    assert t["solution_found"] and not t["error_found"]
    assert t["remaining_constraints"] == 0 and t["solutions"]
    assert t["value"] == t["solutions"][-1] > 0


def test_binding_error_path_matches_jax(tmp_path):
    missing = os.path.join(tmp_path, "missing.lp")
    j = jrb.solve_01lp_problem(missing, verbose=False)
    t = trb.solve_01lp_problem(missing, verbose=False, device="cpu")
    assert {k: v for k, v in t.items() if k != "duration"} == {
        k: v for k, v in j.items() if k != "duration"
    }
    assert t["error_found"] and not t["solution_found"]


def test_binding_enum_tables_match_jax():
    for name in ("_PRE_ORDER", "_ORDER", "_NORM", "_INIT", "_FLOAT", "_STORAGE"):
        assert [e.name for e in getattr(trb, name)] == [
            e.name for e in getattr(jrb, name)
        ], name
