"""The port's public surface against the JAX package's (no solver runs).

- ``baryonyx_torch`` exports every name that ``baryonyx_tpu/__init__.py``
  imports or defines for its users (the model's types among them).
- Every module of ``baryonyx_tpu/`` has its counterpart at the same
  path under ``baryonyx_torch/``, holding every top-level function,
  class and assigned name of it (defined there or imported), but for an
  explicit allow-list of Pallas-only machinery and private details whose
  role the port fills another way, each with its reason.
- The memory helpers (``memory_consumed_size``, ``to_string``,
  ``memory_consumed``, ``compiled_memory_consumed``) give the JAX
  package's numbers on the same problems: raw and preprocessed, 0/1, Z
  and quadratic, and the compiled layouts of each package.
"""

import ast
import dataclasses
from pathlib import Path

import pytest

import baryonyx_tpu as bx
from baryonyx_tpu import memory as jmem
from baryonyx_tpu.generators import (
    n_queens_lp,
    random_qsap_lp,
    random_set_cover_lp,
    random_z_multiknapsack_lp,
)
from baryonyx_tpu.ops.layout import compile_problem as jcompile
from baryonyx_tpu.preprocess.fixing import preprocess as jpreprocess
from baryonyx_tpu.preprocess.merge import make_merged_constraints as jmerge

import baryonyx_torch as bt
from baryonyx_torch import memory as tmem
from baryonyx_torch.ops.layout import compile_problem as tcompile
from baryonyx_torch.preprocess.fixing import preprocess as tpreprocess
from baryonyx_torch.preprocess.merge import make_merged_constraints as tmerge

JAX_INIT = Path(bx.__file__)


def _public_names():
    """Names ``baryonyx_tpu/__init__.py`` imports or defines, minus the
    private ones."""
    tree = ast.parse(JAX_INIT.read_text())
    names = set()
    for node in tree.body:
        if isinstance(node, ast.ImportFrom):
            names.update(a.asname or a.name for a in node.names)
        elif isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            names.add(node.name)
        elif isinstance(node, ast.Assign):
            names.update(t.id for t in node.targets if isinstance(t, ast.Name))
    return sorted(n for n in names if not n.startswith("_") or n == "__version__")


def test_the_port_exports_every_name_of_the_jax_package():
    names = _public_names()
    assert {"Constraint", "FunctionElement", "ObjectiveFunction",
            "ObjectiveQuadraticTerm", "OperatorType", "ProblemSolverType",
            "VariableType", "solve", "optimize"} <= set(names)
    missing = [n for n in names if not hasattr(bt, n)]
    assert not missing, f"baryonyx_torch lacks {missing}"
    # the model's types are the port's own, with the JAX package's members
    for n in ("OperatorType", "ProblemSolverType", "VariableType", "ObjectiveType"):
        assert getattr(bt, n).__module__.startswith("baryonyx_torch")
        assert [m.name for m in getattr(bt, n)] == [m.name for m in getattr(bx, n)]
    for n in ("Constraint", "FunctionElement", "ObjectiveFunction",
              "ObjectiveQuadraticTerm"):
        assert [f.name for f in dataclasses.fields(getattr(bt, n))] == [
            f.name for f in dataclasses.fields(getattr(bx, n))]


@pytest.mark.parametrize("size", [0, 1, 511, 513, 2048, 700_000, 3 << 20, 5 << 29, 7 << 32])
def test_size_helpers_match_jax(size):
    assert tmem.memory_consumed_size(size) == jmem.memory_consumed_size(size)
    assert tmem.to_string(size) == jmem.to_string(size)


LPS = {
    "set_cover": lambda: random_set_cover_lp(30, 90, 0.08, seed=2),
    "n_queens": lambda: n_queens_lp(6),
    "z_multiknapsack": lambda: random_z_multiknapsack_lp(12, 40, seed=2),
    "qsap": lambda: random_qsap_lp(6, 4, seed=2),
}


@pytest.mark.parametrize("name", list(LPS))
def test_memory_consumed_matches_jax(name):
    lp = LPS[name]()
    raw_j, raw_t = bx.parse_lp(lp), bt.parse_lp(lp)
    assert tmem.memory_consumed(raw_t) == jmem.memory_consumed(raw_j) > 1000
    ctx_j, ctx_t = bx.make_context(0), bt.make_context(0)
    pb_j, pb_t = jpreprocess(ctx_j, raw_j), tpreprocess(ctx_t, raw_t)
    assert tmem.memory_consumed(pb_t) == jmem.memory_consumed(pb_j)

    jcp = jcompile(jmerge(ctx_j, pb_j), len(pb_j.vars.values),
                   qelements=pb_j.objective.qelements)
    tcp = tcompile(tmerge(ctx_t, pb_t), len(pb_t.vars.values),
                   qelements=pb_t.objective.qelements, device="cpu")
    got = tmem.compiled_memory_consumed(tcp)
    assert got == jmem.compiled_memory_consumed(jcp) > 0
    if name == "z_multiknapsack":
        assert tcp.assign_bits is not None
    if name == "qsap":
        assert tcp.quad_var is not None


JAX_PKG = JAX_INIT.parent
PORT_PKG = Path(bt.__file__).parent

# JAX modules the port has no counterpart of, and why
NO_COUNTERPART = {
    "runtime.py": "JAX's persistent compilation cache and backend set-up; "
                  "kernels.py's build cache (build/kernels/) fills the role",
}

# names of a JAX module the port's counterpart does not have, and why
NOT_PORTED = {
    "ops/psweep.py": {
        "LANE": "the TPU's lane width; the CUDA plan counts warps (WARP)",
        "PsweepPlan": "the VMEM/SMEM plan; SweepPlan fills its role",
        "SMEM_BUDGET": "a TPU memory budget; the CUDA plan has SMEM_MAX",
        "VMEM_BUDGET": "a TPU memory budget; the CUDA plan has SMEM_MAX",
        "_insert_max": "the Pallas kernel's order statistics; csrc/psweep.cu",
        "_insert_min": "the Pallas kernel's order statistics; csrc/psweep.cu",
        "_make_kernel": "the Pallas kernel (A); csrc/psweep.cu",
        "_psweep_call": "its pallas_call; CudaSweep launches kernel A",
        "_smem_table_bytes": "the TPU plan's arithmetic; _group_smem_bytes",
        "_table_chunks": "the TPU plan's arithmetic; launch_plan",
        "_vmem_bytes": "the TPU plan's arithmetic; _group_smem_bytes",
        "enabled_mode": "BARYONYX_PALLAS, deliberately not ported: its "
                        "interpret and force mean nothing on CUDA, and off "
                        "would route the main path away from kernel A",
        "plan": "the TPU plan; launch_plan",
    },
    "ops/sweep.py": {
        "_onehot_gather": "TPU gathers as one-hot products; torch indexes",
        "_onehot_scatter_add": "TPU scatters as one-hot products; add_rows_",
    },
    "ops/zsweep.py": {
        "_DP_BIG": "one infinity for float32; dp_big(dtype) gives both",
        "_dp_dispatch": "the Pallas/XLA choice; dp_select dispatches",
        "_dp_select": "the XLA DP; dp_select_reference",
        "_dp_select_pallas": "the Pallas kernel (B); csrc/dpselect.cu",
    },
    "parallel/rowshard.py": {
        "_squeeze_cp": "shard_map's per-device view; a rank holds its "
                       "shard (shard_of)",
    },
    "solver/optimize.py": {
        "_evolve_impl": "the jitted body; one_step and evolve",
        "evolve_sharded": "shard_map over devices; evolve over a process "
                          "group (EvolveInputs.mesh)",
    },
    "solver/solve.py": {"_finalize": "solver/common.py:finalize"},
    "native/build.py": {
        "_LIB": "the loaded library; _loaded, keyed by the library's path",
        "_TRIED": "the failed build; _loaded keeps None for it",
    },
}


def _top_level(path: Path, imported: bool):
    """Top-level functions, classes and assigned names of a module, and
    with ``imported`` the names it imports."""
    names = set()
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            names.add(node.name)
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = node.targets if isinstance(node, ast.Assign) else [node.target]
            for t in targets:
                for e in (t.elts if isinstance(t, ast.Tuple) else [t]):
                    if isinstance(e, ast.Name):
                        names.add(e.id)
        elif imported and isinstance(node, (ast.Import, ast.ImportFrom)):
            names.update((a.asname or a.name).split(".")[0] for a in node.names)
    return names


JAX_MODULES = sorted(str(p.relative_to(JAX_PKG)) for p in JAX_PKG.rglob("*.py"))


@pytest.mark.parametrize("rel", JAX_MODULES)
def test_every_module_has_its_counterpart(rel):
    if rel in NO_COUNTERPART:
        assert not (PORT_PKG / rel).exists()
        return
    port = PORT_PKG / rel
    assert port.is_file(), f"baryonyx_torch lacks {rel}"
    want = _top_level(JAX_PKG / rel, imported=False)
    have = _top_level(port, imported=True)
    allowed = NOT_PORTED.get(rel, {})
    assert not (want - have) - allowed.keys(), f"{rel} lacks {sorted(want - have)}"
    # the allow-list names only what is really missing
    assert not allowed.keys() & have, f"{rel}: {sorted(allowed.keys() & have)}"
    assert allowed.keys() <= want


def test_the_allow_lists_name_real_modules():
    assert set(NOT_PORTED) | set(NO_COUNTERPART) <= set(JAX_MODULES)
    assert all(reason for names in NOT_PORTED.values() for reason in names.values())

