"""Both packages' optimize over a set of seeds, and the rule that holds
the port's mean objective to the JAX package's
(``tests/test_torch_quality_parity_*.py``).

Every seed goes to both packages at a fixed sweep budget (``limit``
200, ``thread`` 16, no time limit). Each (instance, seed) must show: both
runs succeed, the port's solution is valid under the JAX package's
validator, and ``compute_solution`` equals the port's value. Each
instance must show: the gap between the two means over the seeds is at
most max(5% of the JAX mean, 3 standard errors of the difference of the
means), the standard error from the two packages' own spreads over the
seeds (sample variances, n - 1). On the CPU both packages are
deterministic for a seed, so the check is steady.

The JAX side runs in a subprocess on one CPU device, as the port runs in
one process: the tests' JAX process has 8 virtual devices
(``tests/conftest.py``), on which the JAX optimizer shards 16 replicas
into 8 populations of 2 replicas each, a different configuration (on
zknap24x90 its means over seeds 1-6 are 10-15% worse than on one
device). The subprocess starts first and runs beside the port's runs.

Run as a script, it is that subprocess: the path of a JSON file with an
LP and seeds as its argument, one JSON line per seed on stdout.
"""

import json
import math
import os
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import pytest

import baryonyx_tpu as bx
import baryonyx_torch as bt

SEEDS = (1, 2, 3, 4, 5, 6)
LIMIT = 200
THREAD = 16
REL = 0.05  # of the JAX mean
N_SE = 3.0  # standard errors of the difference of the means
JAX_TIMEOUT_S = 600
REPO = Path(__file__).resolve().parent.parent


def _ctx(mod, seed: int):
    ctx = mod.make_context(0)
    ctx.parameters.seed = seed
    ctx.parameters.limit = LIMIT  # no time limit: a fixed sweep budget
    ctx.parameters.thread = THREAD
    return ctx


def _start_jax(job: Path) -> subprocess.Popen:
    env = dict(os.environ)
    flags = [f for f in env.get("XLA_FLAGS", "").split()
             if "xla_force_host_platform_device_count" not in f]
    env.update(
        JAX_PLATFORMS="cpu", JAX_PLATFORM_NAME="cpu",
        XLA_FLAGS=" ".join(flags + ["--xla_force_host_platform_device_count=1"]),
        PYTHONPATH=os.pathsep.join(
            [str(REPO)] + [p for p in [env.get("PYTHONPATH")] if p]),
    )
    return subprocess.Popen(
        [sys.executable, __file__, str(job)], stdout=subprocess.PIPE,
        stderr=subprocess.DEVNULL, text=True, cwd=REPO, env=env,
    )


_RESULTS = {}


def results(lp: str):
    """{seed: (JAX run, port Result)} over SEEDS; a JAX run is a dict of
    its status name, value and loop. Kept, failure included: a file's
    per-seed and per-instance tests share one computation."""
    if lp not in _RESULTS:
        try:
            _RESULTS[lp] = _compute(lp)
        except Exception as e:  # every test of the instance reports it
            _RESULTS[lp] = e
    if isinstance(_RESULTS[lp], Exception):
        raise _RESULTS[lp]
    return _RESULTS[lp]


def _compute(lp: str):
    with tempfile.TemporaryDirectory() as tmp:
        job = Path(tmp) / "job.json"
        job.write_text(json.dumps({"lp": lp, "seeds": list(SEEDS)}))
        proc = _start_jax(job)
        try:
            ports = {s: bt.optimize(_ctx(bt, s), bt.parse_lp(lp), device="cpu")
                     for s in SEEDS}
            out, _ = proc.communicate(timeout=JAX_TIMEOUT_S)
        finally:
            proc.kill()
            proc.wait()
    assert proc.returncode == 0, f"the JAX side exited {proc.returncode}"
    jax_runs = [json.loads(line) for line in out.splitlines() if line.strip()]
    assert [r["seed"] for r in jax_runs] == list(SEEDS)
    return {run["seed"]: (run, ports[run["seed"]]) for run in jax_runs}


def check_seed(lp: str, seed: int):
    rj, rt = results(lp)[seed]
    assert rj["status"] == "success", (seed, rj)
    assert rt.status.name == "success", (seed, rt.status)
    assert rt.loop == rj["loop"] == LIMIT
    raw = bx.parse_lp(lp)
    assert bx.is_valid_solution(raw, rt)
    assert bx.compute_solution(raw, rt) == pytest.approx(rt.value)


def band(vj: np.ndarray, vt: np.ndarray) -> float:
    """max(REL of the JAX mean, N_SE standard errors of the difference of
    the means)."""
    se = math.sqrt(vj.var(ddof=1) / len(vj) + vt.var(ddof=1) / len(vt))
    return max(REL * abs(vj.mean()), N_SE * se)


def check_means(lp: str):
    runs = results(lp)
    vj = np.array([runs[s][0]["value"] for s in SEEDS], np.float64)
    vt = np.array([runs[s][1].value for s in SEEDS], np.float64)
    gap = abs(vt.mean() - vj.mean())
    assert gap <= band(vj, vt), (
        f"JAX {vj.tolist()} (mean {vj.mean()}), port {vt.tolist()} "
        f"(mean {vt.mean()}): gap {gap} over the band {band(vj, vt)}"
    )


def _jax_main() -> None:
    import jax

    jax.config.update("jax_platforms", "cpu")
    job = json.loads(Path(sys.argv[1]).read_text())
    raw = bx.parse_lp(job["lp"])
    for seed in job["seeds"]:
        r = bx.optimize(_ctx(bx, seed), raw)
        print(json.dumps({"seed": seed, "status": r.status.name,
                          "value": r.value, "loop": r.loop}), flush=True)


if __name__ == "__main__":
    _jax_main()
