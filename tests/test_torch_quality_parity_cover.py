"""The port's optimize against the JAX package's over seeds 1-6 on a
set cover, through the fused sweep's plain version; and, marked ``slow``,
solve on scp200x1000 in both packages over 3 seeds. The rule and the
runs are ``quality_parity.py``'s: every run succeeds and is valid, and
the means over the seeds agree within max(5% of the JAX mean, 3 standard
errors).

scp80x400 (``random_set_cover_lp(80, 400, 0.04, seed=11)``): the seeds
give 231-242 (4.8% of the best) in both packages, seed for seed. The
smaller ``random_set_cover_lp(60, 240, 0.05, seed=11)`` of
``test_torch_optimize.py`` gives 228 or 233 on every seed. On every set
cover tried, the result at 200 sweeps x 16 replicas is the best of the
host's initial population (its greedy covers): with the population's
inserts switched off (``BARYONYX_ABLATE=insert``) the port returns the
same objective on every seed. So this instance holds the port's
population set-up and extraction to the JAX package's; the sweeps' own
quality is held by the other parity files. About 70 s alone.
"""

import numpy as np
import pytest
import torch

import baryonyx_tpu as bx
from baryonyx_tpu.generators import random_set_cover_lp
from quality_parity import SEEDS, band, check_means, check_seed

import baryonyx_torch as bt

SCP80 = random_set_cover_lp(80, 400, 0.04, seed=11)


@pytest.fixture(autouse=True)
def one_torch_thread():
    """Eager torch ops on these small tensors gain nothing from threads,
    and the test workers share the machine's cores: one thread each."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("seed", SEEDS)
def test_scp80x400_runs_succeed_and_are_valid(seed):
    check_seed(SCP80, seed)


def test_scp80x400_means_agree():
    check_means(SCP80)


@pytest.mark.slow
def test_solve_scp200x1000_against_jax():
    """The check owed since the port's solve ran on the card: solve mode
    on scp200x1000 (``random_set_cover_lp(200, 1000, 0.02, seed=41)``)
    in both packages on the CPU, default parameters, seeds 1-3: both
    succeed, the port's solution is valid, and the means agree by the
    same rule. Prints both packages' objectives."""
    lp = random_set_cover_lp(200, 1000, 0.02, seed=41)
    raw = bx.parse_lp(lp)
    vj, vt = [], []
    for seed in (1, 2, 3):
        cj, ct = bx.make_context(0), bt.make_context(0)
        cj.parameters.seed = ct.parameters.seed = seed
        rj = bx.solve(cj, raw)
        rt = bt.solve(ct, bt.parse_lp(lp), device="cpu")
        assert rj.status.name == rt.status.name == "success"
        assert bx.is_valid_solution(raw, rt)
        assert bx.compute_solution(raw, rt) == pytest.approx(rt.value)
        vj.append(rj.value)
        vt.append(rt.value)
    print(f"solve scp200x1000, seeds 1-3: JAX {vj}, port {vt}")
    vj, vt = np.array(vj), np.array(vt)
    assert abs(vt.mean() - vj.mean()) <= band(vj, vt)
