"""The port's optimize against the JAX package's over seeds 1-6 on an
equality class with costs and on a quadratic instance, both through the
fused sweep's plain version (the quadratic one with its dense CQ). The
rule and the runs are ``quality_parity.py``'s: every run succeeds and is
valid, and the means over the seeds agree within max(5% of the JAX mean,
3 standard errors).

- telebus75 (``telebus_crew_lp(75, 10, 4, seed=1)``, set partitioning
  with costs of 20,000-900,000): the seeds land on 4,735,287, 4,751,020
  or 4,799,957 in the JAX package and on 4,735,287 or 4,799,957 in the
  port (1.4% apart); with the population's inserts switched off
  (``BARYONYX_ABLATE=insert``) the port ends near 3.2-3.5 M with rows
  left uncovered, so the sweeps, not the initial population, find these.
- qsap (``random_qsap_lp(12, 6, seed=2)``, the instance of
  ``test_torch_quadratic.py``): -465 for every seed in both packages.

About 60 s alone.
"""

import pytest
import torch

from baryonyx_tpu.generators import random_qsap_lp, telebus_crew_lp
from quality_parity import SEEDS, check_means, check_seed

TELEBUS75 = telebus_crew_lp(75, 10, 4, seed=1)
QSAP = random_qsap_lp(12, 6, seed=2)


@pytest.fixture(autouse=True)
def one_torch_thread():
    """Eager torch ops on these small tensors gain nothing from threads,
    and the test workers share the machine's cores: one thread each."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("seed", SEEDS)
def test_telebus75_runs_succeed_and_are_valid(seed):
    check_seed(TELEBUS75, seed)


def test_telebus75_means_agree():
    check_means(TELEBUS75)


@pytest.mark.parametrize("seed", SEEDS)
def test_qsap_runs_succeed_and_are_valid(seed):
    check_seed(QSAP, seed)


def test_qsap_means_agree():
    check_means(QSAP)
