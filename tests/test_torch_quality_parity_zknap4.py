"""The port's optimize against the JAX package's over seeds 1-6 on
``random_z_multiknapsack_lp(24, 90, seed=4)``: the Z sweep, its long rows
through kernel B's plain version. The rule and the runs are
``quality_parity.py``'s: every run succeeds and is valid, and the means
over the seeds agree within max(5% of the JAX mean, 3 standard errors).

On this instance the seeds spread 582-791 in the JAX package (36% of its
best) and 642-727 in the port (13%). About 70 s alone.
"""

import pytest
import torch

from baryonyx_tpu.generators import random_z_multiknapsack_lp
from quality_parity import SEEDS, check_means, check_seed

ZKNAP4 = random_z_multiknapsack_lp(24, 90, seed=4)


@pytest.fixture(autouse=True)
def one_torch_thread():
    """Eager torch ops on these small tensors gain nothing from threads,
    and the test workers share the machine's cores: one thread each."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("seed", SEEDS)
def test_zknap24x90_seed4_runs_succeed_and_are_valid(seed):
    check_seed(ZKNAP4, seed)


def test_zknap24x90_seed4_means_agree():
    check_means(ZKNAP4)
