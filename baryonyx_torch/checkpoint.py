"""Checkpoint/resume for the optimize-mode population.

The reference has no mid-run checkpointing; its persistence is the .sol
result file. Here the population (the evolutionary state that matters
across restarts) round-trips through a .npz file, so a preempted optimize
resumes from its incumbents instead of from scratch. The file holds the
arrays ``x`` (int32 [P, n]), ``value``, ``remaining`` (int32 [P]) and
``hash`` (uint32 [P]), the layout the JAX package writes, so a checkpoint
of either package loads in the other.
"""

from __future__ import annotations

import numpy as np
import torch

from baryonyx_torch.solver.population import Population


def save_population(path: str, pop: Population) -> None:
    """Write ``pop`` (tensors on any device) to ``path`` (numpy appends
    ``.npz`` to a path without it)."""
    np.savez_compressed(
        path,
        x=pop.x.cpu().numpy().astype(np.int32),
        value=pop.value.cpu().numpy(),
        remaining=pop.remaining.cpu().numpy().astype(np.int32),
        # the port keeps the uint32 hash in an int64 tensor
        hash=pop.hash.cpu().numpy().astype(np.uint32),
    )


def load_population(path: str) -> Population:
    """The population saved at ``path``, as CPU tensors: x and remaining
    int32, value in the saved type, hash int64."""
    with np.load(path) as data:
        return Population(
            x=torch.as_tensor(data["x"].astype(np.int32)),
            value=torch.as_tensor(data["value"]),
            remaining=torch.as_tensor(data["remaining"].astype(np.int32)),
            hash=torch.as_tensor(data["hash"].astype(np.int64)),
        )
