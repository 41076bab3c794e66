"""The replica axis over processes: one rank per card.

The multi-start replica axis R (trailing axis of every replica-state
tensor) splits over the ranks of the process group: rank r keeps replicas
[r R/D, (r+1) R/D) and its own full population, which evolves on its own
within a host chunk. The only in-chunk collective is the ``cycle``
policy's per-step maximum; once per chunk every rank's top-K (x, value,
remaining) go to every rank and insert into its population
(solver/optimize.py: ``evolve``) — the counterpart of the reference's
mutex-shared ``storage`` polled at ~1 Hz (reference:
itm-optimizer-common.hpp:97-99,240-300,836-857).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.distributed as dist

from baryonyx_torch import spans
from baryonyx_torch.device import DeviceLike, resolve_device
from baryonyx_torch.parallel import distributed

_M63 = (1 << 63) - 1


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A process group, this process's rank in it, its size, and the
    device this rank runs on. Under a profiler, the bytes this rank passes
    to each collective are counted as ``parallel.bytes``."""

    group: Optional[dist.ProcessGroup]  # None: the default group
    rank: int
    size: int
    device: torch.device

    def replica_range(self, R: int) -> slice:
        """This rank's slice of a replica axis of R (a multiple of size)."""
        per = R // self.size
        return slice(self.rank * per, (self.rank + 1) * per)

    def seed(self, seed: int) -> int:
        """The seed of this rank's random stream, from (seed, rank); rank
        0 keeps ``seed``, so a one-rank group draws what one process
        without a group draws."""
        if self.rank == 0:
            return seed
        return (seed * 0x9E3779B97F4A7C15 + self.rank * 0xBF58476D1CE4E5B9) & _M63

    def all_reduce(self, t: torch.Tensor, op: str = "sum") -> torch.Tensor:
        spans.add("parallel.bytes", t.numel() * t.element_size())
        return distributed.all_reduce(t, op, self.group)

    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        spans.add("parallel.bytes", t.numel() * t.element_size())
        return distributed.all_gather(t, self.group)

    def from_rank0(self, value: int) -> int:
        """Rank 0's ``value`` on every rank."""
        return distributed.from_rank0(value, self.device, self.group)


def make_mesh(group: Optional[dist.ProcessGroup] = None,
              device: DeviceLike = None) -> Mesh:
    """The mesh of the initialized process group (``init_distributed``),
    on ``device`` (CUDA unless ``device="cpu"``)."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh: no process group (init_distributed)")
    return Mesh(
        group=group,
        rank=dist.get_rank(group),
        size=dist.get_world_size(group),
        device=resolve_device(device),
    )


def shard_opt_state(state, mesh: Mesh):
    """This rank's share of an optimize state built for the whole replica
    axis: its slice of every replica-state tensor's trailing R axis
    (copied, so the full tensors can go), the population whole (every
    rank evolves a full copy of it), everything else as it is.
    ``optimize_compiled`` makes the same cut on the host, before anything
    goes to the card."""
    from baryonyx_torch.solver.optimize import ReplicaState

    sl = mesh.replica_range(state.replicas.kappa.shape[0])
    rs = ReplicaState(*[a[..., sl].contiguous() for a in state.replicas])
    return state._replace(replicas=rs)

