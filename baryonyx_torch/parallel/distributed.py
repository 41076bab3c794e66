"""Multi-process start-up: one process per card under torch.distributed.

Every process runs the same optimize program on its own card (its own
replica slice, or its own constraint-row shard); they meet in a few
collectives — the per-chunk top-K population exchange, the flip-counter
sum, the ``cycle`` policy's per-step maximum (solver/optimize.py) and the
row-sharded sweep's flip union (parallel/rowshard.py). NCCL carries them
between cards, gloo between CPU processes (the tests) or between
processes that share one card (NCCL refuses two ranks on one device).

    torchrun --nproc-per-node=N -m baryonyx_torch --optimize file.lp

runs on N cards of one host: the command line calls ``init_distributed``
when ``WORLD_SIZE`` > 1.

Gloo takes CUDA tensors for only some collectives, so ``all_reduce`` and
``all_gather`` here copy a CUDA tensor through host memory, explicitly,
whenever the backend is gloo; the tensors they carry are small (a
population's top K, a flip mask, a stats vector).
"""

from __future__ import annotations

import datetime
import os
from typing import List, Optional

import numpy as np
import torch
import torch.distributed as dist

from baryonyx_torch.device import DeviceLike, resolve_device

DEFAULT_TIMEOUT_S = 300.0  # a rank that goes missing ends the run with an error


def _env_int(*names: str) -> Optional[int]:
    for name in names:
        if os.environ.get(name):
            return int(os.environ[name])
    return None


def init_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    device: DeviceLike = None,
    backend: Optional[str] = None,
    timeout_s: float = DEFAULT_TIMEOUT_S,
) -> torch.device:
    """Join this process to the fleet (idempotent); returns its device.

    Arguments fall back to BARYONYX_COORDINATOR / BARYONYX_NUM_PROCS /
    BARYONYX_PROC_ID, then to torchrun's MASTER_ADDR:MASTER_PORT /
    WORLD_SIZE / RANK. The address is ``host:port``, a ``tcp://`` or a
    ``file://`` URL. Without ``device`` the process takes card
    ``LOCAL_RANK`` (else its rank modulo the cards of the host). The
    backend is NCCL on a CUDA device and gloo on the CPU unless named;
    every collective of a rank that goes missing fails after
    ``timeout_s`` seconds instead of hanging."""
    if dist.is_initialized():
        return resolve_device(device)
    address = coordinator_address or os.environ.get("BARYONYX_COORDINATOR")
    if address is None and os.environ.get("MASTER_ADDR"):
        address = "{}:{}".format(
            os.environ["MASTER_ADDR"], os.environ.get("MASTER_PORT", "29500")
        )
    if address is None:
        raise ValueError(
            "init_distributed: no coordinator address (argument, "
            "BARYONYX_COORDINATOR or MASTER_ADDR)"
        )
    if "://" not in address:
        address = f"tcp://{address}"
    if num_processes is None:
        num_processes = _env_int("BARYONYX_NUM_PROCS", "WORLD_SIZE") or 1
    if process_id is None:
        process_id = _env_int("BARYONYX_PROC_ID", "RANK") or 0
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run on "
                "the CPU"
            )
        local = _env_int("LOCAL_RANK")
        if local is None:
            local = process_id % torch.cuda.device_count()
        torch.cuda.set_device(local)
    dev = resolve_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    kw = {}
    if backend == "nccl":
        kw["device_id"] = dev
    dist.init_process_group(
        backend,
        init_method=address,
        world_size=num_processes,
        rank=process_id,
        timeout=datetime.timedelta(seconds=timeout_s),
        **kw,
    )
    return dev


def shutdown() -> None:
    """Leave the fleet (a no-op outside one)."""
    if dist.is_initialized():
        dist.destroy_process_group()


def is_multiprocess() -> bool:
    return dist.is_initialized() and dist.get_world_size() > 1


def rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def _via_host(t: torch.Tensor, group) -> bool:
    return t.device.type != "cpu" and dist.get_backend(group) == "gloo"


_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}


def all_reduce(t: torch.Tensor, op: str = "sum", group=None) -> torch.Tensor:
    """The elementwise sum or maximum of ``t`` over the ranks, as a new
    tensor on ``t``'s device."""
    if _via_host(t, group):
        h = t.cpu()
        dist.all_reduce(h, _OPS[op], group=group)
        return h.to(t.device)
    out = t.clone()
    dist.all_reduce(out, _OPS[op], group=group)
    return out


def all_gather(t: torch.Tensor, group=None) -> torch.Tensor:
    """Every rank's ``t`` stacked along dim 0 in rank order (tiled:
    [D * t.shape[0], ...]), on ``t``'s device."""
    size = dist.get_world_size(group)
    src = t.cpu() if _via_host(t, group) else t.contiguous()
    parts: List[torch.Tensor] = [torch.empty_like(src) for _ in range(size)]
    dist.all_gather(parts, src, group=group)
    return torch.cat(parts).to(t.device)


def from_rank0(value: int, device: DeviceLike = "cpu", group=None) -> int:
    """Rank 0's ``value`` on every rank (one sum of one int64 on
    ``device``, which must be the backend's: a CUDA device under NCCL);
    outside a fleet, ``value`` itself. A decision that steers the ranks'
    host loops, or a seed their host draws share, comes through here so
    that no rank's own clock can set the ranks apart."""
    if not dist.is_initialized():
        return value
    mine = value if dist.get_rank(group) == 0 else 0
    t = torch.tensor([mine], dtype=torch.int64, device=resolve_device(device))
    return int(all_reduce(t, "sum", group).item())


def gather_to_host(x: torch.Tensor, group=None) -> np.ndarray:
    """``x`` gathered from every rank (tiled along dim 0, as the JAX
    package's ``process_allgather``) as a numpy array on every rank;
    outside a fleet, ``x`` itself."""
    if not dist.is_initialized():
        return x.cpu().numpy()
    return all_gather(x.reshape(x.shape or (1,)), group).cpu().numpy()
