"""Carry solver state across from the JAX package.

The JAX package's ``CompiledProblem``, ``ReplicaState``, ``Population`` and
solve-mode ``DeviceState`` arrive as dicts of numpy arrays, one entry per field (``np.asarray`` of
each field; a static int becomes a 0-d array, an absent optional field a
0-d object array holding None). The functions here return the port's
objects on one device, so both packages can start from the same state.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch

from baryonyx_torch.device import DeviceLike, resolve_device
from baryonyx_torch.ops.layout import CompiledProblem
from baryonyx_torch.solver.optimize import ReplicaState
from baryonyx_torch.solver.population import Population
from baryonyx_torch.solver.solve import DeviceState


def _tensor(a: np.ndarray, device: torch.device):
    a = np.asarray(a)
    if a.dtype == object:
        if a.shape == () and a.item() is None:
            return None
        raise TypeError(f"cannot carry an object array of shape {a.shape}")
    if a.dtype == np.uint32:  # hashes: held as int64
        a = a.astype(np.int64)
    return torch.as_tensor(np.array(a, copy=True)).to(device)


def compiled_problem(d: Dict[str, np.ndarray], device: DeviceLike = None) -> CompiledProblem:
    """The port's CompiledProblem from the JAX one's fields."""
    dev = resolve_device(device)
    kw = {}
    for f in dataclasses.fields(CompiledProblem):
        v = np.asarray(d[f.name])
        if f.type in ("int", "bool"):
            kw[f.name] = int(v) if f.type == "int" else bool(v)
        else:
            kw[f.name] = _tensor(v, dev)
    return CompiledProblem(**kw)


def replica_state(d: Dict[str, np.ndarray], device: DeviceLike = None) -> ReplicaState:
    dev = resolve_device(device)
    return ReplicaState(**{k: _tensor(d[k], dev) for k in ReplicaState._fields})


def population(d: Dict[str, np.ndarray], device: DeviceLike = None) -> Population:
    dev = resolve_device(device)
    return Population(**{k: _tensor(d[k], dev) for k in Population._fields})


def device_state(
    d: Dict[str, np.ndarray],
    device: DeviceLike = None,
    gen: Optional[torch.Generator] = None,
) -> DeviceState:
    """The port's solve-mode state from the JAX one's fields. The JAX
    state's random key has no counterpart: the port's random stream is
    ``gen``. The counters the host loop reads become Python ints."""
    dev = resolve_device(device)
    host = ("loop", "order_code", "stop_reason")
    kw = {
        k: _tensor(d[k], dev)
        for k in DeviceState._fields
        if k not in host and k != "gen"
    }
    kw.update({k: int(np.asarray(d[k])) for k in host})
    return DeviceState(gen=gen, **kw)
