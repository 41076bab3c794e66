"""Device choice for the port's entry points.

Entry points run on the first CUDA device unless the caller passes
``device="cpu"`` (as the tests do). Without CUDA and without an explicit
device they raise: nothing drops to the CPU on its own.
"""

from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run on "
                "the CPU"
            )
        return torch.device("cuda", torch.cuda.current_device())
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev
