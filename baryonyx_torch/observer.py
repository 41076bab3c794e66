"""Observers: periodic dumps of the preference matrix P and multiplier
vector pi during solve mode.

reference: lib/src/observer.hpp — pnm_observer (:205-226) writes PNM
images via the colormap/image writers of pnm.hpp:36-369; file_observer
(:228-249) writes text; none_observer compiles away (:251-267). Enabled by
``-p observer-type:pnm|file`` in solve mode only (call site
itm-solver-common.hpp:128-137).

Here the solver state lives on device; dumps happen at host chunk
boundaries (every ``chunk_size`` iterations) instead of every iteration —
set ``chunk_size=1`` for per-iteration parity.
"""

from __future__ import annotations

import math
import os
from typing import Optional

import numpy as np


def _heat_rgb(t: np.ndarray) -> np.ndarray:
    """Simple blue→red diverging colormap over [0,1] (stands in for the
    reference's pnm colormap, pnm.hpp:36-140)."""
    t = np.clip(t, 0.0, 1.0)
    r = np.clip(1.5 - np.abs(2.0 * t - 1.5), 0, 1)
    g = np.clip(1.5 - np.abs(2.0 * t - 1.0), 0, 1)
    b = np.clip(1.5 - np.abs(2.0 * t - 0.5), 0, 1)
    return (np.stack([r, g, b], axis=-1) * 255).astype(np.uint8)


def write_pnm(path: str, rgb: np.ndarray) -> None:
    """Binary P6 writer (reference: pnm.hpp image writers)."""
    h, w, _ = rgb.shape
    with open(path, "wb") as fh:
        fh.write(f"P6\n{w} {h}\n255\n".encode())
        fh.write(rgb.tobytes())


class NoneObserver:
    def make_observation(self, P: np.ndarray, pi: np.ndarray, loop: int) -> None:
        pass


class PnmObserver:
    """reference: observer.hpp:205-226 — one image per observation for P
    and a growing strip for pi."""

    def __init__(self, basename: str, directory: str = "."):
        self.basename = basename
        self.directory = directory
        self.count = 0

    def make_observation(self, P: np.ndarray, pi: np.ndarray, loop: int) -> None:
        os.makedirs(self.directory, exist_ok=True)
        scale = max(float(np.abs(P).max()), 1e-12)
        img = _heat_rgb((P / (2 * scale)) + 0.5)
        write_pnm(
            os.path.join(self.directory, f"{self.basename}-P-{self.count:06d}.pnm"),
            img,
        )
        pscale = max(float(np.abs(pi).max()), 1e-12)
        pimg = _heat_rgb((pi[None, :] / (2 * pscale)) + 0.5)
        write_pnm(
            os.path.join(self.directory, f"{self.basename}-pi-{self.count:06d}.pnm"),
            pimg,
        )
        self.count += 1


class FileObserver:
    """reference: observer.hpp:228-249 — text dumps."""

    def __init__(self, basename: str, directory: str = "."):
        self.basename = basename
        self.directory = directory
        self.count = 0

    def make_observation(self, P: np.ndarray, pi: np.ndarray, loop: int) -> None:
        os.makedirs(self.directory, exist_ok=True)
        with open(
            os.path.join(self.directory, f"{self.basename}-P-{self.count:06d}.txt"),
            "w",
        ) as fh:
            for row in P:
                fh.write(" ".join(f"{v:.6g}" for v in row) + "\n")
        with open(
            os.path.join(self.directory, f"{self.basename}-pi-{self.count:06d}.txt"),
            "w",
        ) as fh:
            fh.write(" ".join(f"{v:.6g}" for v in pi) + "\n")
        self.count += 1


def make_observer(observer_type, basename: str = "img") -> object:
    from baryonyx_torch.core.params import ObserverType

    if observer_type == ObserverType.pnm:
        return PnmObserver(basename)
    if observer_type == ObserverType.file:
        return FileObserver(basename)
    return NoneObserver()
