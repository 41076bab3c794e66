"""Contracts: precondition/postcondition checks and debug-gated solver
state validation.

Mirrors the reference's ``bx_expects``/``bx_ensures``/``bx_assert``
macros (reference: lib/src/debug.hpp:75-117 — abort-on-fail, disabled
under BARYONYX_FULL_OPTIMIZATION). Host-side contracts raise
``ContractError``; the device-state validator runs on fetched probes in
debug mode only (the step itself stays check-free, like the reference's
optimized build).
"""

from __future__ import annotations

import numpy as np

from baryonyx_torch.core.errors import SolverError


class ContractError(SolverError):
    """A bx_expects/bx_ensures violation."""

    def __init__(self, kind: str, message: str):
        super().__init__(f"{kind} violated: {message}")
        self.kind = kind


def bx_expects(condition: bool, message: str = "precondition") -> None:
    """reference: debug.hpp:103 (caller-side precondition)."""
    if not condition:
        raise ContractError("precondition", message)


def bx_ensures(condition: bool, message: str = "postcondition") -> None:
    """reference: debug.hpp:107 (callee-side postcondition)."""
    if not condition:
        raise ContractError("postcondition", message)


def bx_assert(condition: bool, message: str = "assertion") -> None:
    """reference: debug.hpp:111."""
    if not condition:
        raise ContractError("assertion", message)


def validate_replica_state(probe: dict, where: str = "evolve") -> None:
    """Debug-mode invariants over a fetched state probe
    (solver/optimize.py builds it under ``params.debug``):

    - multipliers and preferences are finite (a NaN/Inf here means the
      kappa schedule diverged or costs overflowed the device dtype);
    - assignments are 0/1;
    - per-replica kappa is finite and not negative;
    - remaining counts are within [0, m].
    """
    bx_assert(bool(np.isfinite(probe["pi_absmax"])), f"{where}: pi not finite")
    bx_assert(bool(np.isfinite(probe["P_absmax"])), f"{where}: P not finite")
    bx_assert(
        bool(probe["x_min"] >= 0 and probe["x_max"] <= 1),
        f"{where}: x not binary",
    )
    bx_assert(
        bool(np.isfinite(probe["kappa_max"]) and probe["kappa_max"] >= 0.0),
        f"{where}: kappa invalid: {probe['kappa_max']}",
    )
    bx_assert(
        bool(0 <= probe["remaining_min"] <= probe["m"]),
        f"{where}: remaining out of range",
    )
