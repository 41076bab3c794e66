"""Exception hierarchy.

Mirrors the reference's error taxonomy (reference:
lib/include/baryonyx/core:102-284 — file_access_error, file_format_error,
problem_definition_error, solver_failure) as Python exceptions.
"""

from __future__ import annotations


class BaryonyxError(Exception):
    """Base class for all baryonyx errors."""


class FileAccessError(BaryonyxError):
    """A file could not be opened/read (reference: core:121-147)."""

    def __init__(self, path: str, message: str = ""):
        self.path = path
        super().__init__(f"cannot access file {path!r}: {message}")


class FileFormatError(BaryonyxError):
    """The LP/result file is malformed (reference: core:149-205)."""

    def __init__(self, message: str, line: int = -1, column: int = -1):
        self.line = line
        self.column = column
        if line >= 0:
            super().__init__(f"{message} (line {line}, column {column})")
        else:
            super().__init__(message)


class ProblemDefinitionError(BaryonyxError):
    """The problem is inconsistent, e.g. conflicting merged equality
    constraints (reference: core:207-238, merged-constraint.cpp:81-89)."""

    def __init__(self, element: str, message: str):
        self.element = element
        super().__init__(f"problem definition error on {element!r}: {message}")


class InfeasibleConstraintError(BaryonyxError):
    """A single constraint admits no feasible 0/1 assignment at all,
    detected while compiling the problem layout (ops/layout.py). No
    reference analogue — the reference's solvers iterate to a limit with
    the row permanently violated; the drivers catch this and report a
    limit_reached result with the violated row counted instead of
    crashing."""

    def __init__(self, constraint_id: str, message: str):
        self.constraint_id = constraint_id
        super().__init__(f"constraint {constraint_id!r}: {message}")


class SolverError(BaryonyxError):
    """Internal solver failure (reference: core:240-284)."""
