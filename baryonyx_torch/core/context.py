"""Context: parameters + leveled logging + progress callbacks.

Mirrors the reference's opaque ``context`` (reference:
lib/include/baryonyx/core:478-533, impl lib/src/private.hpp:50-83) and the
syslog-style leveled logger (reference: private.hpp:151-265).
"""

from __future__ import annotations

import enum
import sys
from dataclasses import dataclass, field
from typing import Callable, Optional

from baryonyx_torch.core.params import SolverParameters


class MessageLevel(enum.IntEnum):
    """reference: private.hpp:52-62."""

    emerg = 0
    alert = 1
    crit = 2
    err = 3
    warning = 4
    notice = 5
    info = 6
    debug = 7


# Callback signatures (reference: core:751-761):
#   start(parameters)
#   update(remaining_constraints, value, loop, duration, restarts)
#   finish(result)
StartCallback = Callable[[SolverParameters], None]
UpdateCallback = Callable[[int, float, int, float, int], None]
FinishCallback = Callable[[object], None]


@dataclass
class Context:
    parameters: SolverParameters = field(default_factory=SolverParameters)
    log_priority: MessageLevel = MessageLevel.notice
    # The hidden string-parameter side channel; the only recognized key is
    # "method" (reference: private.cpp:39-48).
    method: str = ""

    start_cb: Optional[StartCallback] = None
    update_cb: Optional[UpdateCallback] = None
    finish_cb: Optional[FinishCallback] = None

    def register(
        self,
        start: Optional[StartCallback] = None,
        update: Optional[UpdateCallback] = None,
        finish: Optional[FinishCallback] = None,
    ) -> None:
        """reference: lpcore.cpp:58-69."""
        self.start_cb = start
        self.update_cb = update
        self.finish_cb = finish

    # -- logging -------------------------------------------------------
    def log(self, level: MessageLevel, msg: str, *args) -> None:
        if level <= self.log_priority:
            text = msg.format(*args) if args else msg
            stream = sys.stderr if level <= MessageLevel.err else sys.stdout
            print(text, file=stream, end="" if text.endswith("\n") else "\n")

    def info(self, msg: str, *args) -> None:
        self.log(MessageLevel.info, msg, *args)

    def notice(self, msg: str, *args) -> None:
        self.log(MessageLevel.notice, msg, *args)

    def warning(self, msg: str, *args) -> None:
        self.log(MessageLevel.warning, msg, *args)

    def error(self, msg: str, *args) -> None:
        self.log(MessageLevel.err, msg, *args)

    def debug(self, msg: str, *args) -> None:
        self.log(MessageLevel.debug, msg, *args)

    # -- parameters ----------------------------------------------------
    def set_parameters(self, params: SolverParameters) -> None:
        """Validated copy (reference: private.cpp:50-172)."""
        self.parameters = params.validated()

    def set_parameter(self, name: str, value: str) -> None:
        """String key/value side channel (reference: private.cpp:39-48)."""
        if name == "method":
            self.method = value


def make_context(verbose_level: int = 5) -> Context:
    """reference: lpcore.cpp:52-56 — verbosity in [0..7]."""
    level = MessageLevel(max(0, min(7, verbose_level)))
    return Context(log_priority=level)
