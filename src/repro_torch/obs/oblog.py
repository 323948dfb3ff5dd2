"""Structured stdlib logging for the ``repro_torch.*`` namespace.

Every module logs through `get_logger("dse.parallel")` -> logger
``repro_torch.dse.parallel``.  The ``repro_torch`` root logger ships
with a `NullHandler` (library etiquette: importing repro_torch never
configures global logging); applications and the CLI call `configure()`
to attach a stderr handler.  `log_event` renders key=value pairs after
the event name so grep-able structured lines come out of plain
`logging`::

    repro_torch.dse.parallel WARNING pool.degraded tasks=2 rounds=3
"""

from __future__ import annotations

import logging
import sys
from typing import Any

__all__ = ["get_logger", "configure", "log_event"]

_ROOT = "repro_torch"
logging.getLogger(_ROOT).addHandler(logging.NullHandler())

_FORMAT = "%(asctime)s %(name)s %(levelname)s %(message)s"


def get_logger(name: str = "") -> logging.Logger:
    """Logger under the ``repro_torch`` namespace (idempotent on full
    names)."""
    if not name:
        return logging.getLogger(_ROOT)
    if name == _ROOT or name.startswith(_ROOT + "."):
        return logging.getLogger(name)
    return logging.getLogger(f"{_ROOT}.{name}")


def configure(level: str = "WARNING", stream: Any = None,
              force: bool = False) -> logging.Logger:
    """Attach one stream handler to the ``repro_torch`` root logger.

    Idempotent: a second call only adjusts the level unless `force`
    replaces the handler (tests use force + a StringIO stream)."""
    root = logging.getLogger(_ROOT)
    root.setLevel(getattr(logging, level.upper(), logging.WARNING))
    have = [h for h in root.handlers
            if isinstance(h, logging.StreamHandler)
            and not isinstance(h, logging.NullHandler)]
    if have and not force:
        return root
    for h in have:
        root.removeHandler(h)
    handler = logging.StreamHandler(stream or sys.stderr)
    handler.setFormatter(logging.Formatter(_FORMAT))
    root.addHandler(handler)
    return root


def log_event(logger: logging.Logger, level: "int | str", event: str,
              **fields: Any) -> None:
    """``event key=value ...`` structured line through stdlib logging.
    `level` is an int (`logging.INFO`) or a name (``"info"``)."""
    if isinstance(level, str):
        level = getattr(logging, level.upper(), logging.INFO)
    if not logger.isEnabledFor(level):
        return
    parts = [event] + [f"{k}={v}" for k, v in fields.items()]
    logger.log(level, " ".join(parts))
