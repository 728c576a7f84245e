"""Logging/error facade (the lib/yaps.c capability).

The reference routes all diagnostics through ``yaps_message`` /
``yaps_quit`` with a pluggable sink callback (yaps.c:24-35, 53-63).
Here the same shape sits on Python ``logging``: a pluggable sink, a
``quit`` that raises instead of calling exit(1) (callers may catch), and
module-level convenience functions used across the package.
"""
from __future__ import annotations

import logging
import sys
from typing import Callable, Optional

__all__ = ["message", "quit", "set_sink", "logger", "LibstbError"]

logger = logging.getLogger("libstb_jax")
if not logger.handlers:
    _h = logging.StreamHandler(sys.stderr)
    _h.setFormatter(logging.Formatter("%(name)s: %(message)s"))
    logger.addHandler(_h)
    logger.setLevel(logging.INFO)

_sink: Optional[Callable[[str], None]] = None


class LibstbError(RuntimeError):
    """Fatal-condition signal (the yaps_quit analog; raised, not exit(1))."""


def set_sink(fn: Optional[Callable[[str], None]]):
    """Install a message sink (yaps_yapper, yaps.c:33-35); None resets."""
    global _sink
    _sink = fn


def message(fmt: str, *args):
    txt = fmt % args if args else fmt
    if _sink is not None:
        _sink(txt)
    else:
        logger.info(txt)


def quit(fmt: str, *args):
    txt = fmt % args if args else fmt
    if _sink is not None:
        _sink(txt)
    else:
        logger.error(txt)
    raise LibstbError(txt)
