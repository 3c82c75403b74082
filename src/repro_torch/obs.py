"""No-op stand-in for ``repro.obs`` until the observability layer is ported
(ROADMAP.md, queue 1 item 9).  ``trace`` spans cost one shared null
context manager and ``count`` one call; both record nothing."""
from __future__ import annotations

import contextlib

__all__ = ["trace", "count"]

_NULL = contextlib.nullcontext()


def trace(name: str, **attrs) -> contextlib.AbstractContextManager:
    """A span context manager; does nothing in this port yet."""
    return _NULL


def count(name: str, value=1, **attrs) -> None:
    """A counter increment; does nothing in this port yet."""
