"""Once-per-process deprecation warnings for the legacy shims.

The port's copy of ``repro.utils.deprecation``. Every deprecated surface
(the ``core.feasibility`` functions and their package-level names) funnels
through :func:`warn_once`, so a long-running process — a serving engine,
a benchmark sweep — sees exactly one ``DeprecationWarning`` per shim, not
one per call.
"""
from __future__ import annotations

import threading
import warnings

__all__ = ["warn_once"]

_WARNED: set[str] = set()
_LOCK = threading.Lock()


def warn_once(key: str, message: str, stacklevel: int = 3) -> None:
    """Emit ``DeprecationWarning(message)`` the first time ``key`` is seen.

    Thread-safe: concurrent first calls with the same key race on the
    seen-set, so the check-and-mark is done under a lock and exactly one
    thread warns.
    """
    with _LOCK:
        if key in _WARNED:
            return
        _WARNED.add(key)
    warnings.warn(message, DeprecationWarning, stacklevel=stacklevel)
