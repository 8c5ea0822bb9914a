"""Cooperative SIGINT interruption.

Capability parity: ``ortools/util/sigint.h:21`` (SigintHandler) wired at
``cp_model_solver.cc:4080`` and PDLP's ``std::atomic<bool>*
interrupt_solve`` (primal_dual_hybrid_gradient.h:142) — first Ctrl-C
requests a graceful stop (solvers return the best incumbent with an
INTERRUPTED/limit status at their next check point), a second Ctrl-C
restores the default behavior (process kill).
"""

from __future__ import annotations

import signal
import threading
from typing import Optional


class SigintHandler:
    """Context manager installing a graceful-stop SIGINT handler.

    >>> with SigintHandler() as h:
    ...     solve(..., interrupt=h)   # solver polls h.interrupted
    """

    def __init__(self) -> None:
        self._stop = threading.Event()
        self._prev = None
        self._hits = 0

    @property
    def interrupted(self) -> bool:
        return self._stop.is_set()

    def interrupt(self) -> None:
        """Programmatic stop request (the reference's atomic flag)."""
        self._stop.set()

    def _on_sigint(self, signum, frame):
        self._hits += 1
        self._stop.set()
        if self._hits >= 2 and self._prev is not None:
            # second Ctrl-C: restore and re-raise for a hard stop
            signal.signal(signal.SIGINT, self._prev)
            raise KeyboardInterrupt

    def __enter__(self) -> "SigintHandler":
        if threading.current_thread() is threading.main_thread():
            self._prev = signal.signal(signal.SIGINT, self._on_sigint)
        return self

    def __exit__(self, *exc) -> Optional[bool]:
        if self._prev is not None:
            signal.signal(signal.SIGINT, self._prev)
            self._prev = None
        return None
