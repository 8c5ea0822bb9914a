"""SolverLogger: callback-fanout progress logging.

Capability parity: ``ortools/util/logging.h:33`` (SolverLogger) — info
messages fan out to registered callbacks and/or stdout, with the full log
capturable as a string (the reference's log-to-response mode,
``cp_model_solver.cc:3998-4007``).
"""

from __future__ import annotations

from typing import Callable, List


class SolverLogger:
    def __init__(self, enable_output: bool = False,
                 capture: bool = True) -> None:
        self.enable_output = enable_output
        self._capture = capture
        self._lines: List[str] = []
        self._callbacks: List[Callable[[str], None]] = []

    def add_info_logging_callback(self, cb: Callable[[str], None]) -> None:
        self._callbacks.append(cb)

    def clear_info_logging_callbacks(self) -> None:
        self._callbacks.clear()

    @property
    def logging_is_enabled(self) -> bool:
        return bool(self.enable_output or self._callbacks or self._capture)

    def log_info(self, message: str) -> None:
        if self.enable_output:
            print(message)
        if self._capture:
            self._lines.append(message)
        for cb in self._callbacks:
            cb(message)

    def __call__(self, message: str) -> None:  # convenience
        self.log_info(message)

    def contents(self) -> str:
        return "\n".join(self._lines)


class GapIntegral:
    """Primal-integral tracking (reference
    SharedResponseManager::UpdateGapIntegral, cp_model_solver.cc:4491):
    the time integral of log(1 + |gap|), updated whenever the incumbent
    or the best bound moves; smaller is better."""

    def __init__(self, clock: Callable[[], float]) -> None:
        self._clock = clock
        self._last_t = clock()
        self._cur_gap = float("inf")
        self.value = 0.0

    def _accumulate(self) -> None:
        import math

        now = self._clock()
        dt = max(0.0, now - self._last_t)
        self._last_t = now
        if math.isfinite(self._cur_gap):
            self.value += dt * math.log1p(abs(self._cur_gap))
        elif dt > 0:
            # unbounded gap contributes at a fixed large rate (reference
            # uses the objective scale; a constant keeps it monotone)
            self.value += dt * 50.0

    def update(self, objective: float, bound: float) -> None:
        import math

        self._accumulate()
        if math.isfinite(objective) and math.isfinite(bound):
            self._cur_gap = abs(objective - bound)
        else:
            self._cur_gap = float("inf")

    def finalize(self) -> float:
        self._accumulate()
        return self.value
