"""Solver statistics.

Capability parity: ``ortools/util/stats.h:90-342`` (StatsGroup,
TimeDistribution, IntegerDistribution) and the reference's pervasive
SCOPED_TIME_STAT pattern — lightweight aggregation printed at end of solve.
"""

from __future__ import annotations

import contextlib
import math
import time
from typing import Dict, List


class Distribution:
    """Running min/max/sum/count (+ stddev) of a scalar."""

    def __init__(self, name: str) -> None:
        self.name = name
        self.count = 0
        self.total = 0.0
        self.total_sq = 0.0
        self.min = math.inf
        self.max = -math.inf

    def add(self, v: float) -> None:
        self.count += 1
        self.total += v
        self.total_sq += v * v
        self.min = min(self.min, v)
        self.max = max(self.max, v)

    @property
    def average(self) -> float:
        return self.total / self.count if self.count else 0.0

    @property
    def stddev(self) -> float:
        if self.count < 2:
            return 0.0
        mean = self.average
        var = max(0.0, self.total_sq / self.count - mean * mean)
        return math.sqrt(var)

    def __str__(self) -> str:
        if not self.count:
            return f"{self.name}: no samples"
        return (f"{self.name}: count={self.count} avg={self.average:.3g} "
                f"dev={self.stddev:.3g} min={self.min:.3g} "
                f"max={self.max:.3g} total={self.total:.3g}")


class TimeDistribution(Distribution):
    """Distribution of wall times with a context-manager sampler
    (the SCOPED_TIME_STAT equivalent)."""

    @contextlib.contextmanager
    def time_this(self):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.add(time.perf_counter() - t0)


class StatsGroup:
    def __init__(self, name: str) -> None:
        self.name = name
        self._stats: Dict[str, Distribution] = {}

    def time_distribution(self, name: str) -> TimeDistribution:
        if name not in self._stats:
            self._stats[name] = TimeDistribution(name)
        return self._stats[name]  # type: ignore[return-value]

    def integer_distribution(self, name: str) -> Distribution:
        if name not in self._stats:
            self._stats[name] = Distribution(name)
        return self._stats[name]

    def __str__(self) -> str:
        lines = [f"Stats: {self.name}"]
        for k in sorted(self._stats):
            lines.append("  " + str(self._stats[k]))
        return "\n".join(lines)
