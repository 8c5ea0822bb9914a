"""A run's judgement: the judged numbers, each the worst over the answers
judged, beside its limit; the answers attempted and failed; and the window's
answers that passed, which the rates count."""

from __future__ import annotations

import math


class Judgement:
    def __init__(self, limits: dict):
        self.limits = dict(limits)
        self.worst = {k: 0 for k in limits}
        self.attempted = 0
        self.failed = 0
        self.window_passed = 0

    def count(self, name: str, n: int = 1) -> None:
        self.worst[name] += n

    def ratio(self, name: str, value: float) -> bool:
        """Keep ``value`` if it is the worst yet; whether it meets the
        limit.  NaN reads as the worst and meets none."""
        if not value <= self.worst[name]:
            self.worst[name] = value
        return value <= self.limits[name]

    def numbers(self) -> dict:
        return {k: (v, self.limits[k]) for k, v in self.worst.items()}

    @property
    def correct(self) -> bool:
        return all(v <= self.limits[k] for k, v in self.worst.items())


def bound_error(bound: float, reference: float, tol: float) -> float:
    """How far a claimed Lagrangian bound lies from the reference's, over
    the gap tolerance: 0 where both are -inf, inf where only one is."""
    if bound == reference:
        return 0.0
    if math.isinf(bound) or math.isinf(reference):
        return math.inf
    return abs(bound - reference) / tol
