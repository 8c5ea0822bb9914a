"""Spans and counters inside the PDLP layers (``pdlp/solver.py``,
``pdlp/batched.py``).

``span(name)`` is a context manager that marks a stretch of host work as
``pdlp::<name>`` on the timeline of a ``torch.profiler`` session: a
``record_function`` range, on the profiler's own clock, the clock of the
device's kernels, so that every idle gap of an exported trace lies under
the innermost ``pdlp::`` span of what the host was doing.  With no session
recording it costs one test of the bool that torch itself checks
(``torch.autograd.profiler._is_profiler_enabled``) and records nothing.
The profiler's trace is where spans are kept and written out.

``count(name, value)`` adds to one dict of always-on counters (seconds,
majors, slots: plain numbers); ``counters()`` is a copy of it.  The module
marks the counters' values at the first ``span`` or ``count`` that sees a
profiler session begin, and at the first that sees it end.
``before_trace()`` is the counters at the start mark: the process's work
before it first profiled, where it profiles once, the only part of it
whose graph launches run at their own speed, since a process that has
profiled launches graphs about ten times slower even after the profiler
stops.  ``since_trace_end()`` is the change since the end mark: free of
what came before and of the profiler's recording, but not of that
after-effect.  Like the solver's ``host_syncs``, the counters belong to
the process and take no lock: one solve runs at a time.
"""

from __future__ import annotations

import contextlib
from typing import Dict, Optional

import torch.autograd.profiler as _profiler

_counts: Dict[str, float] = {}
_recording = False  # whether the last call saw a session recording
_at_start: Optional[Dict[str, float]] = None  # the marks
_at_end: Optional[Dict[str, float]] = None
_OFF = contextlib.nullcontext()


def _mark() -> None:
    """The profiler's state changed since the last call: mark the
    counters."""
    global _recording, _at_start, _at_end
    _recording = _profiler._is_profiler_enabled
    if _recording:
        _at_start = dict(_counts)
    else:
        _at_end = dict(_counts)


def span(name: str):
    """``pdlp::<name>`` on the profiler's timeline while a session
    records; otherwise a context that does nothing."""
    if _profiler._is_profiler_enabled is not _recording:
        _mark()
    if not _recording:
        return _OFF
    return _profiler.record_function("pdlp::" + name)


def count(name: str, value: float = 1) -> None:
    """Add ``value`` to the counter ``name``."""
    if _profiler._is_profiler_enabled is not _recording:
        _mark()
    _counts[name] = _counts.get(name, 0) + value


def counters() -> Dict[str, float]:
    """Every counter's value since the process started."""
    return dict(_counts)


def before_trace() -> Dict[str, float]:
    """The counters as the last profiler session began (empty if none
    has)."""
    if _profiler._is_profiler_enabled is not _recording:
        _mark()
    return dict(_at_start or {})


def since_trace_end() -> Dict[str, float]:
    """The counters' change since the last profiler session ended (empty
    if none has)."""
    if _profiler._is_profiler_enabled is not _recording:
        _mark()
    if _at_end is None:
        return {}
    return {k: v - _at_end.get(k, 0) for k, v in _counts.items()}
