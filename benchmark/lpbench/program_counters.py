"""The program's own counters in a traced run, read through
``ortools_tpu_torch.utils.tracing``: ``since_trace_end()``, the change of
every counter from the first of the program's calls after the profiler
stopped to the reader's call, that is over the rest of the window, free of
set-up and of the profiler's recording; ``before_trace()``, the counters as
the profiler started, that is over set-up (the warm-up solve, the root
batch), where no profiler had yet run in the process.  Graph launches are
read there: after a profiler has run, a process launches graphs about ten
times slower, even once it has stopped.  A program without that module
gives nothing, and every reader of it returns None."""

from __future__ import annotations

from typing import Optional


def _read(part: str) -> dict:
    try:
        from ortools_tpu_torch.utils import tracing
    except ImportError:  # the program has no such module
        return {}
    return getattr(tracing, part)()


def ratio(t, kind: str, num: str, den: str, scale: float = 1.0,
          part: str = "since_trace_end") -> Optional[float]:
    """``scale * num / den`` of the counters over ``part`` (after the
    slice, or ``before_trace``: set-up), in a run of the mix ``kind``; None
    where either is missing or ``den`` is 0."""
    if t.kind != kind:
        return None
    c = _read(part)
    if num not in c or not c.get(den):
        return None
    return scale * c[num] / c[den]
