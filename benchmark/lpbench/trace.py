"""The traced slice of a ``--trace 1`` run: spans from the benchmark's own
wrappers around the program's layers, the program's counters, and the
device's operations from ``torch.profiler``, kept in memory.

The slice starts with the window and ends with its first unit, or at the
first host read of the program after ``trace_seconds`` (the mix file's)
where that comes first: a whole window of graph replays would give the
profiler millions of kernels to parse.  Every per-layer number of a traced
run but ``iterations.solve`` is taken over the slice.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from collections import defaultdict
from pathlib import Path
from typing import Dict, List, Optional, Tuple

# A gap in the device's work is named by the innermost of these host spans
# that covers its middle.
GAP_LABELS = {
    "host_prep": "host set-up", "power_iteration": "power iteration",
    "capture": "capture", "read": "read", "call": "host loop",
}


@dataclasses.dataclass
class TraceData:
    """What the per-layer readers (``metrics/<name>.py``) read."""

    kind: str  # the mix's kind
    dtype: str  # the configuration's
    shape: dict  # m, n, nnz, batch of the instances
    bench_dir: Path
    window_s: float  # the slice, on the profiler's clock
    busy_s: float  # union of the device's operations in the slice
    device_ops: List[Tuple[str, float, float]]  # (name, start s, seconds)
    gaps: List[Tuple[str, float]]  # (what the host did, seconds)
    spans: Dict[str, List[float]]  # seconds of each wrapped call
    counters: Dict[str, float]  # the program's counters over the slice
    iterations: List[int]  # of every solve in the window (solve mix)

    def kernel(self, name: str) -> dict:
        from lpbench.spec import kernel_spec

        return kernel_spec(self.bench_dir, name)


def counters() -> dict:
    """The program's counters that the readers take, where it has them."""
    from ortools_tpu_torch.pdlp import solver as S

    return {key: float(getattr(S, key))
            for key in ("host_sync_seconds", "capture_seconds")
            if hasattr(S, key)}


class Tracer:
    def __init__(self, device, seconds: float):
        self.device = device
        self.seconds = seconds
        self.spans: Dict[str, List[float]] = defaultdict(list)
        self._undo = []
        self._depth = 0  # wrapped calls open
        self._call = None  # the open bench::call range
        self.active = False

    # -- spans ----------------------------------------------------------------
    def _timed(self, fn, label):
        import torch

        spans = self.spans

        def timed(*args, **kwargs):
            t0 = time.perf_counter()
            self._depth += 1
            try:
                with torch.profiler.record_function("bench::" + label):
                    return fn(*args, **kwargs)
            finally:
                spans[label].append(time.perf_counter() - t0)
                self._depth -= 1
                if self._depth == 0 and self._due():
                    self.stop()
        return timed

    def _wrap(self, owner, attr: str, label: str, factory: bool = False):
        """Time each call of ``owner.attr`` (of what it returns, for a
        ``factory``); a name the program no longer has is left alone."""
        fn = getattr(owner, attr, None)
        if fn is None:
            return
        if factory:
            def made(*args, **kwargs):
                return self._timed(fn(*args, **kwargs), label)
            setattr(owner, attr, made)
        else:
            setattr(owner, attr, self._timed(fn, label))
        self._undo.append((owner, attr, fn))

    def _install(self) -> None:
        from ortools_tpu_torch.pdlp import solver as S

        self._wrap(S, "build_device_problem", "host_prep")
        self._wrap(S, "_make_power_iter", "power_iteration", factory=True)
        self._wrap(S._Majors, "_capture", "capture")
        self._wrap(S, "_to_host", "read")

    def _uninstall(self) -> None:
        for owner, attr, fn in reversed(self._undo):
            setattr(owner, attr, fn)
        self._undo = []

    @contextlib.contextmanager
    def call(self):
        """A span around one unit of the mix; the slice ends with the
        first unit, if a read has not ended it before."""
        import torch

        if not self.active:
            yield
            return
        self._call = torch.profiler.record_function("bench::call")
        self._call.__enter__()
        try:
            yield
        finally:
            if self._call is not None:
                self._call.__exit__(None, None, None)
                self._call = None
            self.stop()

    def _due(self) -> bool:
        return self.active and time.perf_counter() - self.t0 >= self.seconds

    # -- the slice ------------------------------------------------------------
    def start(self) -> None:
        import torch
        from torch.profiler import ProfilerActivity, profile

        self._install()
        acts = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
            torch.cuda.synchronize()
        self.before = counters()
        self.prof = profile(activities=acts)
        self.prof.__enter__()
        self._slice = torch.profiler.record_function("bench::slice")
        self._slice.__enter__()
        self.t0 = time.perf_counter()
        self.active = True

    def stop(self) -> None:
        """End the slice (in a unit, between two of the program's calls
        that it wraps, or after one)."""
        import torch

        if not self.active:
            return
        self.active = False
        if self.device.type == "cuda":
            torch.cuda.synchronize()
        self.window_s = time.perf_counter() - self.t0
        if self._call is not None:
            self._call.__exit__(None, None, None)
            self._call = None
        self._slice.__exit__(None, None, None)
        self.prof.__exit__(None, None, None)
        after = counters()
        self.delta = {k: after[k] - self.before[k] for k in after
                      if k in self.before}
        self._uninstall()

    def data(self, kind, dtype, shape, bench_dir, iterations) -> TraceData:
        ops, host, bounds = _events(self.prof)
        lo, hi = bounds if bounds else (0.0, self.window_s)
        busy, gaps = _busy_and_gaps(ops, host, lo, hi)
        return TraceData(kind, dtype, shape, bench_dir, hi - lo, busy,
                         ops, gaps, dict(self.spans), self.delta, iterations)


def _is_device(e) -> bool:
    """An operation that ran on the device: not a host span's annotation
    on the device's timeline."""
    return (str(getattr(e, "device_type", "")).endswith("CUDA")
            and not getattr(e, "is_user_annotation", False)
            and not e.name.startswith("bench::"))


def _events(prof):
    """(device operations, host spans, slice bounds), times in seconds on
    the profiler's clock."""
    ops, host, bounds = [], [], None
    for e in prof.events():
        tr = e.time_range
        s, t = tr.start * 1e-6, tr.end * 1e-6
        if _is_device(e):
            ops.append((e.name, s, t - s))
        elif str(getattr(e, "device_type", "")).endswith("CUDA"):
            continue
        elif e.name == "bench::slice":
            bounds = (s, t)
        elif e.name.startswith("bench::"):
            host.append((e.name[len("bench::"):], s, t))
    return ops, host, bounds


def _busy_and_gaps(ops, host, lo: float, hi: float):
    """The union of the operations' intervals within [lo, hi], and each
    gap between them with the innermost host span over its middle."""
    spans = sorted((max(s, lo), min(s + d, hi)) for _, s, d in ops
                   if s + d > lo and s < hi)
    merged: List[List[float]] = []
    for s, t in spans:
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], t)
        else:
            merged.append([s, t])
    busy = sum(t - s for s, t in merged)
    edges = [lo] + [v for st in merged for v in st] + [hi]
    gaps = []
    for s, t in zip(edges[::2], edges[1::2]):
        if t > s:
            mid = 0.5 * (s + t)
            over = [(e - b, name) for name, b, e in host if b <= mid <= e]
            label = GAP_LABELS.get(min(over)[1], min(over)[1]) if over \
                else "between calls"
            gaps.append((label, t - s))
    return busy, gaps


def short_name(name: str) -> str:
    """A kernel's name without ``void``, anonymous namespaces and its
    argument list."""
    name = name[5:] if name.startswith("void ") else name
    name = name.replace("(anonymous namespace)::", "")
    return name.split("(", 1)[0][:120]


def breakdown(t: TraceData) -> dict:
    """The ten device operations that took most time and the ten longest
    idle gaps of the slice."""
    by_name: Dict[str, float] = defaultdict(float)
    for name, _, d in t.device_ops:
        by_name[short_name(name)] += d
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    gaps = sorted(t.gaps, key=lambda g: -g[1])[:10]
    return {"device_ops": [[k, v] for k, v in ops],
            "idle_gaps": [[k, v] for k, v in gaps]}


def idle_share(t: TraceData) -> Optional[float]:
    if t.window_s <= 0 or not t.device_ops:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
