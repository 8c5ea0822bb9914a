"""Seconds of CUDA-graph capture per solve: the change of the program's
counter ``pdlp/solver.py::capture_seconds`` over the traced slice, over
the solves that started in it (one host set-up each)."""


def read(t):
    solves = len(t.spans.get("host_prep", ()))
    if t.kind != "solve" or "capture_seconds" not in t.counters or not solves:
        return None
    return t.counters["capture_seconds"] / solves
