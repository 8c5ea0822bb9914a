"""Share of the traced slice in % that the host spent blocked in the
majors' reads: the change of ``pdlp/solver.py::host_sync_seconds`` over
the slice's length (single solves)."""


def read(t):
    if t.kind != "solve" or "host_sync_seconds" not in t.counters:
        return None
    return 100.0 * t.counters["host_sync_seconds"] / t.window_s
