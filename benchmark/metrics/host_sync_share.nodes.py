"""Share of the traced slice in % that the host spent blocked in the
batched majors' reads: the change of ``pdlp/solver.py::host_sync_seconds``
(which ``pdlp/batched.py::BatchSolver.solve`` counts through the majors)
over the slice's length."""


def read(t):
    if t.kind != "node_batches" or "host_sync_seconds" not in t.counters:
        return None
    return 100.0 * t.counters["host_sync_seconds"] / t.window_s
