"""Seconds of host set-up per solve: the span the benchmark wraps around
``pdlp/solver.py::build_device_problem`` (Ruiz and L2 rescaling, padding,
the block layout and its upload), averaged over the traced slice's
solves."""


def read(t):
    spans = t.spans.get("host_prep")
    if t.kind != "solve" or not spans:
        return None
    return sum(spans) / len(spans)
