"""LPs of the window that ended OPTIMAL and passed the judgement, over the
window's whole time (from its start to the end of its last call)."""


def read(run):
    return run["passed"] / run["elapsed"]
