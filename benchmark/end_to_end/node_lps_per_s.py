"""Node LPs of the window that ended proven (optimal or infeasible) and
passed the judgement, over the window's whole time (from its start to the
end of its last batch)."""


def read(run):
    return run["passed"] / run["elapsed"]
