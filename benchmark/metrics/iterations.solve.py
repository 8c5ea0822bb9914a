"""Mean PDHG iterations to the configuration's tolerance,
``SolveResult.iterations`` of every solve of the window: the algorithm's
layer (restarts, the step rule)."""


def read(t):
    if t.kind != "solve" or not t.iterations:
        return None
    return sum(t.iterations) / len(t.iterations)
