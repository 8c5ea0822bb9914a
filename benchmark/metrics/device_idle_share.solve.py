"""Share in % of the traced slice in which no operation ran on the device
(single solves): 1 - the union of the profiled device operations over the
slice."""

from lpbench.trace import idle_share


def read(t):
    return idle_share(t) if t.kind == "solve" else None
