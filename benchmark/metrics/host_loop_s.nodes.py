"""Host seconds from a batched major's return to the next major's start
in the same batch, per major (node batches): ``host_loop_seconds /
majors`` of the program's counters after the traced slice."""

from lpbench.program_counters import ratio


def read(t):
    return ratio(t, "node_batches", "host_loop_seconds", "majors")
