"""Mean PDHG iterations at which a node LP ended, proven or at the call's
limit (node batches): ``node_iterations / nodes_finished`` of the
program's counters after the traced slice."""

from lpbench.program_counters import ratio


def read(t):
    return ratio(t, "node_batches", "node_iterations", "nodes_finished")
