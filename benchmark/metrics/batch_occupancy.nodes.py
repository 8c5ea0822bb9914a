"""Share in % of a batch's instances still open when a batched major began
(node batches): ``100 * batch_open / batch_instances`` of the program's
counters after the traced slice.  The rest are finished nodes whose
columns the majors still carry until the slowest node ends."""

from lpbench.program_counters import ratio


def read(t):
    return ratio(t, "node_batches", "batch_open", "batch_instances", 100.0)
