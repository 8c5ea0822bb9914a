"""Host seconds from a major's return to the next major's start in the
same solve, per major (single solves): the host loop's own time, its
decisions, restarts and polishing, ``host_loop_seconds / majors`` of the
program's counters after the traced slice."""

from lpbench.program_counters import ratio


def read(t):
    return ratio(t, "solve", "host_loop_seconds", "majors")
