"""Host seconds a major spends in the CUDA graph replays of its attempt
slots and statistics (single solves): ``replay_seconds / majors`` of the
program's counters over set-up's warm-up solve, before the profiler first
ran in the process (``lpbench/program_counters.py``).  No graphs on the
CPU: no reading there."""

from lpbench.program_counters import ratio


def read(t):
    return ratio(t, "solve", "replay_seconds", "majors",
                 part="before_trace")
