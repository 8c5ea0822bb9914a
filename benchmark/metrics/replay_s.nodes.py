"""Host seconds a batched major spends in the CUDA graph replays of its
attempt slots and statistics (node batches): ``replay_seconds / majors``
of the program's counters over set-up's root batch, before the profiler
first ran in the process.  No graphs on the CPU: no reading there."""

from lpbench.program_counters import ratio


def read(t):
    return ratio(t, "node_batches", "replay_seconds", "majors",
                 part="before_trace")
