"""Share in % of the attempt slots replayed that accepted an iteration
(single solves): ``100 * accepted / slots`` of the program's counters
after the traced slice; the rest went to rejected attempts and to slots
of a tail past the major's last iteration."""

from lpbench.program_counters import ratio


def read(t):
    return ratio(t, "solve", "accepted", "slots", 100.0)
