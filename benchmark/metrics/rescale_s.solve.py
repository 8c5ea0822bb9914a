"""Host seconds of Ruiz and L2 rescaling per problem built (single
solves): ``rescale_seconds / problems_built`` of the program's counters
after the traced slice."""

from lpbench.program_counters import ratio


def read(t):
    return ratio(t, "solve", "rescale_seconds", "problems_built")
