"""Host syncs of a BasinCMA generation: the program's ``sync`` spans (the
drivers' reads of device values and the tell's ``eigh``), per
generation."""

from p2l_bench.harness.program import count_per_generation


def read(trace):
    return count_per_generation(trace, "sync")
