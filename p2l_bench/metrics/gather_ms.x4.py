"""Rank 0's device time inside ``Mesh.gather`` a generation, ms: the
CUDA-event span of each gather, which holds the wait for the slowest rank
(``parallel/mesh.py``)."""

from p2l_bench.harness.readers import per_generation_ms


def read(trace):
    return per_generation_ms(trace, "gather")
