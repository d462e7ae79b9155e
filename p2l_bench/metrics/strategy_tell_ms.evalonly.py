"""Device time of an eval-only generation's CMA update, ms: the program's
``strategy_tell`` span (``cma.tell`` with its ``eigh``), per
generation."""

from p2l_bench.harness.program import ms_per_generation


def read(trace):
    return ms_per_generation(trace, "strategy_tell")
