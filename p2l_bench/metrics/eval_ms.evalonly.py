"""Device time of an eval-only generation's evaluation of the population,
ms: the CUDA-event span of ``ExecutionCore.eval`` (``core/step.py``)."""

from p2l_bench.harness.readers import per_generation_ms


def read(trace):
    return per_generation_ms(trace, "eval")
