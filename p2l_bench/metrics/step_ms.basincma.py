"""Device time of an inner Adam step of the population (forward, loss,
backward, update, hook), ms: the CUDA-event span of the generation's
``ExecutionCore.grad_steps`` call over its steps (``core/step.py``)."""

from p2l_bench.harness.readers import per_step_ms


def read(trace):
    return per_step_ms(trace, "grad_steps")
