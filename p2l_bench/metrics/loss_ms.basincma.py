"""Device time of the loss in an inner Adam step, ms: the program's
``loss`` spans under ``inner`` (LPIPS and the projection loss, forward;
``losses/lpips.py``, ``loss_functions.py``), per step."""

from p2l_bench.harness.program import ms_per_step


def read(trace):
    return ms_per_step(trace, "loss")
