"""An eval-only generation's wall time outside its evaluation, ms: the
ask, ``_eval_loop``'s fresh tell-loss forward, the CMA tell with its
``eigh`` and the loss read; the mean over the window's generations."""

from p2l_bench.harness.readers import outside_ms


def read(trace):
    return outside_ms(trace, "eval")
