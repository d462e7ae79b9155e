"""A BasinCMA generation's wall time outside its inner run, ms: the ask,
the tell loss's forward, the CMA tell with its ``eigh`` and the loss
read (``optimizers/cma_base.py``, ``strategies/cma.py``); the mean over
the window's generations."""

from p2l_bench.harness.readers import outside_ms


def read(trace):
    return outside_ms(trace, "grad_steps")
