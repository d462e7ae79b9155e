"""Device idle time inside a BasinCMA generation's inner run, ms: the
traced window's idle gaps whose middle falls while the host is inside the
program's ``inner`` span (``ExecutionCore.grad_steps``), per generation.
With ``idle_outer_ms.basincma`` it makes up all the idle time of
``device_idle.basincma``'s window."""

from p2l_bench.harness.program import idle_ms_per_generation


def read(trace):
    return idle_ms_per_generation(trace, ("inner",), inside=True)
