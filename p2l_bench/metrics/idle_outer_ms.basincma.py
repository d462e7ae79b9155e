"""Device idle time outside a BasinCMA generation's inner run, ms: the
traced window's idle gaps whose middle falls while the host is not inside
the program's ``inner`` span (the ask, the target context, the tell loss,
the CMA update, the host's reads, or no span of the program), per
generation."""

from p2l_bench.harness.program import idle_ms_per_generation


def read(trace):
    return idle_ms_per_generation(trace, ("inner",), inside=False)
