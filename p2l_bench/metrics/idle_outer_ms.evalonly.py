"""Device idle time of an eval-only generation outside its forwards, ms:
the traced window's idle gaps whose middle falls while the host is inside
neither the program's ``eval`` nor its ``tell_loss`` span (the ask, the
CMA update, the host's reads, or no span of the program), per
generation."""

from p2l_bench.harness.program import idle_ms_per_generation


def read(trace):
    return idle_ms_per_generation(trace, ("eval", "tell_loss"), inside=False)
