"""Device time of a BasinCMA generation's tell loss, ms: the program's
``tell_loss`` span (``ExecutionCore.tell_loss``: the hooks, the forward
and the loss of the refined population without gradients, and on a mesh
the gather of the losses), per generation."""

from p2l_bench.harness.program import ms_per_generation


def read(trace):
    return ms_per_generation(trace, "tell_loss")
