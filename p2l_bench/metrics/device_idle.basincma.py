"""The share of the traced window in which no operation ran on the
device, % (``torch.profiler``, the first window generation)."""

from p2l_bench.harness.readers import device_idle


def read(trace):
    return device_idle(trace)
