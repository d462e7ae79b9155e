"""K1's module, BigGAN's SA-GAN block (``models/biggan.py`` ``SelfAttn``
around ``ops/attention.py``), as a share of its roofline, %: the least
time of its 1x1 convolutions, pooling and attention, forward and
backward, over their measured device time."""

from p2l_bench.flops.roofline import selfattn_ms
from p2l_bench.harness.readers import roofline

MODULES = ("SelfAttn",)


def read(trace):
    return roofline(trace, "SelfAttn",
                    lambda c, bwd: selfattn_ms(c["in"][0], bwd))
