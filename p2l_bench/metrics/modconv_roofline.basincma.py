"""K3's module, StyleGAN2's modulated conv (``models/stylegan2.py``
``ModulatedConv``, whose backward runs ``ops/mod_backward.py``), as a
share of its roofline, %: the convolution (and blur) and its input
gradient with the style reduction, over their measured device time."""

from p2l_bench.flops.roofline import modconv_ms
from p2l_bench.harness.readers import roofline

MODULES = ("ModulatedConv",)


def read(trace):
    taps = len(trace["config"].get("blur_kernel", ()))
    return roofline(trace, "ModulatedConv", lambda c, bwd: modconv_ms(
        c["in"][0], c["out"], c["params"]["weight"], taps, bwd))
