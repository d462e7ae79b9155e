"""K2's module, StyleGAN2's FIR blur after each upsampling conv
(``ops/upfirdn2d.py`` ``Blur`` around ``ops/fir_blur.py``), as a share of
its roofline, %, forward and backward."""

from p2l_bench.flops.roofline import blur_ms
from p2l_bench.harness.readers import roofline

MODULES = ("Blur",)


def read(trace):
    taps = len(trace["config"].get("blur_kernel", ()))
    return roofline(trace, "Blur", lambda c, bwd: blur_ms(
        c["in"][0], c["out"], taps, bwd))
