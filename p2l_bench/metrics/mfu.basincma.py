"""The model's share of the cards' peak, %: the FLOPs of the window's
generations (inner steps, tell forwards, target taps; counted over the
plain reference) over the window's time at 495 TFLOP/s a card."""

from p2l_bench.harness.readers import mfu


def read(trace):
    return mfu(trace, backward=True)
