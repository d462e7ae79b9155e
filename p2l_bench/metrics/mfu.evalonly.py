"""The model's share of the card's peak in an eval-only window, %:
the forwards' FLOPs (evaluation and tell, with the target's taps) over
the window's time at 495 TFLOP/s."""

from p2l_bench.harness.readers import mfu


def read(trace):
    return mfu(trace, backward=False)
