"""Console and timing helpers (counterpart of ``pix2latent_tpu/utils/misc.py``,
the parts the BasinCMA path uses)."""

from __future__ import annotations

import time

_COLORS = {
    "r": "\033[91m", "g": "\033[92m", "y": "\033[93m",
    "b": "\033[94m", "m": "\033[95m", "c": "\033[96m",
}
_END = "\033[0m"


def cprint(text, color=None, **kwargs):
    """ANSI color print."""
    if color in _COLORS:
        print(f"{_COLORS[color]}{text}{_END}", **kwargs)
    else:
        print(text, **kwargs)


class Timer:
    """Tiny wall-clock timer for sec/iter reporting."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.t0 = time.time()

    def avg(self, iters):
        return (time.time() - self.t0) / max(iters, 1)
