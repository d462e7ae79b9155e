"""Console, conversion and timing helpers (counterpart of
``pix2latent_tpu/utils/misc.py``, the parts the drivers use)."""

from __future__ import annotations

import time

import numpy as np
import torch

_COLORS = {
    "r": "\033[91m", "g": "\033[92m", "y": "\033[93m",
    "b": "\033[94m", "m": "\033[95m", "c": "\033[96m",
}
_END = "\033[0m"


def to_numpy(x):
    """A tensor (any device) or array-like as a host numpy array. Reading a
    device tensor waits for the device."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def cprint(text, color=None, **kwargs):
    """ANSI color print."""
    print(color_str(text, color), **kwargs)


def color_str(string, color):
    """``string`` wrapped in the ANSI codes of ``color``; unknown colors
    pass through uncolored."""
    if color in _COLORS:
        return f"{_COLORS[color]}{string}{_END}"
    return str(string)


def loss_to_color(loss):
    """Color of a loss magnitude for console reports."""
    if loss < 0.3:
        return "g"
    if loss < 0.6:
        return "y"
    return "r"


def color_loss(loss):
    """A loss formatted with the magnitude colors: < 0.01 cyan, < 0.1 green,
    < 0.5 yellow, else red."""
    c = "r"
    if loss < 0.5:
        c = "y"
    if loss < 0.1:
        c = "g"
    if loss < 0.01:
        c = "c"
    return color_str(f"{loss:.5f}", c)


def progress_print(task, curr, total, color=None, t_avg=None):
    """Progress line with the share done and, when given, seconds per
    iteration."""
    pct = 100.0 * curr / max(total, 1)
    msg = f"[{task}] {curr}/{total} ({pct:.1f}%)"
    if t_avg is not None:
        msg += f"  {t_avg:.3f} sec/iter"
    cprint(msg, color)


class Timer:
    """Tiny wall-clock timer for sec/iter reporting."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.t0 = time.time()

    def avg(self, iters):
        return (time.time() - self.t0) / max(iters, 1)
