"""Console, seed, precision, conversion and timing helpers (counterpart of
``pix2latent_tpu/utils/misc.py``)."""

from __future__ import annotations

import os
import sys
import time

import numpy as np
import torch

from pix2latent_tpu_torch.utils.device import resolve_device
from pix2latent_tpu_torch.utils.profiling import span

_COLORS = {
    "r": "\033[91m", "g": "\033[92m", "y": "\033[93m",
    "b": "\033[94m", "m": "\033[95m", "c": "\033[96m",
}
_END = "\033[0m"


_PRECISIONS = {"half": torch.bfloat16, "bfloat16": torch.bfloat16,
               "float": torch.float32, "float32": torch.float32,
               "double": torch.float64}


def set_seed(seed: int) -> torch.Generator:
    """Seed numpy's global generator and return a ``torch.Generator``
    seeded the same (where the JAX package returns a PRNG key); the port's
    draws take an explicit generator."""
    np.random.seed(seed)
    return torch.Generator().manual_seed(int(seed))


def to_onehot(idx, num_classes=1000, device="cpu"):
    """An integer or a list of them as a float32 one-hot tensor
    ``[n, num_classes]``."""
    idx = np.atleast_1d(np.asarray(idx, np.int64))
    out = torch.zeros((idx.size, num_classes), dtype=torch.float32)
    out[torch.arange(idx.size), torch.as_tensor(idx)] = 1.0
    return out.to(resolve_device(device))


def set_model_precision(params, precision="float"):
    """Floating tensors cast to ``precision``: ``"half"`` (bfloat16, as in
    the JAX package, not float16), ``"float"`` or ``"double"``. ``params``
    is an ``nn.Module`` (cast in place and returned) or a tensor tree of
    dicts, lists and tuples (a new tree); other leaves pass through."""
    dtype = _PRECISIONS[precision]
    if isinstance(params, torch.nn.Module):
        return params.to(dtype)
    if isinstance(params, dict):
        return {k: set_model_precision(v, precision)
                for k, v in params.items()}
    if isinstance(params, (list, tuple)):
        return type(params)(set_model_precision(v, precision)
                            for v in params)
    if isinstance(params, torch.Tensor) and params.is_floating_point():
        return params.to(dtype)
    return params


def prepare_variables(variables, precision="float", device="cuda"):
    """:func:`set_model_precision`, then every tensor of the tree (numpy
    arrays become tensors) moved to ``device`` (default the card)."""
    device = resolve_device(device)

    def place(tree):
        if isinstance(tree, dict):
            return {k: place(v) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return type(tree)(place(v) for v in tree)
        if isinstance(tree, np.ndarray):
            tree = torch.from_numpy(tree)
        return tree.to(device) if isinstance(tree, torch.Tensor) else tree

    return set_model_precision(place(variables), precision)


class HiddenPrints:
    """Standard output discarded inside the ``with`` block."""

    def __enter__(self):
        self._stdout = sys.stdout
        sys.stdout = open(os.devnull, "w")
        return self

    def __exit__(self, exc_type, exc_val, exc_tb):
        sys.stdout.close()
        sys.stdout = self._stdout
        return False


def to_numpy(x):
    """A tensor (any device) or array-like as a host numpy array. Reading a
    device tensor waits for the device (a ``sync`` span)."""
    if isinstance(x, torch.Tensor):
        if x.is_cuda:
            with span("sync", site="to_numpy"):
                return x.detach().cpu().numpy()
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
