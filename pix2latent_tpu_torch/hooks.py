"""Per-step variable constraint hooks (counterpart of
``pix2latent_tpu/hooks.py``).

A hook is a function ``hook(generator, x, step) -> x_new`` of the
``[pop, *shape]`` variable; it returns a new tensor and does not modify
``x``. The inner loop writes the result back into the optimized variable
before each step's forward.
"""

from __future__ import annotations

import torch


class Hook:
    def __call__(self, generator, x, step=0):
        raise NotImplementedError


class Clamp(Hook):
    """Clamp the variable to ``[-trunc, trunc]``."""

    def __init__(self, trunc):
        self.trunc = float(trunc)

    def __call__(self, generator, x, step=0):
        return torch.clamp(x, -self.trunc, self.trunc)

    def __repr__(self):
        return f"Clamp(trunc={self.trunc})"


class Normalize(Hook):
    """Per-sample z-score renormalization to ``N(mu, std)`` (unbiased std,
    statistics over all elements of each sample)."""

    def __init__(self, mu=0.0, std=1.0):
        self.mu = float(mu)
        self.std = float(std)

    def __call__(self, generator, x, step=0):
        dims = tuple(range(1, x.dim()))
        mean = x.mean(dim=dims, keepdim=True)
        std = x.std(dim=dims, keepdim=True, correction=1)
        return (x - mean) / (std + 1e-12) * self.std + self.mu

    def __repr__(self):
        return f"Normalize(mu={self.mu}, std={self.std})"


def _noise(generator, x):
    return torch.randn(x.shape, generator=generator, device=x.device,
                       dtype=x.dtype)


class NormalPerturb(Hook):
    """Add ``sigma * N(0, I)`` noise."""

    def __init__(self, sigma=0.1):
        self.sigma = float(sigma)

    def __call__(self, generator, x, step=0):
        return x + self.sigma * _noise(generator, x)

    def __repr__(self):
        return f"NormalPerturb(sigma={self.sigma})"


class ScheduledNormalPerturb(Hook):
    """Noise decayed to zero over ``max_step`` steps:
    ``strength = (sigma * max(0, 1 - step/(max_step-1))) ** pow``."""

    def __init__(self, sigma=0.1, max_step=500, pow=2):
        self.sigma = float(sigma)
        self.max_step = int(max_step)
        self.pow = float(pow)

    def __call__(self, generator, x, step=0):
        p = float(step) / max(float(self.max_step) - 1.0, 1.0)
        strength = (self.sigma * max(0.0, 1.0 - p)) ** self.pow
        return x + strength * _noise(generator, x)

    def __repr__(self):
        return (f"ScheduledNormalPerturb(sigma={self.sigma}, "
                f"max_step={self.max_step}, pow={self.pow})")


class Compose(Hook):
    """Apply hooks in order; accepts ``Compose(a, b)`` and ``Compose([a, b])``."""

    def __init__(self, *hook_fns):
        if len(hook_fns) == 1 and isinstance(hook_fns[0], (list, tuple)):
            hook_fns = tuple(hook_fns[0])
        self.hook_fns = hook_fns

    def __call__(self, generator, x, step=0):
        for fn in self.hook_fns:
            x = fn(generator, x, step)
        return x

    def __repr__(self):
        return f"Compose({', '.join(repr(f) for f in self.hook_fns)})"
