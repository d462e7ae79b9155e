"""Latent initialization distributions (counterpart of
``pix2latent_tpu/distribution.py``).

A distribution is a callable ``(generator, num_samples, shape) -> f32
tensor [num_samples, *shape]`` on the generator's device. Torch's Philox
stream differs from JAX's threefry, so the two packages agree in
distribution, not sample by sample.
"""

from __future__ import annotations

import torch


def _normal(generator, num_samples, shape):
    return torch.randn((num_samples, *shape), generator=generator,
                       device=generator.device, dtype=torch.float32)


class Distribution:
    def __call__(self, generator, num_samples, shape):
        raise NotImplementedError


class TruncatedNormalModulo(Distribution):
    """``fmod(sigma * N(0, I) + mu, trunc)``: normal samples folded into
    ``(-trunc, trunc)``. ``torch.fmod`` and ``jnp.fmod`` both keep the sign
    of the dividend."""

    def __init__(self, mu=0.0, sigma=1.0, trunc=2.0):
        self.mu = mu
        self.sigma = float(sigma)
        self.trunc = float(trunc)

    def __call__(self, generator, num_samples, shape):
        x = self.sigma * _normal(generator, num_samples, shape)
        mu = torch.as_tensor(self.mu, dtype=x.dtype, device=x.device)
        return torch.fmod(x + mu, self.trunc)

    def __repr__(self):
        return (f"TruncatedNormalModulo(mu={self.mu}, sigma={self.sigma}, "
                f"trunc={self.trunc})")


class TruncatedClampNormal(Distribution):
    """Normal samples hard-clamped to ``[-trunc, trunc]``."""

    def __init__(self, sigma=1.0, trunc=2.0):
        self.sigma = float(sigma)
        self.trunc = float(trunc)

    def __call__(self, generator, num_samples, shape):
        x = self.sigma * _normal(generator, num_samples, shape)
        return torch.clamp(x, -self.trunc, self.trunc)

    def __repr__(self):
        return f"TruncatedClampNormal(sigma={self.sigma}, trunc={self.trunc})"


class Normal(Distribution):
    """``mu + sigma * N(0, I)``; ``mu`` may be a scalar or an array
    broadcastable to ``shape``."""

    def __init__(self, sigma=1.0, mu=0.0):
        self.sigma = float(sigma)
        self.mu = mu if hasattr(mu, "shape") else float(mu)

    def __call__(self, generator, num_samples, shape):
        x = _normal(generator, num_samples, shape)
        mu = torch.as_tensor(self.mu, dtype=x.dtype, device=x.device)
        return mu + self.sigma * x

    def __repr__(self):
        mu = "array" if hasattr(self.mu, "shape") else self.mu
        return f"Normal(sigma={self.sigma}, mu={mu})"


class Uniform(Distribution):
    """Uniform samples in ``[low, high)``."""

    def __init__(self, low=-1.0, high=1.0):
        self.low = float(low)
        self.high = float(high)

    def __call__(self, generator, num_samples, shape):
        u = torch.rand((num_samples, *shape), generator=generator,
                       device=generator.device, dtype=torch.float32)
        return self.low + (self.high - self.low) * u

    def __repr__(self):
        return f"Uniform(low={self.low}, high={self.high})"
