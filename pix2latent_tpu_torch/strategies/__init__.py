"""Gradient-free search strategies, on the device.

``cma`` replaces the reference's host-side PyCMA; ``registry`` replaces its
nevergrad bridge with a registry of ask/tell strategies.
"""

from pix2latent_tpu_torch.strategies import cma
from pix2latent_tpu_torch.strategies.cma import CMA
from pix2latent_tpu_torch.strategies.registry import registry

__all__ = ["cma", "CMA", "registry"]
