"""Optimizer drivers (the public set of the JAX package's
``pix2latent_tpu/optimizers/__init__.py``):

    GradientOptimizer        pure Adam descent
    CMAOptimizer             CMA + Adam finetune
    BasinCMAOptimizer        CMA outside x Adam inside
    NevergradOptimizer       a registry strategy + Adam finetune
    HybridNevergradOptimizer a registry strategy outside x Adam inside
    BatchedBasinCMAOptimizer BasinCMA over a batch of images
"""

from pix2latent_tpu_torch.optimizers.base import _BaseOptimizer
from pix2latent_tpu_torch.optimizers.basincma import BasinCMAOptimizer
from pix2latent_tpu_torch.optimizers.batched import BatchedBasinCMAOptimizer
from pix2latent_tpu_torch.optimizers.cma_optimizer import CMAOptimizer
from pix2latent_tpu_torch.optimizers.gradient import GradientOptimizer
from pix2latent_tpu_torch.optimizers.ng_optimizer import (
    HybridNevergradOptimizer, NevergradOptimizer)

__all__ = ["BasinCMAOptimizer", "BatchedBasinCMAOptimizer", "CMAOptimizer",
           "GradientOptimizer", "HybridNevergradOptimizer",
           "NevergradOptimizer", "_BaseOptimizer"]
