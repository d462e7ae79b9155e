from pix2latent_tpu_torch.optimizers.basincma import BasinCMAOptimizer
from pix2latent_tpu_torch.optimizers.cma_optimizer import CMAOptimizer
from pix2latent_tpu_torch.optimizers.gradient import GradientOptimizer

__all__ = ["BasinCMAOptimizer", "CMAOptimizer", "GradientOptimizer"]
