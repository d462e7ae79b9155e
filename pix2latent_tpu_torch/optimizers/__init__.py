from pix2latent_tpu_torch.optimizers.basincma import BasinCMAOptimizer

__all__ = ["BasinCMAOptimizer"]
