"""Command-line inversions of the port (counterparts of the JAX package's
``examples/``). Run one as a module, e.g.
``python -m pix2latent_tpu_torch.examples.invert_stylegan2_ffhq_basincma``."""
