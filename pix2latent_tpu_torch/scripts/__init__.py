"""Command-line tools of the port; run one as a module, e.g.
``python -m pix2latent_tpu_torch.scripts.convert``."""
