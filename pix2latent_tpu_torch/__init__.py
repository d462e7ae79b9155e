"""pix2latent_tpu_torch: the PyTorch port of pix2latent_tpu for NVIDIA GPUs.

Same public layout as the JAX package: images are NHWC float32 in [-1, 1],
latents ``[pop, dim]``. Entry points take ``device=`` (default ``"cuda"``)
and raise without a GPU unless ``device="cpu"`` is given. The SA-GAN
attention runs a hand-written CUDA kernel on the card (``ops/attention.py``,
``csrc/sagan_attention.cu``).
"""

from pix2latent_tpu_torch import distribution, hooks
from pix2latent_tpu_torch.variables import (VariableManager, load_variables,
                                            save_variables)

__all__ = ["VariableManager", "distribution", "hooks", "load_variables",
           "save_variables"]
