"""pix2latent_tpu_torch: the PyTorch port of pix2latent_tpu for NVIDIA GPUs.

Same public layout as the JAX package: images are NHWC float32 in [-1, 1],
latents ``[pop, dim]``. Entry points take ``device=`` (default ``"cuda"``)
and raise without a GPU unless ``device="cpu"`` is given. Three hand-written
CUDA kernels run on the card: the SA-GAN attention (``ops/attention.py``),
the separable FIR blur (``ops/fir_blur.py``) and the fused modulation
backward (``ops/mod_backward.py``), built from ``csrc/*.cu`` at first use.
"""

from pix2latent_tpu_torch import distribution, hooks
from pix2latent_tpu_torch.variables import (VariableManager, Variables,
                                            load_variables, num_samples,
                                            save_variables, split_vars,
                                            stack_splits)

__all__ = ["VariableManager", "Variables", "save_variables", "load_variables",
           "split_vars", "stack_splits", "num_samples", "distribution",
           "hooks"]
