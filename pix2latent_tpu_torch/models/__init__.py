from pix2latent_tpu_torch.models.base import FunctionModel, as_model
from pix2latent_tpu_torch.models.biggan import BigGAN
from pix2latent_tpu_torch.models.stylegan2 import StyleGAN2

__all__ = ["BigGAN", "FunctionModel", "StyleGAN2", "as_model"]
