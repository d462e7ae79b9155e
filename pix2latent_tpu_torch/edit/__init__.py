from pix2latent_tpu_torch.edit.editor import BigGANLatentEditor
from pix2latent_tpu_torch.edit.ganspace import biggan_components

__all__ = ["BigGANLatentEditor", "biggan_components"]
