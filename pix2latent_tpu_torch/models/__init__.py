from pix2latent_tpu_torch.models.biggan import BigGAN

__all__ = ["BigGAN"]
