from pix2latent_tpu_torch.utils import image, misc, video  # noqa: F401
