from pix2latent_tpu_torch.losses.lpips import LPIPS

__all__ = ["LPIPS"]
