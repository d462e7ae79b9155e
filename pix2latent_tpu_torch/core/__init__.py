from pix2latent_tpu_torch.core.step import ExecutionCore

__all__ = ["ExecutionCore"]
