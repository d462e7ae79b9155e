"""Differentiable affine alignment (counterpart of
``pix2latent_tpu/transform/spatial.py``).

Scale + translation (aspect fixed, no shear): ``t = [s, tx, ty]`` with the
identity ``[1, 0, 0]``; the searched value is a delta,
``t = default_t + sensitivity * delta``. The warp is the two-product form of
``ops/affine_matmul.py`` by default, or ``F.affine_grid`` +
``F.grid_sample`` (``ops/grid_sample.py``); both are differentiable in
``t``.
"""

from __future__ import annotations

import numpy as np
import torch

from pix2latent_tpu_torch.ops.affine_matmul import (
    affine_warp_matmul_t, inverse_affine_warp_matmul_t)
from pix2latent_tpu_torch.ops.grid_sample import affine_grid, grid_sample
from pix2latent_tpu_torch.transform.base import TransformTemplate
from pix2latent_tpu_torch.transform.utils import compute_pre_alignment
from pix2latent_tpu_torch.utils.device import resolve_device


class SpatialTransform(TransformTemplate):

    def __init__(self, t=(1.0, 0.0, 0.0), identity_t=(1.0, 0.0, 0.0),
                 pre_align=None, sensitivity=0.1, use_matmul_warp=True,
                 device="cuda"):
        """Args:
            t: default parameter (the search center).
            identity_t: parameter at which the warp is the identity.
            pre_align: optional mask image; the default parameter then
                aligns the mask's object with BigGAN's object prior.
            sensitivity: scale of the searched delta.
            use_matmul_warp: the two-product warp (the default) instead of
                ``grid_sample``; both compute the same image.
            device: where the default parameter lives (the images' device).
        """
        self.device = resolve_device(device)
        self.identity_t = np.asarray(identity_t, np.float32)
        self.is_spatial = True
        self.sensitivity = float(sensitivity)
        self.use_matmul_warp = bool(use_matmul_warp)

        self.t = np.asarray(t, np.float32)
        if pre_align is not None:
            self.t = compute_pre_alignment(pre_align).numpy()
        self._t = torch.tensor(self.t, device=self.device)

    def __call__(self, ims, delta_t, invert=False):
        t = self._t[None].to(ims.dtype) + self.sensitivity * delta_t
        if invert:
            return self.invert_transform(ims, t)
        return self.transform(ims, t)

    def get_default_param(self, as_tensor=True):
        return self._t if as_tensor else self.t

    def get_identity_param(self, as_tensor=True):
        if as_tensor:
            return torch.tensor(self.identity_t, device=self.device)
        return self.identity_t

    def get_opt_param(self):
        return self.t

    @staticmethod
    def _theta(scale, trans):
        """``[N, 2, 3]`` affine matrices ``[[s, 0, tx], [0, s, ty]]``."""
        zeros = torch.zeros_like(scale)
        row0 = torch.stack([scale, zeros, trans[:, 0]], dim=-1)
        row1 = torch.stack([zeros, scale, trans[:, 1]], dim=-1)
        return torch.stack([row0, row1], dim=1)

    def transform(self, ims, t):
        """Warp ``ims [N, H, W, C]`` by ``t [N, 3]``."""
        if self.use_matmul_warp:
            return affine_warp_matmul_t(ims, t)
        theta = self._theta(t[:, 0], t[:, 1:])
        return grid_sample(ims, affine_grid(theta, ims.shape[1:3]))

    def invert_transform(self, ims, t):
        """The exact inverse warp, ``[1/s, -tx/s, -ty/s]``:
        ``invert_transform(transform(ims, t), t)`` is ``ims`` up to the
        resampling."""
        if self.use_matmul_warp:
            return inverse_affine_warp_matmul_t(ims, t)
        inv_s = 1.0 / t[:, 0]
        inv_trans = -(t[:, 1:] / t[:, :1])
        theta = self._theta(inv_s, inv_trans)
        return grid_sample(ims, affine_grid(theta, ims.shape[1:3]))

    def __str__(self):
        return f"SpatialTransform: t={self.t.tolist()}"
