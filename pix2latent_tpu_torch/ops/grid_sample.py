"""Bilinear warp: ``affine_grid`` + ``grid_sample`` on NHWC images
(counterpart of ``pix2latent_tpu/ops/grid_sample.py``).

PyTorch's ``F.affine_grid`` and ``F.grid_sample`` compute exactly the JAX
package's gather formulation (bilinear, zero padding,
``align_corners=False``), so these wrap them and keep the package's NHWC
layout. Gradients reach the affine parameters through the sampling grid.
"""

from __future__ import annotations

import torch.nn.functional as F


def affine_grid(theta, size):
    """Normalized sampling grid ``[N, H, W, 2]`` of (x, y) source coordinates
    for ``theta [N, 2, 3]`` (``[x_src, y_src] = theta @ [x_dst, y_dst, 1]``)
    at the output size ``(H, W)``."""
    h, w = size
    return F.affine_grid(theta, [theta.shape[0], 1, int(h), int(w)],
                         align_corners=False)


def grid_sample(im, grid):
    """Sample ``im [N, H, W, C]`` at ``grid [N, Ho, Wo, 2]`` (normalized
    coordinates in [-1, 1]): ``[N, Ho, Wo, C]``."""
    out = F.grid_sample(im.permute(0, 3, 1, 2), grid, mode="bilinear",
                        padding_mode="zeros", align_corners=False)
    return out.permute(0, 2, 3, 1)


def affine_warp(im, theta):
    """``grid_sample(im, affine_grid(theta, im.shape[1:3]))``."""
    return grid_sample(im, affine_grid(theta, im.shape[1:3]))
