"""Axis-aligned affine warp as two products (counterpart of
``pix2latent_tpu/ops/affine_matmul.py``).

The spatial transform is scale + translation only, so its bilinear resample
is separable: every output row reads a fixed pair of source rows and every
output column a fixed pair of source columns, and the whole warp is

    out[n] = R_y(t_n)^T @ im[n] @ R_x(t_n)

with dense interpolation matrices built elementwise from the parameter
(``max(0, 1 - |px_j - i|)`` is the bilinear weight, and zero outside the
footprint, which is zero padding). It equals ``F.grid_sample`` of
``F.affine_grid`` with ``theta = [[s, 0, tx], [0, s, ty]]``
(bilinear, zero padding, ``align_corners=False``) and is differentiable in
the parameter. Images are NHWC; the result is float32 whatever the input
dtype.
"""

from __future__ import annotations

import torch


def _axis_weights(in_size: int, out_size: int, scale, trans):
    """Bilinear interpolation matrices ``[N, in_size, out_size]`` for one
    axis, one per sample.

    Output pixel j samples the normalized coordinate ``g = c_j * scale +
    trans`` (``c_j = (2j + 1) / out_size - 1``), that is source pixel ``px =
    ((g + 1) * in_size - 1) / 2``, with weight ``max(0, 1 - |px - i|)``
    against source pixel i. ``torch.maximum`` splits the gradient at the
    kink as the JAX package's ``jnp.maximum`` does."""
    dev = scale.device
    coords = (2.0 * torch.arange(out_size, dtype=torch.float32, device=dev)
              + 1.0) / out_size - 1.0
    g = coords[None, :] * scale[:, None] + trans[:, None]          # [N, out]
    px = ((g + 1.0) * in_size - 1.0) * 0.5
    idx = torch.arange(in_size, dtype=torch.float32, device=dev)   # [in]
    w = 1.0 - (px[:, None, :] - idx[None, :, None]).abs()
    return torch.maximum(w, w.new_zeros(()))


def affine_warp_matmul(im, scale, trans_x, trans_y):
    """Warp ``im [N, H, W, C]`` by per-sample scale and translation
    (``[N]`` each): rows by ``trans_y`` over H, columns by ``trans_x`` over
    W."""
    n, h, w, c = im.shape
    im = im.float()
    scale = scale.float()
    wy = _axis_weights(h, h, scale, trans_y.float())     # [N, h, H]
    wx = _axis_weights(w, w, scale, trans_x.float())     # [N, w, W]
    tmp = torch.einsum("nhwc,nhH->nHwc", im, wy)
    return torch.einsum("nHwc,nwW->nHWc", tmp, wx)


def affine_warp_matmul_t(im, t):
    """``t [N, 3] = [s, tx, ty]`` (the spatial transform's layout)."""
    return affine_warp_matmul(im, t[:, 0], t[:, 1], t[:, 2])


def inverse_affine_warp_matmul_t(im, t):
    """The exact inverse warp: parameters ``[1/s, -tx/s, -ty/s]``."""
    inv_s = 1.0 / t[:, 0]
    return affine_warp_matmul(im, inv_s, -t[:, 1] * inv_s, -t[:, 2] * inv_s)
