"""Collage and host-side image formatting (counterpart of the collage subset
of ``pix2latent_tpu/utils/image.py``): ``to_grid``, ``to_image``,
``center_crop``, ``binarize`` and ``smart_resize``.

Images are NHWC (``[N, H, W, C]``) or HWC, float in [-1, 1], as numpy arrays
or tensors on any device (tensors are read to the host first). Reading and
writing image files needs an image codec and is not ported yet.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from pix2latent_tpu_torch.utils.misc import to_numpy


def to_grid(x, pad_value=-1.0):
    """Collage a batch ``[N, H, W, C]`` into one image: rows of
    ``ceil(sqrt(N))`` tiles with 2-pixel borders of ``pad_value``."""
    x = to_numpy(x)
    n, h, w, c = x.shape
    cols = int(math.ceil(math.sqrt(n)))
    rows = int(math.ceil(n / cols))
    pad = 2
    grid = np.full((rows * (h + pad) + pad, cols * (w + pad) + pad, c),
                   pad_value, x.dtype)
    for i in range(n):
        r, cc = divmod(i, cols)
        top = r * (h + pad) + pad
        left = cc * (w + pad) + pad
        grid[top:top + h, left:left + w] = x[i]
    return grid


def to_image(output, denormalize=True, jpg_format=True):
    """[-1, 1] float image(s) -> uint8 in [0, 255] (``jpg_format``), or
    float in [0, 1] without it."""
    x = np.asarray(to_numpy(output), np.float32)
    if denormalize:
        x = (x + 1.0) / 2.0
    if jpg_format:
        x = np.clip(x * 255.0, 0, 255).astype(np.uint8)
    return x


def binarize(mask, min=0.0, max=1.0, eps=1e-3):
    """Continuous mask -> {0, 1} float32 (values above ``1 - eps`` are 1),
    clipped to ``[min, max]``; a tensor stays a tensor on its device."""
    if isinstance(mask, torch.Tensor):
        return (mask > 1.0 - eps).float().clamp(min, max)
    out = (np.asarray(mask) > 1.0 - eps).astype(np.float32)
    return np.clip(out, min, max)


def center_crop(image):
    """Square center crop along the longer of the first two axes."""
    h, w = image.shape[:2]
    if h > w:
        st = (h - w) // 2
        out = image[st:st + w]
    else:
        st = (w - h) // 2
        out = image[:, st:st + h]
    if out.shape[0] != out.shape[1]:
        raise ValueError(f"center_crop: got {tuple(out.shape)}")
    return out


def smart_resize(im, target_size=(256, 256)):
    """Resize an HWC image to ``target_size`` (h, w) on the host: area
    averaging when the image shrinks (``F.interpolate(mode="area")``, the
    block mean at integer factors, as cv2's ``INTER_AREA``), bilinear with
    half-pixel centers when it grows (cv2's ``INTER_LINEAR``). A uint8 image
    is rounded back to uint8."""
    im = to_numpy(im)
    th, tw = int(target_size[0]), int(target_size[1])
    x = torch.as_tensor(np.asarray(im, np.float32))
    squeeze = x.dim() == 2
    if squeeze:
        x = x[..., None]
    x = x.permute(2, 0, 1)[None]
    if np.prod(im.shape[:2]) >= th * tw:
        y = F.interpolate(x, size=(th, tw), mode="area")
    else:
        y = F.interpolate(x, size=(th, tw), mode="bilinear",
                          align_corners=False)
    y = y[0].permute(1, 2, 0)
    if squeeze:
        y = y[..., 0]
    y = y.numpy()
    if im.dtype == np.uint8:
        return np.clip(np.rint(y), 0, 255).astype(np.uint8)
    return y.astype(im.dtype)
