"""Mask statistics, pre-alignment and setup_transform_fn (counterpart of
``pix2latent_tpu/transform/utils.py``).

Masks are ``[H, W, C]`` (NHWC without the batch axis), as numpy arrays or
tensors on any device; the statistics are computed on the host.
"""

from __future__ import annotations

import numpy as np
import torch

from pix2latent_tpu_torch.utils.image import binarize
from pix2latent_tpu_torch.utils.misc import to_numpy


def get_biggan_stats():
    """BigGAN's object prior: where it tends to put the object, as
    fractions of the image, ``(center (h, w), size (h, w))``."""
    center_of_mass = [137 / 255.0, 127 / 255.0]
    object_size = [213 / 255.0, 210 / 255.0]
    return center_of_mass, object_size


def bbox_from_mask(mask):
    """Bounding box ``(st_h, st_w, en_h, en_w)`` of the nonzero region of an
    ``[H, W, C]`` mask; the whole image when the mask is empty."""
    mask = to_numpy(mask)
    assert mask.ndim == 3, f"expected [H,W,C] mask, got {mask.shape}"
    m = mask.mean(-1)
    rows = np.nonzero(m.sum(1))[0]
    cols = np.nonzero(m.sum(0))[0]
    st_h, en_h = (int(rows[0]), int(rows[-1])) if rows.size else (0, m.shape[0])
    st_w, en_w = (int(cols[0]), int(cols[-1])) if cols.size else (0, m.shape[1])
    return st_h, st_w, en_h, en_w


def compute_stat_from_mask(mask):
    """Object center and size as fractions of the image,
    ``((center_h, center_w), (size_h, size_w))``."""
    mask = to_numpy(mask)
    if mask.ndim == 4:
        mask = mask[0]
    st_h, st_w, en_h, en_w = bbox_from_mask(mask)
    obj_h, obj_w = en_h - st_h, en_w - st_w
    obj_center = (st_h + obj_h // 2, st_w + obj_w // 2)
    h, w = mask.shape[:2]
    return ((obj_center[0] / h, obj_center[1] / w),
            (obj_h / h, obj_w / w))


def convert_to_t(src_center, src_size, dst_center, dst_size):
    """The parameter ``t = [s, tx, ty]`` (a float32 CPU tensor) that maps an
    object at the source center and size onto the destination's."""
    src_center, src_size = np.array(src_center), np.array(src_size)
    dst_center, dst_size = np.array(dst_center), np.array(dst_size)
    scale_idx = int(np.argmax(src_size))
    s = (src_size / dst_size)[scale_idx]
    dxy = (src_center - dst_center) * 2.0
    return torch.tensor([s, *dxy[::-1]], dtype=torch.float32)


def compute_pre_alignment(weight):
    """Initial ``t`` from a (continuous) mask, aimed at BigGAN's object
    prior."""
    dst_center, dst_size = get_biggan_stats()
    src_center, src_size = compute_stat_from_mask(binarize(to_numpy(weight)))
    return convert_to_t(src_center, src_size, dst_center, dst_size)


def setup_transform_fn(args=None, weight=None, spatial_transform=False,
                       align=False, color_transform=(), sensitivity=0.1,
                       color_weight=0.2, device="cuda"):
    """A ComposeTransform and its default parameter ``[1, dim]`` (on
    ``device``) from flags: an argparse namespace (``spatial_transform``,
    ``align``, ``color_transform``) or the keywords. ``(None, None)`` when
    nothing is enabled.

    ``color_weight`` is 0.2, as in the JAX package, not the reference's 5:
    CMA searches ``t`` at sigma 1, and a weight of 5 makes one sigma of hue
    span ten times hue's range [-0.5, 0.5], so nearly every sample would
    sit on a clamp rail; at 0.2 the rails are about 2.5 sigma away."""
    from pix2latent_tpu_torch.transform.color import (BrightnessTransform,
                                                      ContrastTransform,
                                                      GammaTransform,
                                                      HueTransform,
                                                      SaturationTransform)
    from pix2latent_tpu_torch.transform.compose import ComposeTransform
    from pix2latent_tpu_torch.transform.spatial import SpatialTransform

    if args is not None:
        spatial_transform = getattr(args, "spatial_transform",
                                    spatial_transform)
        align = getattr(args, "align", align)
        color_transform = getattr(args, "color_transform", color_transform)

    transform_list = []
    if spatial_transform or align:
        pre = weight if (align and weight is not None) else None
        transform_list.append((SpatialTransform(
            pre_align=pre, sensitivity=sensitivity, device=device), 1.0))

    color_classes = {
        "hue": HueTransform, "gamma": GammaTransform,
        "saturation": SaturationTransform, "brightness": BrightnessTransform,
        "contrast": ContrastTransform,
    }
    # ordered by how much of the image each keeps, as the reference orders
    # them
    for name in ("hue", "gamma", "saturation", "brightness", "contrast"):
        if name in color_transform:
            transform_list.append((color_classes[name](device=device),
                                   color_weight))

    if not transform_list:
        return None, None
    fn = ComposeTransform(transform_list)
    return fn, fn.get_param(as_tensor=True)[None]
