"""Differentiable color transforms (counterpart of
``pix2latent_tpu/transform/color.py``).

Every transform is a tensor function (torchvision's ``adjust_*``
semantics), so it runs on the images' device and can be differentiated.
Images are NHWC in [-1, 1]; the parameter ``t`` is ``[N, 1]``, clamped to
the transform's range. The inverse uses the parameter's inverse: negation
for hue, the reciprocal for the rest.
"""

from __future__ import annotations

import numpy as np
import torch

from pix2latent_tpu_torch.transform.base import TransformTemplate
from pix2latent_tpu_torch.utils.device import resolve_device


def _to01(ims):
    return (ims + 1.0) * 0.5


def _from01(ims):
    return ims.clamp(0.0, 1.0) * 2.0 - 1.0


def _gray(ims01):
    """ITU-R 601-2 luma (PIL's 'L', torchvision's rgb_to_grayscale),
    ``[..., 1]``."""
    return (0.299 * ims01[..., 0:1] + 0.587 * ims01[..., 1:2]
            + 0.114 * ims01[..., 2:3])


def rgb_to_hsv(rgb):
    """RGB to HSV on [0, 1] images; h, s and v each in [0, 1]."""
    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    maxc = rgb.amax(dim=-1)
    minc = rgb.amin(dim=-1)
    v = maxc
    rng = maxc - minc
    zero = torch.zeros_like(maxc)
    s = torch.where(maxc > 0, rng / maxc.clamp_min(1e-12), zero)
    rng_safe = rng.clamp_min(1e-12)
    rc = (maxc - r) / rng_safe
    gc = (maxc - g) / rng_safe
    bc = (maxc - b) / rng_safe
    h = torch.where(maxc == r, bc - gc,
                    torch.where(maxc == g, 2.0 + rc - bc, 4.0 + gc - rc))
    # a floor modulo (Python's %), as jnp's: fmod would keep the sign
    h = torch.where(rng > 0, torch.remainder(h / 6.0, 1.0), zero)
    return torch.stack([h, s, v], dim=-1)


def _select(i, values):
    """``values[i]`` elementwise for ``i`` in 0 .. 5 (nested wheres)."""
    out = values[5]
    for k in range(4, -1, -1):
        out = torch.where(i == k, values[k], out)
    return out


def hsv_to_rgb(hsv):
    h, s, v = hsv[..., 0], hsv[..., 1], hsv[..., 2]
    i = torch.floor(h * 6.0)
    f = h * 6.0 - i
    p = v * (1.0 - s)
    q = v * (1.0 - s * f)
    t = v * (1.0 - s * (1.0 - f))
    i = torch.remainder(i.to(torch.int32), 6)
    r = _select(i, (v, q, p, p, t, v))
    g = _select(i, (t, v, v, q, p, p))
    b = _select(i, (p, p, t, v, v, q))
    return torch.stack([r, g, b], dim=-1)


class ColorTransform(TransformTemplate):
    """A per-sample scalar color transform, clamped to ``t_range`` and
    inverted through ``t_inv_fn``."""

    def __init__(self, fn, t=(1.0,), t_range=(0.667, 1.5), t_inv_fn=None,
                 optimize=True, device="cuda"):
        assert t_range[1] > t_range[0], "t_range should be increasing"
        self.device = resolve_device(device)
        self.fn = fn
        self.t = np.asarray(t, np.float32)
        self._t = torch.tensor(self.t, device=self.device)
        self.t_inv_fn = t_inv_fn
        self.t_min, self.t_max = float(t_range[0]), float(t_range[1])
        self.is_spatial = False
        self.optimize = optimize

    def get_opt_param(self):
        return self.t if self.optimize else np.zeros((0,), np.float32)

    def get_default_param(self, as_tensor=True):
        return self._t if as_tensor else self.t

    def get_identity_param(self, as_tensor=True):
        return self.get_default_param(as_tensor)

    def apply(self, ims, t, invert=False):
        assert ims.shape[0] == t.shape[0]
        if invert:
            t = self.t_inv_fn(t)
        t = t.clamp(self.t_min, self.t_max).reshape(-1, 1, 1, 1)
        return _from01(self.fn(_to01(ims), t))

    def __call__(self, ims, t, invert=False):
        return self.apply(ims, t, invert)

    def transform(self, ims, t):
        return self.apply(ims, t, invert=False)

    def invert_transform(self, ims, t):
        return self.apply(ims, t, invert=True)

    def __str__(self):
        return f"{type(self).__name__}: t={self.t.tolist()}"


def _negate(x):
    return -x


def _invert(x):
    return 1.0 / x


def _adj_hue(ims01, t):
    hsv = rgb_to_hsv(ims01)
    h = torch.remainder(hsv[..., 0:1] + t[..., 0:1], 1.0)
    return hsv_to_rgb(torch.cat([h, hsv[..., 1:]], dim=-1))


def _adj_brightness(ims01, t):
    return ims01 * t


def _adj_gamma(ims01, t):
    return ims01.clamp_min(1e-8) ** t


def _adj_saturation(ims01, t):
    return t * ims01 + (1.0 - t) * _gray(ims01)


def _adj_contrast(ims01, t):
    mean = _gray(ims01).mean(dim=(1, 2, 3), keepdim=True)
    return t * ims01 + (1.0 - t) * mean


class HueTransform(ColorTransform):
    def __init__(self, t=(0.0,), t_min=-0.5, t_max=0.5, device="cuda"):
        super().__init__(fn=_adj_hue, t=t,
                         t_range=(t_min + 1e-6, t_max - 1e-6),
                         t_inv_fn=_negate, device=device)


class BrightnessTransform(ColorTransform):
    def __init__(self, t=(1.0,), t_min=0.667, t_max=1.5, device="cuda"):
        super().__init__(fn=_adj_brightness, t=t, t_range=(t_min, t_max),
                         t_inv_fn=_invert, device=device)


class GammaTransform(ColorTransform):
    def __init__(self, t=(1.0,), t_min=0.667, t_max=1.5, device="cuda"):
        super().__init__(fn=_adj_gamma, t=t, t_range=(t_min, t_max),
                         t_inv_fn=_invert, device=device)


class SaturationTransform(ColorTransform):
    def __init__(self, t=(1.0,), t_min=0.667, t_max=1.5, device="cuda"):
        super().__init__(fn=_adj_saturation, t=t, t_range=(t_min, t_max),
                         t_inv_fn=_invert, device=device)


class ContrastTransform(ColorTransform):
    def __init__(self, t=(1.0,), t_min=0.667, t_max=1.5, device="cuda"):
        super().__init__(fn=_adj_contrast, t=t, t_range=(t_min, t_max),
                         t_inv_fn=_invert, device=device)
