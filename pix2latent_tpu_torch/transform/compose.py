"""Weighted composition of transforms over one concatenated parameter
vector (counterpart of ``pix2latent_tpu/transform/compose.py``).

Each sub-transform owns a slice of ``t``; a per-transform weight rescales
the searched delta around the sub-transform's default (``reweight``), since
the parameters live at different scales.
"""

from __future__ import annotations

import numpy as np
import torch

from pix2latent_tpu_torch.transform.base import TransformTemplate


class ComposeTransform(TransformTemplate):

    def __init__(self, transform_list):
        """``transform_list``: transforms or ``(transform, weight)`` pairs;
        a missing weight is 1. The transforms must share one device, where
        the composition keeps each slice's default."""
        assert isinstance(transform_list, list)
        self.transform_list = []
        for t_fn in transform_list:
            if isinstance(t_fn, (tuple, list)):
                self.transform_list.append(list(t_fn))
            else:
                self.transform_list.append([t_fn, 1.0])
        devices = {fn.device for fn, _ in self.transform_list}
        if len(devices) != 1:
            raise ValueError(f"the transforms live on several devices: "
                             f"{sorted(map(str, devices))}")
        self.device = devices.pop()
        self._t = [np.asarray(fn.t, np.float32)
                   for fn, _ in self.transform_list]
        # each slice's default on the device, made once: a host tensor
        # copied there per call would wait for the device
        self._t_dev = [torch.tensor(t, device=self.device) for t in self._t]
        self.is_spatial = any(fn.is_spatial for fn, _ in self.transform_list)

    def get_param(self, as_tensor=False):
        """Default parameters: a list per sub-transform, or concatenated on
        the device."""
        if as_tensor:
            return torch.cat(self._t_dev)
        return [t.copy() for t in self._t]

    def get_default_param(self, as_tensor=True):
        return self.get_param(as_tensor=True) if as_tensor \
            else np.concatenate(self._t)

    def get_identity_param(self, as_tensor=True):
        ident = np.concatenate(
            [np.asarray(fn.get_identity_param(as_tensor=False), np.float32)
             for fn, _ in self.transform_list])
        return torch.tensor(ident, device=self.device) if as_tensor else ident

    def get_opt_param(self):
        """The optimizable parameters, concatenated."""
        parts = [np.atleast_1d(np.asarray(fn.get_opt_param(), np.float32))
                 for fn, _ in self.transform_list]
        return np.concatenate([p for p in parts if p.size])

    def get_search_identity(self, as_tensor=False):
        """The searched vector at which every sub-transform is the identity,
        the CMA seed of a composed search: zero for a spatial slice (it
        searches a delta), the default for a color slice (``reweight`` is
        the identity at ``t = t_mu``). A zero seed would put weighted color
        slices at their clamp rails (brightness ``0.2 * (0 - 1) + 1``)."""
        parts = [np.zeros_like(t) if fn.is_spatial else t.copy()
                 for (fn, _), t in zip(self.transform_list, self._t)]
        ident = np.concatenate(parts).astype(np.float32)
        return torch.tensor(ident, device=self.device) if as_tensor else ident

    @staticmethod
    def reweight(t, weight, t_mean):
        """Scale the searched delta around the default."""
        return weight * (t - t_mean) + t_mean

    def __call__(self, ims, t, invert=False, only_spatial=False):
        """Apply all (or only the spatial) sub-transforms in registration
        order; a one-row ``t`` applies to every image."""
        if t.shape[0] == 1 and ims.shape[0] != 1:
            t = t.expand(ims.shape[0], t.shape[1])

        t_i = 0
        for i, (fn, fn_weight) in enumerate(self.transform_list):
            t_sz = len(fn.t)
            if fn.is_spatial or not only_spatial:
                t_param = t[:, t_i:t_i + t_sz]
                t_mu = self._t_dev[i].to(t_param.dtype)
                ims = fn(ims, self.reweight(t_param, fn_weight, t_mu),
                         invert=invert)
            t_i += t_sz
        return ims

    def transform(self, ims, t):
        return self(ims, t, invert=False)

    def invert_transform(self, ims, t):
        return self(ims, t, invert=True)

    def __str__(self):
        inner = "\n\t".join(str(f[0]) for f in self.transform_list)
        return f"<ComposeTransform\n\t{inner}\n>"


class SpatialOnly(TransformTemplate):
    """A ComposeTransform restricted to its spatial sub-transforms.

    Register this as the weight's transform in a composed spatial + color
    search: color transforms act on [-1, 1] images and corrupt a 0/1 mask
    (brightness maps its zeros to ``t - 1``), while the spatial warp must
    travel with the target. The parameter is the whole composed ``t``, so
    one registered variable drives both."""

    def __init__(self, compose: ComposeTransform):
        self.compose = compose
        self.is_spatial = True
        self.device = compose.device

    def __call__(self, ims, t, invert=False):
        return self.compose(ims, t, invert=invert, only_spatial=True)

    def get_default_param(self, as_tensor=True):
        return self.compose.get_default_param(as_tensor)

    def get_identity_param(self, as_tensor=True):
        return self.compose.get_identity_param(as_tensor)

    def transform(self, ims, t):
        return self.compose(ims, t, invert=False, only_spatial=True)

    def invert_transform(self, ims, t):
        return self.compose(ims, t, invert=True, only_spatial=True)
