"""LPIPS (Learned Perceptual Image Patch Similarity) in PyTorch
(counterpart of ``pix2latent_tpu/losses/lpips.py``; the alex backbone).

Inputs are NHWC in [-1, 1]. ``spatial=True`` returns a per-pixel distance
map ``[N, H, W, 1]``, else a per-sample value ``[N]``. ``dtype`` sets the
backbone's compute precision; the unit-normalization, the squared
difference and the linear heads run in float32.
"""

from __future__ import annotations

import warnings
from typing import Optional

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from pix2latent_tpu_torch.utils.device import resolve_device
from pix2latent_tpu_torch.utils.params_io import (_flatten, from_jax_params,
                                                  jax_to_torch_array,
                                                  load_params_npz,
                                                  sorted_jax_leaves)

# LPIPS input scaling layer (lpips/lpips.py ScalingLayer constants)
_SHIFT = np.array([-0.030, -0.088, -0.188], np.float32)
_SCALE = np.array([0.458, 0.448, 0.450], np.float32)

NET_CHANNELS = {"alex": (64, 192, 384, 256, 256)}


class AlexNetFeatures(nn.Module):
    """torchvision AlexNet.features; returns the five ReLU taps (NCHW)."""

    def __init__(self):
        super().__init__()
        self.conv1 = nn.Conv2d(3, 64, 11, stride=4, padding=2)
        self.conv2 = nn.Conv2d(64, 192, 5, padding=2)
        self.conv3 = nn.Conv2d(192, 384, 3, padding=1)
        self.conv4 = nn.Conv2d(384, 256, 3, padding=1)
        self.conv5 = nn.Conv2d(256, 256, 3, padding=1)

    def forward(self, x):
        def conv(layer, h):
            return F.conv2d(h, layer.weight.to(h.dtype), layer.bias.to(h.dtype),
                            stride=layer.stride, padding=layer.padding)

        taps = []
        x = F.relu(conv(self.conv1, x)); taps.append(x)
        x = F.max_pool2d(x, 3, 2)
        x = F.relu(conv(self.conv2, x)); taps.append(x)
        x = F.max_pool2d(x, 3, 2)
        x = F.relu(conv(self.conv3, x)); taps.append(x)
        x = F.relu(conv(self.conv4, x)); taps.append(x)
        x = F.relu(conv(self.conv5, x)); taps.append(x)
        return taps


_BACKBONES = {"alex": AlexNetFeatures}


def _unit_normalize(feat, eps=1e-10):
    """Channel-wise unit normalization (lpips normalize_tensor), NCHW."""
    norm = torch.sqrt((feat ** 2).sum(dim=1, keepdim=True))
    return feat / (norm + eps)


def random_init_(module: nn.Module):
    """The JAX package's deterministic random init (``random_init_params``):
    ``np.random.RandomState(0)`` in its leaf order; squared linear heads,
    He-scaled conv kernels, zero biases."""
    rng = np.random.RandomState(0)
    params = dict(module.named_parameters())
    with torch.no_grad():
        for path, shape, name in sorted_jax_leaves(module):
            arr = np.asarray(rng.randn(*shape), np.float32)
            if any(p.startswith("lin") for p in path.split("/")):
                arr = (arr ** 2) * 10.0 / shape[-2]
            elif path.endswith("bias"):
                arr = np.zeros(shape, np.float32)
            else:
                fan_in = int(np.prod(shape[:-1])) or 1
                arr = arr * np.sqrt(2.0 / fan_in)
            params[name].copy_(torch.as_tensor(
                jax_to_torch_array(path, np.asarray(arr, np.float32))))


class LPIPS(nn.Module):
    """LPIPS distance: backbone taps -> unit-norm -> squared diff -> 1x1
    linear heads -> (bilinear upsample) -> sum.

    :meth:`features` computes one batch's normalized pyramid, so a fixed
    target's pyramid can be computed once; ``forward(x, y)`` is exactly
    ``distance(x, features(y))``. ``params`` is the JAX package's LPIPS
    tree (nested or flat); ``pretrained_path`` a ``save_params_npz`` file.
    Without either, the JAX package's deterministic random init.
    """

    def __init__(self, net: str = "alex", params=None,
                 pretrained_path: Optional[str] = None, spatial: bool = True,
                 dtype=torch.float32, device="cuda"):
        super().__init__()
        if net not in _BACKBONES:
            raise ValueError(f"unknown LPIPS net {net!r}; the port has "
                             f"{sorted(_BACKBONES)}")
        device = resolve_device(device)
        self.net = net
        self.spatial = spatial
        self.dtype = dtype
        self.backbone = _BACKBONES[net]()
        self.n_taps = len(NET_CHANNELS[net])
        for i, ch in enumerate(NET_CHANNELS[net]):
            setattr(self, f"lin{i}", nn.Conv2d(ch, 1, 1, bias=False))
        if params is None and pretrained_path:
            params = load_params_npz(pretrained_path)
        if params is not None:
            if any(isinstance(v, dict) for v in params.values()):
                params = _flatten(params)
            self.load_state_dict(from_jax_params(params), strict=True)
        else:
            warnings.warn("LPIPS: no pretrained weights — deterministic "
                          "random init", stacklevel=2)
            random_init_(self)
        self.register_buffer("shift", torch.as_tensor(_SHIFT))
        self.register_buffer("scale", torch.as_tensor(_SCALE))
        self.requires_grad_(False)
        self.to(device)

    def features(self, y):
        """Scaled, backbone, unit-normalized pyramid of NHWC ``y`` (f32 NCHW
        list, one entry per tap)."""
        y = ((y - self.shift) / self.scale).to(self.dtype).permute(0, 3, 1, 2)
        return [_unit_normalize(f.float()) for f in self.backbone(y)]

    def distance(self, x, fy):
        """LPIPS distance of NHWC ``x`` against precomputed :meth:`features`
        ``fy`` (batch 1 or matching ``x``)."""
        out_hw = x.shape[1:3]
        fx = self.features(x)
        total = 0.0
        for i, (a, b) in enumerate(zip(fx, fy)):
            m = F.conv2d((a - b) ** 2, getattr(self, f"lin{i}").weight)
            if self.spatial:
                m = F.interpolate(m, size=tuple(out_hw), mode="bilinear",
                                  align_corners=False)
            else:
                m = m.mean(dim=(2, 3), keepdim=True)
            total = total + m
        if self.spatial:
            return total.permute(0, 2, 3, 1)        # [N, H, W, 1]
        return total.reshape(total.shape[0])         # [N]

    def forward(self, x, y):
        return self.distance(x, self.features(y))
