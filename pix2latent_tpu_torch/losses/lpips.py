"""LPIPS (Learned Perceptual Image Patch Similarity) in PyTorch
(counterpart of ``pix2latent_tpu/losses/lpips.py``): the alex, vgg16 and
squeeze backbones.

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

NET_CHANNELS = {
    "alex": (64, 192, 384, 256, 256),
    "vgg": (64, 128, 256, 512, 512),
    "vgg16": (64, 128, 256, 512, 512),
    "squeeze": (64, 128, 256, 384, 384, 512, 512),
}


def _conv(layer, h, padding=None):
    """``layer``'s conv in ``h``'s dtype."""
    return F.conv2d(h, layer.weight.to(h.dtype), layer.bias.to(h.dtype),
                    stride=layer.stride,
                    padding=layer.padding if padding is None else padding)


def _same_pad(x, k, stride):
    """Zero-pad NCHW ``x`` as Flax's default ``padding="SAME"`` does for a
    ``k``x``k`` conv of ``stride``: ``ceil(n / stride)`` outputs, the odd
    pixel of padding at the end."""
    pads = []
    for n in (x.shape[3], x.shape[2]):
        total = max((-(-n // stride) - 1) * stride + k - n, 0)
        pads += [total // 2, total - total // 2]
    return F.pad(x, pads)


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
        taps = []
        x = F.relu(_conv(self.conv1, x)); taps.append(x)
        x = F.max_pool2d(x, 3, 2)
        x = F.relu(_conv(self.conv2, x)); taps.append(x)
        x = F.max_pool2d(x, 3, 2)
        x = F.relu(_conv(self.conv3, x)); taps.append(x)
        x = F.relu(_conv(self.conv4, x)); taps.append(x)
        x = F.relu(_conv(self.conv5, x)); taps.append(x)
        return taps


class VGG16Features(nn.Module):
    """torchvision VGG16.features; taps at relu1_2, 2_2, 3_3, 4_3, 5_3."""

    STAGES = ((64, 2), (128, 2), (256, 3), (512, 3), (512, 3))

    def __init__(self):
        super().__init__()
        idx, in_ch = 0, 3
        for ch, reps in self.STAGES:
            for _ in range(reps):
                setattr(self, f"conv{idx}", nn.Conv2d(in_ch, ch, 3, padding=1))
                idx, in_ch = idx + 1, ch

    def forward(self, x):
        taps, idx = [], 0
        for stage, (_, reps) in enumerate(self.STAGES):
            for _ in range(reps):
                x = F.relu(_conv(getattr(self, f"conv{idx}"), x))
                idx += 1
            taps.append(x)
            if stage < len(self.STAGES) - 1:
                x = F.max_pool2d(x, 2, 2)
        return taps


class _Fire(nn.Module):
    def __init__(self, in_ch, squeeze, expand):
        super().__init__()
        self.squeeze = nn.Conv2d(in_ch, squeeze, 1)
        self.expand1x1 = nn.Conv2d(squeeze, expand, 1)
        self.expand3x3 = nn.Conv2d(squeeze, expand, 3, padding=1)

    def forward(self, x):
        s = F.relu(_conv(self.squeeze, x))
        return torch.cat([F.relu(_conv(self.expand1x1, s)),
                          F.relu(_conv(self.expand3x3, s))], dim=1)


class SqueezeNetFeatures(nn.Module):
    """SqueezeNet 1.1 features with seven taps, as the JAX package has them:
    its first conv pads "SAME" (``_same_pad``) and its max pools drop a
    ragged edge, where torchvision pads 0 and rounds the pools up."""

    FIRES = ((2, 64, 16, 64), (3, 128, 16, 64), (4, 128, 32, 128),
             (5, 256, 32, 128), (6, 256, 48, 192), (7, 384, 48, 192),
             (8, 384, 64, 256), (9, 512, 64, 256))

    def __init__(self):
        super().__init__()
        self.conv1 = nn.Conv2d(3, 64, 3, stride=2)
        for i, in_ch, sq, ex in self.FIRES:
            setattr(self, f"fire{i}", _Fire(in_ch, sq, ex))

    def forward(self, x):
        taps = []
        x = F.relu(_conv(self.conv1, _same_pad(x, 3, 2), padding=0))
        taps.append(x)
        x = F.max_pool2d(x, 3, 2)
        x = self.fire3(self.fire2(x)); taps.append(x)
        x = F.max_pool2d(x, 3, 2)
        x = self.fire5(self.fire4(x)); taps.append(x)
        x = F.max_pool2d(x, 3, 2)
        for i in (6, 7, 8, 9):
            x = getattr(self, f"fire{i}")(x); taps.append(x)
        return taps


_BACKBONES = {"alex": AlexNetFeatures, "vgg": VGG16Features,
              "vgg16": VGG16Features, "squeeze": SqueezeNetFeatures}


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


# lpips-package checkpoint layout: (slice, index) of each backbone conv of
# ``net.slice{s}.{i}`` (torchvision's feature indices)
_ALEX_TORCH = {f"conv{i + 1}": (i + 1, ti) for i, ti in enumerate(
    (0, 3, 6, 8, 10))}
_VGG_TORCH = {f"conv{j}": (s + 1, ti) for j, (s, ti) in enumerate(
    (s, ti) for s, ids in enumerate(([0, 2], [5, 7], [10, 12, 14],
                                     [17, 19, 21], [24, 26, 28]))
    for ti in ids)}
_SQUEEZE_TORCH = {"conv1": (1, 0), "fire2": (2, 3), "fire3": (2, 4),
                  "fire4": (3, 6), "fire5": (3, 7), "fire6": (4, 9),
                  "fire7": (5, 10), "fire8": (6, 11), "fire9": (7, 12)}
_TORCH_LAYOUT = {"alex": _ALEX_TORCH, "vgg": _VGG_TORCH, "vgg16": _VGG_TORCH,
                 "squeeze": _SQUEEZE_TORCH}


def convert_torch_lpips(state_dict, net: str = "alex"):
    """An ``lpips`` package checkpoint (torchvision backbone weights as
    ``net.slice{s}.{i}.*`` and heads ``lin{i}.model.1.weight``) as the JAX
    package's flat parameter dict (``/`` paths, HWIO kernels), which
    :class:`LPIPS` loads. Covers alex, vgg16 and squeeze (whose fire modules
    keep torchvision's ``squeeze``, ``expand1x1``, ``expand3x3``)."""
    if net not in _TORCH_LAYOUT:
        raise ValueError(f"unknown LPIPS net {net!r}")

    def arr(key):
        v = state_dict[key]
        v = v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else v
        return np.asarray(v, np.float32)

    params = {}

    def conv(dst, src):
        params[f"{dst}/kernel"] = arr(f"{src}.weight").transpose(2, 3, 1, 0)
        if f"{src}.bias" in state_dict:
            params[f"{dst}/bias"] = arr(f"{src}.bias")

    for name, (sl, ti) in _TORCH_LAYOUT[net].items():
        src = f"net.slice{sl}.{ti}"
        if name.startswith("fire"):
            for part in ("squeeze", "expand1x1", "expand3x3"):
                conv(f"backbone/{name}/{part}", f"{src}.{part}")
        else:
            conv(f"backbone/{name}", src)
    for i in range(len(NET_CHANNELS[net])):
        params[f"lin{i}/kernel"] = arr(f"lin{i}.model.1.weight").transpose(
            2, 3, 1, 0)
    return params


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
