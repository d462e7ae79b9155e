"""The inversion objective in plain PyTorch: ProjectionLoss, a weighted L1
plus ``beta`` times spatial LPIPS (Zhang et al., arXiv:1801.03924) over the
AlexNet backbone, with per-sample means.

Images are NHWC in [-1, 1]. LPIPS: the lpips package's scaling layer,
AlexNet's five ReLU taps, channel-wise unit normalization, squared
difference, a 1x1 linear head per tap, bilinear upsampling to the image
size, summed. Both terms are pooled per sample under the weight (times the
loss mask where one is given), a 3-channel weight averaged onto LPIPS's
one channel.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

SHIFT = (-0.030, -0.088, -0.188)
SCALE = (0.458, 0.448, 0.450)
ALEX = (("conv1", 3, 64, 11, 4, 2), ("conv2", 64, 192, 5, 1, 2),
        ("conv3", 192, 384, 3, 1, 1), ("conv4", 384, 256, 3, 1, 1),
        ("conv5", 256, 256, 3, 1, 1))


def param_shapes() -> dict:
    """``{name: shape}`` of LPIPS-alex's weights, named as the port's."""
    out = {}
    for name, cin, cout, k, _, _ in ALEX:
        out[f"backbone.{name}.weight"] = (cout, cin, k, k)
        out[f"backbone.{name}.bias"] = (cout,)
    for i, (_, _, cout, _, _, _) in enumerate(ALEX):
        out[f"lin{i}.weight"] = (1, cout, 1, 1)
    return out


def lpips_features(P, y):
    """Unit-normalized AlexNet taps of NHWC ``y`` (NCHW each)."""
    shift = y.new_tensor(SHIFT)
    scale = y.new_tensor(SCALE)
    x = ((y - shift) / scale).permute(0, 3, 1, 2)
    taps = []
    for i, (name, _, _, _, stride, pad) in enumerate(ALEX):
        x = F.relu(F.conv2d(x, P[f"backbone.{name}.weight"],
                            P[f"backbone.{name}.bias"], stride=stride,
                            padding=pad))
        taps.append(x)
        if i < 2:
            x = F.max_pool2d(x, 3, 2)
    return [t / (torch.sqrt((t ** 2).sum(dim=1, keepdim=True)) + 1e-10)
            for t in taps]


def lpips_map(P, x, fy):
    """Spatial LPIPS ``[n, H, W, 1]`` of NHWC ``x`` against target taps."""
    total = 0.0
    for i, (a, b) in enumerate(zip(lpips_features(P, x), fy)):
        m = F.conv2d((a - b) ** 2, P[f"lin{i}.weight"])
        total = total + F.interpolate(m, size=tuple(x.shape[1:3]),
                                      mode="bilinear", align_corners=False)
    return total.permute(0, 2, 3, 1)


def _pool(loss_map, w):
    if w.shape[-1] != loss_map.shape[-1]:
        w = w.mean(dim=-1, keepdim=True)
    w = w.expand(loss_map.shape[0], *w.shape[1:])
    return (loss_map * w).sum(dim=(1, 2, 3)) / w.sum(dim=(1, 2, 3))


class ProjectionLoss:
    """Per-sample ``weighted L1 + beta * weighted LPIPS`` against one
    target ``[1, H, W, 3]`` with weight (and optional loss mask) of the
    same shape; the target's taps are computed once."""

    def __init__(self, P, target, weight, loss_mask=None, beta=10.0):
        self.P = P
        self.beta = float(beta)
        self.target = target
        self.w = weight if loss_mask is None else loss_mask * weight
        with torch.no_grad():
            self.fy = lpips_features(P, target)

    def __call__(self, out):
        rec = _pool((self.target - out).abs(), self.w)
        per = _pool(lpips_map(self.P, out, self.fy), self.w)
        return rec + self.beta * per
