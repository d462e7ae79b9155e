"""upfirdn2d: upsample, FIR filter, downsample (counterpart of
``pix2latent_tpu/ops/upfirdn2d.py``).

Layout NCHW. ``upfirdn2d`` keeps the native kernel's output size convention
``out = (in*up + pad0 + pad1 - k) // down + 1``: upsampling inserts ``up-1``
zeros after every sample, the last one included (the JAX package's lhs
dilation folds those trailing zeros into the trailing pad). The FIR is a
correlation with the kernel, as in the JAX package; the binomial kernels
used are symmetric. It runs as one depthwise ``F.conv2d``, the way the JAX
package leaves it to XLA outside any Pallas kernel. Only :class:`Blur` with
``use_kernel=True`` goes to the hand-written kernel (``ops/fir_blur.py``).
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from pix2latent_tpu_torch.ops.fir_blur import fir_blur


def make_kernel(k, gain=1.0):
    """1-D tap list or 2-D array -> normalized 2-D FIR kernel, float32."""
    k = torch.as_tensor(np.asarray(k, np.float32))
    if k.dim() == 1:
        k = torch.outer(k, k)
    k = k / k.sum()
    return k * gain


def upfirdn2d(x, kernel, up=1, down=1, pad=(0, 0)):
    """Args:
        x: [N, C, H, W].
        kernel: [kh, kw] FIR taps.
        up / down: integer resampling factors.
        pad: (pad0, pad1) applied to both spatial dims.

    Returns [N, C, H', W'] with the native kernel's size convention.
    """
    n, c, h, w = x.shape
    kh, kw = kernel.shape
    p0, p1 = int(pad[0]), int(pad[1])
    if up > 1:
        x = F.pad(x.reshape(n, c, h, 1, w, 1), (0, up - 1, 0, 0, 0, up - 1))
        x = x.reshape(n, c, h * up, w * up)
    x = F.pad(x, (p0, p1, p0, p1))
    weight = kernel.to(device=x.device, dtype=x.dtype)[None, None]
    return F.conv2d(x, weight.repeat(c, 1, 1, 1), stride=down, groups=c)


class Blur(nn.Module):
    """FIR blur with optional upsample gain (rosinality ``Blur``).

    ``use_kernel=True`` sends a blur with 1-D taps through the separable
    FIR kernel (``ops/fir_blur.py``, K2): on every CUDA tensor it launches
    the hand-written kernel, on CPU tensors it runs its plain version. The
    JAX package's ``use_pallas`` also required a TPU and planes of at least
    128x128; here there is no such gate, so the launch count of a run is
    exact. The 2-D kernel is a buffer, so it moves with the model (a host
    kernel copied to the card at each call would wait for the device), and
    stays out of the state_dict."""

    def __init__(self, kernel=(1, 3, 3, 1), pad=(0, 0), upsample_factor=1,
                 use_kernel=False):
        super().__init__()
        k = make_kernel(kernel)
        if upsample_factor > 1:
            k = k * (upsample_factor ** 2)
        self.register_buffer("kernel", k, persistent=False)
        self.pad = (int(pad[0]), int(pad[1]))
        self._taps = None
        k_np = np.asarray(kernel, np.float64)
        if use_kernel and k_np.ndim == 1:
            gain = float(upsample_factor ** 2)
            self._taps = (k_np / k_np.sum()) * np.sqrt(gain)

    def forward(self, x):
        if self._taps is not None:
            return fir_blur(x.contiguous(), self._taps, self.pad)
        return upfirdn2d(x, self.kernel, pad=self.pad)


class Upsample(nn.Module):
    """2x FIR upsample (rosinality ``Upsample``); the kernel is a buffer,
    as :class:`Blur`'s."""

    def __init__(self, kernel=(1, 3, 3, 1), factor=2):
        super().__init__()
        self.factor = factor
        self.register_buffer("kernel", make_kernel(kernel, gain=factor ** 2),
                             persistent=False)
        p = self.kernel.shape[0] - factor
        self.pad = ((p + 1) // 2 + factor - 1, p // 2)

    def forward(self, x):
        return upfirdn2d(x, self.kernel, up=self.factor, pad=self.pad)


class Downsample(nn.Module):
    """FIR downsample (rosinality ``Downsample``); the kernel is a buffer,
    as :class:`Blur`'s."""

    def __init__(self, kernel=(1, 3, 3, 1), factor=2):
        super().__init__()
        self.factor = factor
        self.register_buffer("kernel", make_kernel(kernel), persistent=False)
        p = self.kernel.shape[0] - factor
        self.pad = ((p + 1) // 2, p // 2)

    def forward(self, x):
        return upfirdn2d(x, self.kernel, down=self.factor, pad=self.pad)


def fused_leaky_relu(x, bias=None, negative_slope=0.2, scale=math.sqrt(2.0)):
    """Bias (over dim 1, the channels of NCHW or the features of [n, f]) +
    LeakyReLU + gain: rosinality's ``fused_bias_act`` as plain PyTorch."""
    if bias is not None:
        shape = (1, -1) + (1,) * (x.dim() - 2)
        x = x + bias.to(x.dtype).reshape(shape)
    return F.leaky_relu(x, negative_slope) * scale
