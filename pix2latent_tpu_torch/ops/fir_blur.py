"""Separable FIR blur (K2): the hand-written Hopper kernel and its plain version.

``y = correlate(pad(x, p0, p1), outer(k1d, k1d))`` on every ``[H, W]`` plane
of an NCHW tensor, with up = down = 1: StyleGAN2's blur after each
upsampling convolution. It equals ``upfirdn2d(x, outer(k1d, k1d), pad=pad)``.
The column taps run first, then the row taps, both in f32, and the result is
rounded once to x's type.

Counterpart of ``pix2latent_tpu/ops/pallas_fir.py``. The kernel
(``csrc/fir_blur.cu``) replaces the Pallas TPU kernel there; its source note
gives its bound and design. :func:`fir_blur` is differentiable: the op is
linear, so its backward is the same blur with the taps reversed and the pad
``(K-1-p0, K-1-p1)``. On CUDA tensors both directions launch the kernel, and
raise on a shape, type or layout it does not take; on CPU tensors both run
:func:`fir_blur_reference`.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch
import torch.nn.functional as F

from pix2latent_tpu_torch.utils.cuda_build import load, ptr, stream

SOURCE = "fir_blur.cu"
_P, _I = ctypes.c_void_p, ctypes.c_int
# the C entries of SOURCE: {entry: (restype, argtypes)}
SIGNATURES = {
    "fir_blur": (_I, [_P, _P, ctypes.POINTER(ctypes.c_float)] + [_I] * 8
                 + [_P]),
    "fir_blur_work": (_I, [_I] * 8 + [ctypes.POINTER(ctypes.c_double)]),
}
MAX_TAPS = 8


def separable_taps(kernel2d):
    """If a 2-D FIR kernel is an outer product k k^T (all the binomial blurs
    are), the 1-D taps whose outer product reproduces it; else None."""
    k2 = np.asarray(kernel2d, np.float32)
    if k2.ndim != 2 or k2.shape[0] != k2.shape[1]:
        return None
    u, s, _ = np.linalg.svd(k2)
    if s[0] <= 0 or (len(s) > 1 and s[1] > 1e-5 * s[0]):
        return None
    k1 = u[:, 0] * np.sqrt(s[0])
    if k1.sum() < 0:
        k1 = -k1
    if not np.allclose(np.outer(k1, k1), k2, atol=1e-6):
        return None
    return k1


def _out_size(n: int, k: int, pad) -> int:
    return n + pad[0] + pad[1] - k + 1


def fir_blur_reference(x, taps, pad):
    """Plain PyTorch version: zero-pad, column taps, row taps, f32
    accumulation, one rounding to x's type. ``taps`` are f32 values."""
    k = len(taps)
    p0, p1 = pad
    a = F.pad(x.float(), (p0, p1, p0, p1))
    ho, wo = a.shape[-2] - k + 1, a.shape[-1] - k + 1
    cols = taps[0] * a[..., 0:ho, :]
    for j in range(1, k):
        cols = cols + taps[j] * a[..., j:j + ho, :]
    out = taps[0] * cols[..., 0:wo]
    for j in range(1, k):
        out = out + taps[j] * cols[..., j:j + wo]
    return out.to(x.dtype)


def adjoint(taps, pad):
    """Taps and pad of the blur's backward: reversed taps, pad K-1-p."""
    k = len(taps)
    return tuple(reversed(taps)), (k - 1 - pad[0], k - 1 - pad[1])


def _check(x, taps, pad):
    """Raise on anything the kernel does not take."""
    if x.device.type != "cuda":
        raise ValueError("fir_blur: the kernel takes a CUDA tensor; CPU "
                         "tensors run fir_blur_reference")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"fir_blur: the kernel takes float32 or bfloat16, "
                        f"got {x.dtype}")
    if x.dim() != 4:
        raise ValueError(f"fir_blur: x must be NCHW, got shape {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError("fir_blur: x must be contiguous NCHW")
    _out_shape(x.shape, len(taps), pad)


def _out_shape(shape, k, pad):
    """``(ho, wo)`` of the blur of an NCHW ``shape`` by ``k`` taps and
    ``pad``; raises on what the kernel does not take."""
    if not 1 <= k <= MAX_TAPS:
        raise ValueError(f"fir_blur: the kernel takes 1 to {MAX_TAPS} taps, "
                         f"got {k}")
    n, c, h, w = shape
    ho, wo = _out_size(h, k, pad), _out_size(w, k, pad)
    if min(n, c, h, w, ho, wo) < 1 or n * c >= 2 ** 31:
        raise ValueError(f"fir_blur: empty or oversized blur: x {tuple(shape)}"
                         f", {k} taps, pad {pad}")
    return ho, wo


def _launch(x, taps, pad):
    _check(x, taps, pad)
    n, c, h, w = x.shape
    k = len(taps)
    ho, wo = _out_size(h, k, pad), _out_size(w, k, pad)
    y = torch.empty((n, c, ho, wo), dtype=x.dtype, device=x.device)
    t = (ctypes.c_float * k)(*taps)
    with torch.cuda.device(x.device):
        err = load(SOURCE, SIGNATURES).fir_blur(
            ptr(x), ptr(y), t, k, n * c, h, w, ho, wo, pad[0],
            int(x.dtype == torch.bfloat16), stream(x))
    if err != 0:
        raise RuntimeError(f"fir_blur kernel launch failed: cudaError {err}")
    return y


def kernel_work(shape, k, pad, dtype):
    """The bytes one launch of the kernel moves for an NCHW input of
    ``shape`` (16-byte aligned) with ``k`` taps and ``pad``, as the kernel
    source plans it: every 16-byte chunk it copies in (the halo rows read
    again by the next tile included) and every element it writes. Launches
    nothing."""
    if dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"fir_blur: the kernel takes float32 or bfloat16, "
                        f"got {dtype}")
    if len(shape) != 4:
        raise ValueError(f"fir_blur: shape must be NCHW, got {tuple(shape)}")
    pad = (int(pad[0]), int(pad[1]))
    ho, wo = _out_shape(shape, k, pad)
    n, c, h, w = shape
    out = ctypes.c_double()
    err = load(SOURCE, SIGNATURES).fir_blur_work(
        k, n * c, h, w, ho, wo, pad[0], int(dtype == torch.bfloat16),
        ctypes.byref(out))
    if err != 0:
        raise RuntimeError(f"fir_blur_work failed: cudaError {err}")
    return out.value


def kernel_forward(x, taps, pad):
    """One launch of the kernel: the blur of ``x``."""
    y = _launch(x, taps, pad)
    FirBlurFunction.fwd_launches += 1
    return y


def kernel_backward(g, taps, pad):
    """One launch of the kernel: the gradient of the blur ``(taps, pad)``
    with respect to its input, given the output gradient ``g``."""
    y = _launch(g, *adjoint(taps, pad))
    FirBlurFunction.bwd_launches += 1
    return y


class FirBlurFunction(torch.autograd.Function):
    """The blur and its adjoint: the kernel on CUDA tensors, the plain
    version on CPU tensors. ``fwd_launches`` and ``bwd_launches`` count the
    kernel's launches, so a run can show that it went through the kernel."""

    fwd_launches = 0
    bwd_launches = 0

    @staticmethod
    def forward(ctx, x, taps, pad):
        ctx.taps, ctx.pad = taps, pad
        if x.device.type == "cpu":
            return fir_blur_reference(x, taps, pad)
        return kernel_forward(x, taps, pad)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous()
        if g.device.type == "cpu":
            return fir_blur_reference(g, *adjoint(ctx.taps, ctx.pad)), None, None
        return kernel_backward(g, ctx.taps, ctx.pad), None, None


def reset_launch_counts():
    FirBlurFunction.fwd_launches = 0
    FirBlurFunction.bwd_launches = 0


def launch_counts() -> dict:
    return {"fwd": FirBlurFunction.fwd_launches,
            "bwd": FirBlurFunction.bwd_launches}


def fir_blur(x, k1d, pad):
    """Separable zero-padded FIR of NCHW ``x``: equals
    ``upfirdn2d(x, outer(k1d, k1d), pad=pad)``. ``k1d`` are host constants
    (rounded to f32, as the JAX kernel's); ``pad`` is ``(p0, p1)`` on both
    spatial axes."""
    taps = tuple(float(v) for v in np.asarray(k1d, np.float32).reshape(-1))
    pad = (int(pad[0]), int(pad[1]))
    return FirBlurFunction.apply(x, taps, pad)
