"""BigGAN-deep's block convolutions: a hand-written float32-accurate
implicit-GEMM kernel for the card, and its plain version.

:func:`block_conv2d` is the convolution every ``GenBlock`` of
``models/biggan.py`` calls: its 1x1 convolutions (pad 0) and its 3x3 ones
(pad 1), stride 1, NCHW. It routes by the input's device and type alone:

* a float32 CUDA input runs the kernel (``csrc/block_conv.cu``), forward
  and input gradient, with its products in 3xTF32 on the tensor cores and
  f32 sums; a convolution there that the kernel cannot take (another size
  or padding, a weight or bias of another type or card) raises;
* CPU tensors and other types (bfloat16) run ``F.conv2d`` as it was.

The kernel replaces no TPU kernel (the JAX package leaves these
convolutions to XLA); it replaces cuDNN's FFT convolutions, which its
heuristics pick for BigGAN's strict-float32 3x3 convolutions. Its source
note gives its bound and design.

The input gradient of a convolution is a convolution of the output's
gradient: for a 3x3 one with the weight flipped and its in and out axes
swapped, for a 1x1 one with the weight transposed. So one kernel does both,
on a weight packed for it: ``[2, cout, taps, cin_pad]``, the tf32 hi and lo
parts of each value, taps outermost, channels padded to the kernel's K
tile. The weights are frozen, so both packs are built once per weight and
kept beside it (rebuilt when the weight changes in place). No weight or
bias gradient is computed: a weight or bias that asks for one raises.

The kernel picks its split of K from the GEMM's shape itself
(``plan_splits`` in the source); :func:`kernel_splits` asks it, to size the
workspace. :func:`packed_conv_reference` is the kernel's GEMM in plain
PyTorch, on a packed weight, so the CPU tests hold the packing and the K
order. ``launch_counts()`` counts calls (not CUDA launches): forwards and
input gradients through the kernel, and calls that went to ``F.conv2d``.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F
from torch.utils.weak import WeakIdKeyDictionary

SOURCE = "block_conv.cu"
BK = 32    # the packed layout's channel block: the kernel's K tile (kBK)

_COUNTS = {"fwd": 0, "bwd": 0, "plain": 0}
_PACKS = WeakIdKeyDictionary()


def tf32_split(a):
    """``(hi, lo)`` with ``hi`` = ``a`` rounded to tf32 (to nearest, ties
    away from zero, as ``cvt.rna.tf32.f32``) and ``lo`` = ``a - hi`` rounded
    the same way; f32 in, f32 out."""
    def rna(v):
        bits = v.contiguous().view(torch.int32)
        return ((bits + 0x1000) & -0x2000).view(torch.float32)
    a = a.float()
    hi = rna(a)
    return hi, rna(a - hi)


def pack_weight(weight):
    """The kernel's A for ``weight [cout, cin, k, k]``: ``[2, cout, k*k,
    cin_pad]`` f32, the tf32 hi and lo parts, taps outermost, channels
    zero-padded to a multiple of ``BK``."""
    cout, cin, k, _ = weight.shape
    a = weight.detach().float().permute(0, 2, 3, 1).reshape(cout, k * k, cin)
    a = F.pad(a, (0, -(-cin // BK) * BK - cin))
    return torch.stack(tf32_split(a)).contiguous()


def pack_grad_weight(weight):
    """The kernel's A for the input gradient of the convolution by
    ``weight``: the weight flipped in space with its in and out axes
    swapped (a 1x1 weight transposed), packed."""
    return pack_weight(weight.detach().flip(2, 3).transpose(0, 1))


def packed_weights(weight):
    """``(forward pack, input-gradient pack)`` of ``weight``, built once and
    kept while the weight lives and is not changed in place."""
    key = (weight.data_ptr(), weight._version, tuple(weight.shape),
           weight.device)
    found = _PACKS.get(weight)
    if found is None or found[0] != key:
        with torch.no_grad():
            found = (key, (pack_weight(weight), pack_grad_weight(weight)))
        _PACKS[weight] = found
    return found[1]


def packed_conv_reference(x, packed, bias, ksize):
    """Plain PyTorch version of the kernel's GEMM: ``x [n, cin, h, w]`` by
    the packed ``[2, cout, taps, cin_pad]`` (hi + lo), K ordered tap-major
    as the kernel's, "same" padding, plus ``bias``; in x's type."""
    n, cin, h, w = x.shape
    _, cout, taps, cin_pad = packed.shape
    a = (packed[0] + packed[1]).to(x.dtype)[:, :, :cin]     # [cout, taps, cin]
    cols = F.unfold(x, ksize, padding=ksize // 2)           # [n, cin*taps, hw]
    cols = cols.view(n, cin, taps, h * w).transpose(1, 2).reshape(
        n, taps * cin, h * w)
    y = torch.matmul(a.reshape(cout, taps * cin), cols).view(n, cout, h, w)
    if bias is not None:
        y = y + bias.to(x.dtype)[None, :, None, None]
    return y


_LIB = None


def _lib():
    global _LIB
    if _LIB is None:
        from pix2latent_tpu_torch.utils.cuda_build import load
        lib = load(SOURCE)
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.block_conv.argtypes = [p] * 5 + [i] * 8 + [p]
        lib.block_conv.restype = i
        lib.block_conv_splits.argtypes = [i] * 6
        lib.block_conv_splits.restype = i
        _LIB = lib
    return _LIB


@functools.lru_cache(maxsize=None)
def kernel_splits(n, cin_pad, h, w, cout, ksize):
    """The splits of K the kernel runs for ``x [n, cin, h, w]`` by a weight
    packed to ``[2, cout, ksize**2, cin_pad]`` (1: none; 0: a shape it
    refuses), as the source's plan picks them from the shape."""
    return _lib().block_conv_splits(n, cin_pad, h, w, cout, ksize)


def _launch(x, packed, bias, ksize):
    """The kernel on checked inputs, on x's card and its current stream."""
    n, cin, h, w = x.shape
    _, cout, _, cin_pad = packed.shape
    splits = kernel_splits(n, cin_pad, h, w, cout, ksize)
    y = torch.empty((n, cout, h, w), dtype=x.dtype, device=x.device)
    ws = (torch.empty(splits * y.numel(), dtype=x.dtype, device=x.device)
          if splits > 1 else None)
    dev = x.get_device()
    err = _lib().block_conv(
        x.data_ptr(), packed.data_ptr(),
        bias.data_ptr() if bias is not None else None, y.data_ptr(),
        ws.data_ptr() if ws is not None else None, n, cin, cin_pad, h, w,
        cout, ksize, dev, torch._C._cuda_getCurrentRawStream(dev))
    if err != 0:
        raise RuntimeError(f"block_conv kernel launch failed: cudaError {err}")
    return y


def _check_bias(bias, cout, device):
    if bias is not None and (bias.shape != (cout,) or bias.device != device
                             or bias.dtype != torch.float32
                             or not bias.is_contiguous()):
        raise ValueError(f"block_conv: bias must be contiguous float32 "
                         f"[{cout}] on {device}")


def kernel_conv(x, packed, bias, ksize):
    """One call of the kernel: the convolution of ``x`` by the packed weight
    (and ``bias``), as :func:`packed_conv_reference`."""
    if x.device.type != "cuda" or x.dtype != torch.float32:
        raise ValueError("block_conv: the kernel takes a float32 CUDA tensor")
    if x.dim() != 4 or not x.is_contiguous():
        raise ValueError("block_conv: x must be contiguous NCHW")
    cin = x.shape[1]
    if (packed.dim() != 4 or packed.shape[0] != 2
            or packed.dtype != torch.float32 or not packed.is_contiguous()
            or packed.device != x.device):
        raise ValueError("block_conv: the weight must be packed by pack_weight")
    _, cout, taps, cin_pad = packed.shape
    if ksize not in (1, 3) or taps != ksize * ksize or not (
            cin_pad - BK < cin <= cin_pad) or cin_pad % BK:
        raise ValueError(f"block_conv: x {tuple(x.shape)} does not fit the "
                         f"packed weight {tuple(packed.shape)} (k {ksize})")
    _check_bias(bias, cout, x.device)
    return _launch(x, packed, bias, ksize)


def check_kernel_args(x, weight, bias, padding):
    """Raises ``ValueError`` unless the kernel takes the convolution of the
    NCHW ``x`` by ``weight`` (and ``bias``) with ``padding``: a float32
    weight ``[cout, cin, k, k]`` on x's device, k 1 or 3 with padding
    ``k // 2``, and a contiguous float32 ``[cout]`` bias there or none."""
    if x.dim() != 4 or weight.dim() != 4:
        raise ValueError("block_conv: x and the weight must be 4-D")
    cout, cin, kh, kw = weight.shape
    if kh != kw or kh not in (1, 3) or padding != kh // 2:
        raise ValueError(f"block_conv: the kernel takes 1x1 convolutions with "
                         f"padding 0 and 3x3 with padding 1, not {kh}x{kw} "
                         f"with padding {padding}")
    if x.shape[1] != cin:
        raise ValueError(f"block_conv: x has {x.shape[1]} channels, the "
                         f"weight takes {cin}")
    if weight.dtype != torch.float32 or weight.device != x.device:
        raise ValueError(f"block_conv: the weight must be float32 on "
                         f"{x.device}")
    _check_bias(bias, cout, x.device)


class BlockConvFunction(torch.autograd.Function):
    """The kernel's convolution and its input gradient; the weight and the
    bias take no gradient (:func:`block_conv2d` refuses one that asks)."""

    @staticmethod
    def forward(ctx, x, weight, bias):
        fwd, ctx.bwd = packed_weights(weight)
        ctx.ksize = weight.shape[-1]
        _COUNTS["fwd"] += 1
        return _launch(x.contiguous(), fwd, bias, ctx.ksize)

    @staticmethod
    def backward(ctx, g):
        _COUNTS["bwd"] += 1
        return _launch(g.contiguous(), ctx.bwd, None, ctx.ksize), None, None


def block_conv2d(x, weight, bias=None, padding=0):
    """``F.conv2d(x, weight, bias, padding=padding)`` (stride 1): through the
    kernel for a float32 CUDA ``x`` (:func:`check_kernel_args` holds the
    rest), else ``F.conv2d`` with the weight and bias cast to x's type. On
    the kernel's path a weight or bias that asks for a gradient raises: the
    kernel computes none."""
    if x.device.type != "cuda" or x.dtype != torch.float32:
        _COUNTS["plain"] += 1
        b = bias.to(x.dtype) if bias is not None else None
        return F.conv2d(x, weight.to(x.dtype), b, padding=padding)
    check_kernel_args(x, weight, bias, padding)
    if torch.is_grad_enabled() and (
            weight.requires_grad or (bias is not None and bias.requires_grad)):
        raise RuntimeError(
            "block_conv2d computes no weight or bias gradient: freeze "
            "the layer (requires_grad_(False)) or run it in bfloat16 or "
            "on the CPU, where F.conv2d takes it")
    return BlockConvFunction.apply(x, weight, bias)


def reset_launch_counts():
    for k in _COUNTS:
        _COUNTS[k] = 0


def launch_counts() -> dict:
    """Calls since the last reset: ``fwd`` and ``bwd`` through the kernel,
    ``plain`` to ``F.conv2d``."""
    return dict(_COUNTS)
