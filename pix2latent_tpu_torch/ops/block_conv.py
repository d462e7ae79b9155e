"""The port's float32 3x3 and 1x1 convolutions: a hand-written
float32-accurate implicit-GEMM kernel for the card, and its plain version.

Two models call it, each through its own function:

* :func:`block_conv2d`, the convolution every ``GenBlock`` of
  ``models/biggan.py`` calls: its 1x1 convolutions (pad 0) and its 3x3 ones
  (pad 1), stride 1, with a bias;
* :func:`modulated_conv2d`, the shared convolution of StyleGAN2's
  ``ModulatedConv`` (``models/stylegan2.py``): its 3x3 convolutions (pad 1)
  and its up-convolutions, the stride-2 transposed 3x3 convolution of the
  unflipped weight (an h x w plane to 2h+1 x 2w+1), from [22, 512, 4, 4]
  to [22, 32, 1024, 1024] at StyleGAN2 config-f's shapes (K = 288 to 4608).

Both route by what the call can observe:

* a float32 CUDA input runs the kernel (``csrc/block_conv.cu``), forward
  and input gradient, with its products in 3xTF32 on the tensor cores and
  f32 sums; a convolution there that the kernel cannot take (another size
  or padding, a weight or bias of another type or card) raises, and never
  reaches cuDNN;
* CPU tensors and other types (bfloat16) run ``F.conv2d`` or
  ``F.conv_transpose2d`` as they were, and so do StyleGAN2's 2-group
  convolutions on packed pairs and its 1x1 ToRGB (3 outputs: 3 of the
  kernel's 64 tile rows).

The kernel replaces no TPU kernel (the JAX package leaves these
convolutions to XLA); it replaces cuDNN's strict-float32 convolutions: FFT
algorithms at BigGAN's 3x3s, implicit GEMMs at 30-34 TFLOP/s and its
backward-data engine at StyleGAN2's. Its source note gives its bound and
design.

The kernel has three routes, which the caller names (``SAME``, ``UP``,
``UP_GRAD``): a convolution of stride 1 ("same" padding); the up-convolution
as four stride-1 GEMMs, one per output phase (2x2, 2x1, 1x2 and 1x1 taps of
the weight), whose outputs interleave into y; and its input gradient, a
3x3 gather of stride 2 without padding. The input gradient of a stride-1
convolution is a convolution of the output's gradient: for a 3x3 one with
the weight flipped and its in and out axes swapped, for a 1x1 one with the
weight transposed. So each route's weight is packed for it: ``[2, cout,
taps, cin_pad]``, the tf32 hi and lo parts of each value, taps outermost
(the up route's in phase order, ``UP_TAPS``), channels padded to the
kernel's K tile. The weights are frozen, so the packs are built once per
weight and kept beside it (rebuilt when the weight changes in place): a
BigGAN weight's by :func:`packed_weights`, a StyleGAN2 weight's, with its
run-time scale folded in before the split, by :func:`scaled_packs`. No
weight or bias gradient is computed: a weight or bias that asks for one
raises.

The kernel picks its split of K and its tile from the route and the GEMM's
shape itself (``plan_splits`` and ``tile_of`` in the source);
:func:`kernel_splits` asks it for the split, to size the workspace. :func:`packed_conv_reference` is the kernel's GEMM in
plain PyTorch, on a packed weight and each route, so the CPU tests hold the
packing, the phases and the K order. ``launch_counts()`` counts calls (not
CUDA launches): ``fwd`` and ``bwd`` through the kernel's stride-1 route,
``up_fwd`` and ``up_bwd`` through its up-convolution routes, and ``plain``
calls that went to ``F.conv2d`` or ``F.conv_transpose2d``.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F
from torch.utils.weak import WeakIdKeyDictionary

from pix2latent_tpu_torch.utils.cuda_build import load

SOURCE = "block_conv.cu"
_P, _I = ctypes.c_void_p, ctypes.c_int
# the C entries of SOURCE: {entry: (restype, argtypes)}
SIGNATURES = {"block_conv": (_I, [_P] * 5 + [_I] * 9 + [_P]),
              "block_conv_splits": (_I, [_I] * 7)}
BK = 32    # the packed layout's channel block: the kernel's K tile (kBK)
SAME, UP, UP_GRAD = 0, 1, 2     # the kernel's routes (its enum Route)
# The up route's phases (a, b) in order, each with its taps (ky, kx) in the
# order of its GEMM's K: output pixel (2m + a, 2q + b) takes the taps ky = a
# + 2u, kx = b + 2v at x[m - u, q - v], listed from the largest u and v.
UP_PHASES = ((0, 0), (0, 1), (1, 0), (1, 1))
UP_TAPS = tuple((a + 2 * u, b + 2 * v) for a, b in UP_PHASES
                for u in range(1 - a, -1, -1) for v in range(1 - b, -1, -1))

_COUNTS = {"fwd": 0, "bwd": 0, "up_fwd": 0, "up_bwd": 0, "plain": 0}
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


def pack_up_weight(weight):
    """The kernel's A for the up-convolution by the 3x3 ``weight [cout,
    cin, 3, 3]`` (``F.conv_transpose2d(x, weight.transpose(0, 1),
    stride=2)``): its taps in ``UP_TAPS`` order, packed; the values are
    :func:`pack_weight`'s, reordered."""
    cout, cin = weight.shape[:2]
    order = [3 * ky + kx for ky, kx in UP_TAPS]
    return pack_weight(weight.detach().flatten(2)[:, :, order].reshape(
        cout, cin, 3, 3))


def pack_up_grad_weight(weight):
    """The kernel's A for the up-convolution's input gradient: the weight
    with its in and out axes swapped, not flipped, packed."""
    return pack_weight(weight.detach().transpose(0, 1))


def _pack_key(weight, *extra):
    return (weight.data_ptr(), weight._version, tuple(weight.shape),
            weight.device) + extra


def _kept(weight, key, build):
    found = _PACKS.get(weight)
    if found is None or found[0] != key:
        with torch.no_grad():
            found = (key, build())
        _PACKS[weight] = found
    return found[1]


def packed_weights(weight):
    """``(forward pack, input-gradient pack)`` of ``weight``, built once and
    kept while the weight lives and is not changed in place."""
    return _kept(weight, _pack_key(weight),
                 lambda: (pack_weight(weight), pack_grad_weight(weight)))


def scaled_packs(weight, scale, up=False):
    """``(forward pack, input-gradient pack)`` of ``weight * scale`` for the
    stride-1 route, or with ``up`` for the up-convolution's: built once from
    the product in float32 and kept with the parameter ``weight`` (keyed on
    it, its ``_version``, ``scale`` and ``up``), so a call with the same
    frozen weight packs nothing."""
    def build():
        w = weight.detach().float() * scale
        if up:
            return pack_up_weight(w), pack_up_grad_weight(w)
        return pack_weight(w), pack_grad_weight(w)
    return _kept(weight, _pack_key(weight, float(scale), bool(up)), build)


def _gemm(x, a, ksize, padding=0, stride=1):
    """``a [cout, taps, cin]`` by the unfolded ``x``, K tap-major."""
    n, cin = x.shape[:2]
    cout, taps, _ = a.shape
    cols = F.unfold(x, ksize, padding=padding, stride=stride)
    cols = cols.view(n, cin, taps, -1).transpose(1, 2).reshape(n, taps * cin, -1)
    return torch.matmul(a.reshape(cout, taps * cin), cols)


def packed_conv_reference(x, packed, bias, ksize, route=SAME):
    """Plain PyTorch version of the kernel's GEMMs: ``x [n, cin, h, w]`` by
    the packed ``[2, cout, taps, cin_pad]`` (hi + lo), K ordered tap-major
    as the kernel's, plus ``bias`` (``SAME`` only); in x's type. ``SAME``:
    "same" padding, y ``[n, cout, h, w]``; ``UP``: the four phase GEMMs,
    interleaved into y ``[n, cout, 2h+1, 2w+1]``; ``UP_GRAD``: x ``[n, cin,
    2h+1, 2w+1]`` gathered at stride 2, y ``[n, cout, h, w]``."""
    n, cin, h, w = x.shape
    a = (packed[0] + packed[1]).to(x.dtype)[:, :, :cin]     # [cout, taps, cin]
    cout = a.shape[0]
    if route == SAME:
        y = _gemm(x, a, ksize, padding=ksize // 2).view(n, cout, h, w)
        if bias is not None:
            y = y + bias.to(x.dtype)[None, :, None, None]
        return y
    if bias is not None or ksize != 3:
        raise ValueError("the up-convolution routes take a 3x3 weight and "
                         "no bias")
    if route == UP_GRAD:
        return _gemm(x, a, 3, stride=2).view(n, cout, (h - 1) // 2,
                                             (w - 1) // 2)
    y = x.new_empty((n, cout, 2 * h + 1, 2 * w + 1))
    tap = 0
    for pa, pb in UP_PHASES:
        kh, kw = 2 - pa, 2 - pb
        part = _gemm(x, a[:, tap:tap + kh * kw], (kh, kw),
                     padding=(kh - 1, kw - 1))
        y[:, :, pa::2, pb::2] = part.view(n, cout, h + 1 - pa, w + 1 - pb)
        tap += kh * kw
    return y


@functools.lru_cache(maxsize=None)
def kernel_splits(n, cin_pad, h, w, cout, ksize, route=SAME):
    """The splits of K the kernel runs on ``route`` for ``x [n, cin, h, w]``
    (``UP_GRAD``: the gradient of an h x w plane's up-convolution) by a
    weight packed to ``[2, cout, ksize**2, cin_pad]`` (1: none; 0: a shape
    it refuses), as the source's plan picks them from the shape."""
    return load(SOURCE, SIGNATURES).block_conv_splits(n, cin_pad, h, w, cout,
                                                      ksize, route)


def _launch(x, packed, bias, ksize, route=SAME):
    """The kernel on checked inputs, on x's card and its current stream."""
    n, cin, h, w = x.shape
    _, cout, _, cin_pad = packed.shape
    if route == UP_GRAD:
        h, w = (h - 1) // 2, (w - 1) // 2
    out = (2 * h + 1, 2 * w + 1) if route == UP else (h, w)
    splits = kernel_splits(n, cin_pad, h, w, cout, ksize, route)
    y = torch.empty((n, cout) + out, dtype=x.dtype, device=x.device)
    ws = (torch.empty(splits * y.numel(), dtype=x.dtype, device=x.device)
          if splits > 1 else None)
    dev = x.get_device()
    err = load(SOURCE, SIGNATURES).block_conv(
        x.data_ptr(), packed.data_ptr(),
        bias.data_ptr() if bias is not None else None, y.data_ptr(),
        ws.data_ptr() if ws is not None else None, n, cin, cin_pad, h, w,
        cout, ksize, route, dev, torch._C._cuda_getCurrentRawStream(dev))
    if err != 0:
        raise RuntimeError(f"block_conv kernel launch failed: cudaError {err}")
    return y


def _check_bias(bias, cout, device):
    if bias is not None and (bias.shape != (cout,) or bias.device != device
                             or bias.dtype != torch.float32
                             or not bias.is_contiguous()):
        raise ValueError(f"block_conv: bias must be contiguous float32 "
                         f"[{cout}] on {device}")


def kernel_conv(x, packed, bias, ksize, route=SAME):
    """One call of the kernel on ``route``: the convolution of ``x`` by the
    packed weight (and ``bias``), as :func:`packed_conv_reference`."""
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
    if route != SAME and (ksize != 3 or bias is not None):
        raise ValueError("block_conv: the up-convolution routes take a 3x3 "
                         "weight and no bias")
    if route == UP_GRAD and (x.shape[2] % 2 == 0 or x.shape[3] % 2 == 0
                             or min(x.shape[2:]) < 3):
        raise ValueError(f"block_conv: {tuple(x.shape)} is no up-"
                         "convolution's output (2h+1 x 2w+1)")
    _check_bias(bias, cout, x.device)
    return _launch(x, packed, bias, ksize, route)


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


def _refuse_gradients(*params):
    if torch.is_grad_enabled() and any(
            p is not None and p.requires_grad for p in params):
        raise RuntimeError(
            "block_conv computes no weight or bias gradient: freeze "
            "the layer (requires_grad_(False)) or run it in bfloat16 or "
            "on the CPU, where F.conv2d takes it")


class BlockConvFunction(torch.autograd.Function):
    """The kernel's convolution (``up``: the up-convolution) and its input
    gradient, on the weight's ``packs`` (forward, input gradient); the
    weight and the bias take no gradient (the callers refuse one that
    asks)."""

    @staticmethod
    def forward(ctx, x, packs, bias, ksize, up):
        fwd, ctx.bwd = packs
        ctx.ksize, ctx.up = ksize, up
        _COUNTS["up_fwd" if up else "fwd"] += 1
        return _launch(x.contiguous(), fwd, bias, ksize, UP if up else SAME)

    @staticmethod
    def backward(ctx, g):
        _COUNTS["up_bwd" if ctx.up else "bwd"] += 1
        dx = _launch(g.contiguous(), ctx.bwd, None, ctx.ksize,
                     UP_GRAD if ctx.up else SAME)
        return dx, None, None, None, None


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
    _refuse_gradients(weight, bias)
    return BlockConvFunction.apply(x, packed_weights(weight), bias,
                                   weight.shape[-1], False)


def modulated_conv2d(x, weight, scale, w, up=False, groups=1):
    """StyleGAN2's shared convolution of the modulated ``x`` by ``w``, which
    is ``weight * scale`` in x's type (the caller demodulates by it too):
    ``F.conv2d(x, w, padding=k // 2)``, or with ``up`` the up-convolution
    ``F.conv_transpose2d(x, w.transpose(0, 1), stride=2)``; with ``groups``
    2, on packed pairs, each group by ``w``.

    A float32 CUDA ``x`` with ``groups`` 1 and a 3x3 ``w`` runs the kernel,
    forward and input gradient, on the packs of ``weight * scale`` kept with
    the parameter (:func:`scaled_packs`), and raises where the kernel cannot
    take the call (:func:`check_kernel_args`) or ``weight`` asks for a
    gradient. Every other call (CPU, bfloat16, 2 groups, the 1x1 ToRGB)
    runs ``F.conv2d`` or ``F.conv_transpose2d`` as given, counted as
    ``plain``."""
    k = w.shape[-1]
    if (x.device.type == "cuda" and x.dtype == torch.float32 and groups == 1
            and k == 3):
        check_kernel_args(x, w, None, 1)
        _refuse_gradients(weight)
        return BlockConvFunction.apply(x, scaled_packs(weight, scale, up),
                                       None, 3, up)
    _COUNTS["plain"] += 1
    if up:
        return F.conv_transpose2d(x, w.transpose(0, 1).repeat(groups, 1, 1, 1),
                                  stride=2, groups=groups)
    return F.conv2d(x, w.repeat(groups, 1, 1, 1), padding=k // 2,
                    groups=groups)


def reset_launch_counts():
    for k in _COUNTS:
        _COUNTS[k] = 0


def launch_counts() -> dict:
    """Calls since the last reset: ``fwd`` and ``bwd`` through the kernel's
    stride-1 route, ``up_fwd`` and ``up_bwd`` through its up-convolution
    routes, ``plain`` to ``F.conv2d`` or ``F.conv_transpose2d``."""
    return dict(_COUNTS)
