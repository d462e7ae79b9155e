"""Fused backward of StyleGAN2's style modulation (K3): the hand-written
Hopper kernel and its plain version.

The modulated conv computes ``conv(x * s)`` with a per-(sample, in-channel)
style scale ``s`` (``models/stylegan2.py:ModulatedConv``). Given the conv's
input gradient ``g``, its backward needs

    g_x[n,c,h,w] = g[n,c,h,w] * s[n,c]                 (in g's type)
    g_s[n,c]     = sum_{h,w} g[n,c,h,w] * x[n,c,h,w]   (in f32)

and :func:`fused_mod_backward` emits both in one pass. Tensors are NCHW.
The JAX package sums ``g_s`` in f32; here the products are summed in f64
and rounded once to f32, by the kernel and by the plain version alike: an
f32 sum over a 512x512 plane depends on its order by up to ~1e-3, which
would put the kernel outside the reference tolerances (rtol 5e-5, atol
1e-5) on channels whose sum nearly cancels (see ``csrc/mod_backward.cu``).

Counterpart of ``pix2latent_tpu/ops/mod_backward.py``. The kernel
(``csrc/mod_backward.cu``) replaces the Pallas TPU kernel there; its source
note gives its bound and design. On CUDA tensors :func:`fused_mod_backward`
launches the kernel, and raises on a shape, type or layout it does not take;
on CPU tensors it runs :func:`mod_backward_reference`.

The kernel cuts each plane into contiguous ranges, one block each, with the
blocks of a plane in one thread-block cluster; :func:`mod_backward_plan`
chooses the cut here, where the CPU tests reach it, and the wrapper passes
it to the kernel. :func:`plan_ranges` gives the ranges the kernel takes.
"""

from __future__ import annotations

import ctypes

import torch

from pix2latent_tpu_torch.utils.cuda_build import load, ptr, stream

SOURCE = "mod_backward.cu"
_P, _I = ctypes.c_void_p, ctypes.c_int
# the C entries of SOURCE: {entry: (restype, argtypes)}
SIGNATURES = {"mod_backward": (_I, [_P] * 5 + [_I] * 6 + [_P])}
SMS = 132              # an H100 SXM's streaming multiprocessors
MAX_SPLITS = 8         # blocks of a plane: one portable cluster
MIN_BLOCK_ELEMENTS = 16 * 1024
MAX_THREADS = 256
UNROLL = 4             # 16-byte vectors a thread loads ahead (the kernel's)


def _per_channel(s):
    return s[:, :, None, None]


def mod_backward_reference(g, x, s):
    """Plain PyTorch version: ``(g * s in g's type, sum_hw g * x)``, the sum
    of exact f64 products in f64, rounded once to f32."""
    gx = g * _per_channel(s).to(g.dtype)
    gs = (g.double() * x.double()).sum(dim=(2, 3)).float()
    return gx, gs


def mod_backward_plan(planes, hw, sms=SMS, itemsize=2, aligned=True):
    """``(splits, threads, vec)`` of the kernel for ``planes`` (n * c) planes
    of ``hw`` elements of ``itemsize`` bytes.

    ``vec`` elements a load: 16 bytes' worth where every plane is a whole
    number of 16-byte vectors and the pointers are ``aligned``, else 1.
    ``splits`` blocks a plane (one cluster): 1 where the planes already fill
    the card, else the smallest power of two up to 8 that gives at least
    4 blocks an SM, so long as each block keeps at least 16 K elements.
    ``threads`` a block: enough for ``UNROLL`` vectors each in one sweep of
    the block's range, 32 to 256."""
    per = 16 // itemsize
    vec = per if aligned and hw % per == 0 else 1
    splits = 1
    while (planes * splits < 4 * sms and splits < MAX_SPLITS
           and hw // (2 * splits) >= MIN_BLOCK_ELEMENTS):
        splits *= 2
    per_block = -(-(hw // vec) // splits)
    threads = 32
    while threads < MAX_THREADS and threads * UNROLL < per_block:
        threads *= 2
    return splits, threads, vec


def plan_ranges(hw, splits, vec):
    """The element ranges ``[start, end)`` of a plane that the kernel's
    ``splits`` blocks take, in rank order (``csrc/mod_backward.cu``):
    ``ceil(packs / splits)`` vectors each, the last one short."""
    packs = hw // vec
    chunk = -(-packs // splits)
    return [(vec * min(packs, r * chunk), vec * min(packs, (r + 1) * chunk))
            for r in range(splits)]


def _check(g, x, s):
    """Raise on anything the kernel does not take."""
    ts = (g, x, s)
    if any(t.device.type != "cuda" for t in ts):
        raise ValueError("fused_mod_backward: all inputs must be on one CUDA "
                         "device, or all on the CPU")
    if len({t.device for t in ts}) != 1:
        raise ValueError("fused_mod_backward: inputs on different devices")
    if g.dtype not in (torch.float32, torch.bfloat16) or \
            any(t.dtype != g.dtype for t in ts):
        raise TypeError("fused_mod_backward: the kernel takes float32 or "
                        "bfloat16 inputs of one type, got "
                        f"{[t.dtype for t in ts]}")
    if g.dim() != 4 or x.shape != g.shape or s.dim() != 2 \
            or tuple(s.shape) != tuple(g.shape[:2]):
        raise ValueError("fused_mod_backward: expected g, x [n, c, h, w] and "
                         f"s [n, c], got {tuple(g.shape)}, {tuple(x.shape)}, "
                         f"{tuple(s.shape)}")
    n, c, h, w = g.shape
    if min(n, c, h, w) < 1 or n * c >= 2 ** 31 or h * w >= 2 ** 31:
        raise ValueError(f"fused_mod_backward: empty or oversized input "
                         f"{tuple(g.shape)}")
    if any(not t.is_contiguous() for t in ts):
        raise ValueError("fused_mod_backward: inputs must be contiguous NCHW")


def kernel_mod_backward(g, x, s):
    """One launch of the kernel: ``(g_x, g_s)``, g_s in float32."""
    _check(g, x, s)
    n, c, h, w = g.shape
    gx = torch.empty_like(g)
    gs = torch.empty((n, c), dtype=torch.float32, device=g.device)
    aligned = all(t.data_ptr() % 16 == 0 for t in (g, x, gx))
    splits, threads, vec = mod_backward_plan(n * c, h * w,
                                             itemsize=g.element_size(),
                                             aligned=aligned)
    with torch.cuda.device(g.device):
        err = load(SOURCE, SIGNATURES).mod_backward(
            *map(ptr, (g, x, s, gx, gs)), n * c, h * w,
            int(g.dtype == torch.bfloat16), splits, threads, vec, stream(g))
    if err != 0:
        raise RuntimeError(f"mod_backward kernel launch failed: cudaError {err}")
    ModulateFunction.launches += 1
    return gx, gs


def fused_mod_backward(g, x, s):
    """``(g_x, g_s)`` in one pass: the kernel on CUDA tensors, the plain
    version on CPU tensors. ``g_x`` keeps g's type; ``g_s`` is float32."""
    if all(t.device.type == "cpu" for t in (g, x, s)):
        return mod_backward_reference(g, x, s)
    return kernel_mod_backward(g, x, s)


class ModulateFunction(torch.autograd.Function):
    """``x * s`` whose backward is :func:`fused_mod_backward`, with ``g_s``
    cast to s's type. ``launches`` counts the kernel's launches."""

    launches = 0

    @staticmethod
    def forward(ctx, x, s):
        ctx.save_for_backward(x, s)
        return x * _per_channel(s)

    @staticmethod
    def backward(ctx, g):
        x, s = ctx.saved_tensors
        gx, gs = fused_mod_backward(g.contiguous(), x.contiguous(),
                                    s.contiguous())
        return gx, gs.to(s.dtype)


def reset_launch_counts():
    ModulateFunction.launches = 0


def launch_counts() -> dict:
    return {"bwd": ModulateFunction.launches}


def modulate(x, s, fused: bool = False):
    """``x * s[:, :, None, None]`` for NCHW ``x`` and ``s [n, c]``;
    ``fused=True`` routes the backward through :func:`fused_mod_backward`,
    ``fused=False`` leaves it to autograd (an elementwise scale and a
    separate reduction)."""
    if not fused:
        return x * _per_channel(s)
    return ModulateFunction.apply(x, s)
