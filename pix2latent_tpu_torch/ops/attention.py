"""SA-GAN attention: the hand-written Hopper kernel and its plain version.

``o[n,q,dv] = softmax(theta[n,q,d] @ phi[n,k,d]^T) @ g[n,k,dv]`` with no
1/sqrt(d) scale, as BigGAN's non-local block computes it. QK^T and the
softmax run in f32 over the whole key axis; the probabilities are rounded to
g's type for the PV product, which accumulates in f32.

Counterpart of ``pix2latent_tpu/ops/attention.py``. The kernel
(``csrc/sagan_attention.cu``, forward and backward) replaces the Pallas TPU
kernel there; its source note gives its bound and design. On a CUDA tensor
:func:`sagan_attention` always launches the kernel, and raises on a shape or
type the kernel does not take; on a CPU tensor it runs
:func:`sagan_attention_reference`.

The kernel's route is chosen by the input type alone, and both run on the
tensor cores: bfloat16 in bf16 (``mma.sync``, bf16 tiles, f32 sums, dS as
bf16 hi + lo), float32 in 3xTF32 (each f32 operand split into tf32 hi + lo,
each product ``lo.hi + hi.lo + hi.hi`` summed in f32), which keeps float32's
accuracy where one TF32 product would not. Both take every shape
:func:`kernel_forward` accepts; neither stands in for the other.
"""

from __future__ import annotations

import ctypes

import torch

from pix2latent_tpu_torch.utils.cuda_build import load, ptr, stream

SOURCE = "sagan_attention.cu"
_P, _I = ctypes.c_void_p, ctypes.c_int
# the C entries of SOURCE: {entry: (restype, argtypes)}
SIGNATURES = {
    "sagan_attention_fwd": (_I, [_P] * 6 + [_I] * 6 + [_P]),
    "sagan_attention_bwd": (_I, [_P] * 12 + [_I] * 6 + [_P]),
    "sagan_attention_work": (_I, [_I] * 6 + [_P]),
}
MAX_D = 128
MAX_DV = 512


def sagan_attention_reference(theta, phi, g):
    """Plain PyTorch version: einsum, f32 softmax, cast, einsum.

    Every product runs in f32 and the result is rounded once to g's type,
    which is what the JAX reference's ``preferred_element_type=f32`` and the
    kernel both do. Autograd gives its gradient."""
    s = torch.einsum("nqc,nkc->nqk", theta.float(), phi.float())
    p = torch.softmax(s, dim=-1).to(g.dtype)
    return torch.einsum("nqk,nkc->nqc", p.float(), g.float()).to(g.dtype)


def _check(theta, phi, g):
    """Raise on anything the kernel does not take."""
    ts = (theta, phi, g)
    if any(t.device.type != "cuda" for t in ts):
        raise ValueError("sagan_attention: all inputs must be on one CUDA "
                         "device, or all on the CPU")
    if len({t.device for t in ts}) != 1:
        raise ValueError("sagan_attention: inputs on different devices")
    if theta.dtype not in (torch.float32, torch.bfloat16) or \
            any(t.dtype != theta.dtype for t in ts):
        raise TypeError("sagan_attention: the kernel takes float32 or "
                        "bfloat16 inputs of one type, got "
                        f"{[t.dtype for t in ts]}")
    if any(t.dim() != 3 for t in ts):
        raise ValueError("sagan_attention: inputs must be [n, q|k, d|dv]")
    n, q, d = theta.shape
    if phi.shape[0] != n or g.shape[0] != n or phi.shape[2] != d \
            or g.shape[1] != phi.shape[1]:
        raise ValueError(f"sagan_attention: mismatched shapes {theta.shape}, "
                         f"{phi.shape}, {g.shape}")
    k, dv = g.shape[1], g.shape[2]
    if min(n, q, k, d, dv) < 1 or d > MAX_D or dv > MAX_DV or n > 65535:
        raise ValueError(f"sagan_attention: the kernel takes d <= {MAX_D}, "
                         f"dv <= {MAX_DV}, n <= 65535; got n={n} q={q} k={k} "
                         f"d={d} dv={dv}")
    if any(not t.is_contiguous() for t in ts):
        raise ValueError("sagan_attention: inputs must be contiguous")


def _raise_on(err: int, what: str):
    if err != 0:
        raise RuntimeError(f"sagan_attention {what} kernel launch failed: "
                           f"cudaError {err}")


def kernel_forward(theta, phi, g):
    """One launch of the forward kernel: ``(o, m, l)`` with the f32 row max
    and row sum of exp(s - m) that the backward reuses."""
    _check(theta, phi, g)
    n, q, d = theta.shape
    k, dv = g.shape[1], g.shape[2]
    o = torch.empty((n, q, dv), dtype=theta.dtype, device=theta.device)
    m = torch.empty((n, q), dtype=torch.float32, device=theta.device)
    l = torch.empty((n, q), dtype=torch.float32, device=theta.device)
    with torch.cuda.device(theta.device):
        err = load(SOURCE, SIGNATURES).sagan_attention_fwd(
            ptr(theta), ptr(phi), ptr(g), ptr(o), ptr(m), ptr(l),
            n, q, k, d, dv, int(theta.dtype == torch.bfloat16), stream(theta))
    _raise_on(err, "forward")
    SaganAttentionFunction.fwd_launches += 1
    return o, m, l


def kernel_backward(theta, phi, g, do, o, m, l):
    """One backward call (two kernels): ``(dtheta, dphi, dg)``, from the
    forward's ``(o, m, l)`` (the float32 route reads ``o``)."""
    _check(theta, phi, g)
    n, q, d = theta.shape
    k, dv = g.shape[1], g.shape[2]
    do = do.to(theta.dtype).contiguous()
    if do.shape != (n, q, dv) or do.device != theta.device:
        raise ValueError(f"sagan_attention: bad output gradient {do.shape}")
    if o.shape != (n, q, dv) or o.dtype != theta.dtype \
            or o.device != theta.device or not o.is_contiguous():
        raise ValueError(f"sagan_attention: bad forward output {o.shape}")
    dtheta = torch.empty_like(theta)
    dphi = torch.empty_like(phi)
    dg = torch.empty_like(g)
    delta = torch.empty((n, q), dtype=torch.float32, device=theta.device)
    # the float32 route passes dS^T [n, k, q] from its dkv kernel to its dq
    # one
    ds = None if theta.dtype == torch.bfloat16 else torch.empty(
        (n, k, q), dtype=torch.float32, device=theta.device)
    with torch.cuda.device(theta.device):
        err = load(SOURCE, SIGNATURES).sagan_attention_bwd(
            ptr(theta), ptr(phi), ptr(g), ptr(do), ptr(o), ptr(m),
            ptr(l), ptr(delta),
            ctypes.c_void_p(None) if ds is None else ptr(ds),
            ptr(dtheta), ptr(dphi), ptr(dg),
            n, q, k, d, dv, int(theta.dtype == torch.bfloat16), stream(theta))
    _raise_on(err, "backward")
    SaganAttentionFunction.bwd_launches += 1
    return dtheta, dphi, dg


def kernel_work(n, q, k, d, dv, dtype):
    """``(forward, backward)`` FLOPs that the kernels for ``dtype`` do at
    this shape, tile padding included, as the kernel source counts them from
    its own tiles; in float32 tensor-core FLOPs, each product three times
    (3xTF32). Launches nothing."""
    work = (ctypes.c_double * 2)()
    err = load(SOURCE, SIGNATURES).sagan_attention_work(
        n, q, k, d, dv, int(dtype == torch.bfloat16), work)
    if err != 0:
        raise ValueError(f"sagan_attention: the kernel does not take n={n} "
                         f"q={q} k={k} d={d} dv={dv}")
    return work[0], work[1]


class SaganAttentionFunction(torch.autograd.Function):
    """The kernel forward and the kernel backward. ``fwd_launches`` and
    ``bwd_launches`` count the launches, so a run can show that it went
    through the kernel."""

    fwd_launches = 0
    bwd_launches = 0

    @staticmethod
    def forward(ctx, theta, phi, g):
        o, m, l = kernel_forward(theta, phi, g)
        ctx.save_for_backward(theta, phi, g, o, m, l)
        return o

    @staticmethod
    def backward(ctx, do):
        theta, phi, g, o, m, l = ctx.saved_tensors
        return kernel_backward(theta, phi, g, do, o, m, l)


def reset_launch_counts():
    SaganAttentionFunction.fwd_launches = 0
    SaganAttentionFunction.bwd_launches = 0


def launch_counts() -> dict:
    return {"fwd": SaganAttentionFunction.fwd_launches,
            "bwd": SaganAttentionFunction.bwd_launches}


def sagan_attention(theta, phi, g):
    """The kernel on CUDA tensors, the plain version on CPU tensors."""
    if all(t.device.type == "cpu" for t in (theta, phi, g)):
        return sagan_attention_reference(theta, phi, g)
    return SaganAttentionFunction.apply(theta, phi, g)
