"""Peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at its 700 W
limit) and the least time a piece of work needs on it.

Float32 work is bounded at the TF32 tensor-core rate, 495 TFLOP/s: the
least time in which any float32-accurate route (3xTF32 included, counted
as one product each) could do the products, so no route can read above its
bound. Bytes: each input read once and each output written once, at 3.35
TB/s.

The kernels' counts are the frozen arithmetic of the port's kernel check
(``chip_smoke.py``: ``bound``, the K1 operations and bytes, K2's bytes and
operations, ``mod_bytes_ops``); the module counts extend them to the
convolutions and pooling around each kernel.
"""

from __future__ import annotations

import math

PEAK_FLOPS = {"float32": 495e12, "bfloat16": 989e12}
PEAK_BYTES = 3.35e12


def least_ms(bytes_moved: float, ops: float, dtype="float32") -> float:
    """The larger of bytes over the memory rate and operations over the
    peak rate, in ms."""
    return 1e3 * max(bytes_moved / PEAK_BYTES, ops / PEAK_FLOPS[dtype])


def _size(dtype):
    return 2 if dtype == "bfloat16" else 4


def k1_attention(n, q, k, d, dv, dtype="float32"):
    """K1, ``softmax(theta phi^T) g``: ``(fwd bytes, fwd ops, bwd bytes,
    bwd ops)``; the f32 row statistics are an output of the forward and an
    input of the backward."""
    size, stats = _size(dtype), 2 * 4 * n * q
    fwd_bytes = size * (n * q * d + n * k * d + n * k * dv + n * q * dv) \
        + stats
    bwd_bytes = size * 2 * (n * q * d + n * k * d + n * k * dv) \
        + size * n * q * dv + stats
    return (fwd_bytes, 2 * n * q * k * (d + dv), bwd_bytes,
            2 * n * q * k * (3 * d + 2 * dv))


def k2_fir(shape, k, pad, dtype="float32"):
    """K2, the separable FIR of an NCHW plane: ``(bytes, fwd ops, bwd
    ops)``; 2 operations a tap in the column pass over the padded width and
    in the row pass."""
    n, c, h, w = shape
    ho, wo = h + sum(pad) - k + 1, w + sum(pad) - k + 1
    adj = (k - 1 - pad[1], k - 1 - pad[0])
    return (_size(dtype) * n * c * (h * w + ho * wo),
            2 * k * n * c * ho * (w + sum(pad) + wo),
            2 * k * n * c * h * (wo + sum(adj) + w))


def k3_mod_backward(shape, dtype="float32"):
    """K3: ``(bytes, ops)``: g and x read, g_x written, s read, g_s
    written; g * s, g * x and the add."""
    n, c, h, w = shape
    size = _size(dtype)
    return 3 * n * c * h * w * size + n * c * (size + 4), 3 * n * c * h * w


def conv_ops(n, cin, cout, k, h, w):
    """Multiply-adds of a k x k convolution over an ``h x w`` input grid
    (a stride-2 transposed one scatters each input pixel the same way)."""
    return 2 * n * cin * cout * k * k * h * w


def selfattn_ms(x_shape, backward: bool) -> float:
    """The least time of BigGAN's SA-GAN block on ``x [n, c, h, w]``:
    theta, phi, g and o 1x1 convolutions, 2x2 max pooling and K1, forward
    and (with ``backward``) the gradient to its input (the weights are
    frozen). Bytes: the block's input and output, and in the backward the
    output's gradient, the input again and the input's gradient."""
    n, c, h, w = x_shape
    q, kk, d, dv = h * w, h * w // 4, c // 8, c // 2
    conv = conv_ops(n, c, d + d + dv, 1, h, w) + conv_ops(n, dv, c, 1, h, w)
    _, a_fwd, _, a_bwd = k1_attention(n, q, kk, d, dv)
    act = 4 * n * c * h * w
    ms = least_ms(2 * act, conv + a_fwd)
    if backward:
        ms += least_ms(3 * act, conv + a_bwd)
    return ms


def blur_ms(in_shape, out_shape, taps: int, backward: bool) -> float:
    """The least time of StyleGAN2's FIR blur (K2's module), forward and
    the gradient to its input."""
    n, c, h, w = in_shape
    pad_sum = out_shape[2] - h + taps - 1
    pad = (pad_sum // 2, pad_sum - pad_sum // 2)
    bytes_, fwd, bwd = k2_fir(in_shape, taps, pad)
    return least_ms(bytes_, fwd) + (least_ms(bytes_, bwd) if backward else 0)


def modconv_ms(in_shape, out_shape, weight_shape, taps: int,
               backward: bool) -> float:
    """The least time of StyleGAN2's modulated conv on ``x [n, cin, H,
    W]``: the convolution (a stride-2 transposed one with the FIR blur when
    the output is twice the input), and in the backward the gradient to
    its input (the same products) with K3's reduction to the style. Bytes:
    the input and output, and in the backward the output's gradient, the
    input again and the input's gradient."""
    n, cin, h, w = in_shape
    cout, _, k, _ = weight_shape
    ops = conv_ops(n, cin, cout, k, h, w)
    if out_shape[2] == 2 * h:
        ops += k2_fir((n, cout, 2 * h + 1, 2 * w + 1), taps, (1, 1))[1]
    act_in, act_out = 4 * math.prod(in_shape), 4 * math.prod(out_shape)
    ms = least_ms(act_in + act_out, ops)
    if backward:
        ms += least_ms(act_out + 2 * act_in,
                       ops + k3_mod_backward(in_shape)[1])
    return ms
