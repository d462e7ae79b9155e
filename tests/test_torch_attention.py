"""The port's SA-GAN attention (plain version, the CPU path of the wrapper)
against the JAX package: the Pallas kernel in interpret mode and the plain
einsum reference, forward and gradients, at the tolerances of
tests/test_attention.py. The CUDA kernel itself is held against the same
plain version on the card (tests/test_torch_cuda.py, chip_smoke.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pix2latent_tpu.ops.attention import (sagan_attention,
                                          sagan_attention_reference)
from pix2latent_tpu_torch.ops import attention as TA

N, Q, K, D, DV = 2, 256, 64, 8, 16
# (n, q, k, d, dv): the smallest shape, and the head widths of
# BigGAN-deep-128 (d=32, dv=128) and -256 (d=64, dv=256)
SHAPES = [(N, Q, K, D, DV), (2, 256, 64, 32, 128), (1, 256, 64, 64, 256)]
# (atol = rtol) for the output and for the gradients
TOL = {"float32": (1e-5, 2e-4), "bfloat16": (2e-2, 5e-2)}
JAX_FNS = {"pallas_interpret": lambda t, p, g: sagan_attention(t, p, g, True),
           "reference": sagan_attention_reference}


def _inputs(seed=0, shape=SHAPES[0]):
    n, q, k, d, dv = shape
    rng = np.random.RandomState(seed)
    return [rng.randn(*s).astype(np.float32) for s in
            ((n, q, d), (n, k, d), (n, k, dv), (n, q, dv))]


def _jax(fn, arrays, dtype):
    theta, phi, g, cot = (jnp.asarray(a).astype(dtype) for a in arrays)

    def loss(t, p, v):
        return jnp.sum((fn(t, p, v) * cot).astype(jnp.float32))

    out = fn(theta, phi, g)
    grads = jax.grad(loss, argnums=(0, 1, 2))(theta, phi, g)
    return [np.asarray(a.astype(jnp.float32)) for a in (out, *grads)]


def _torch(fn, arrays, dtype):
    theta, phi, g, cot = (torch.tensor(a).to(dtype) for a in arrays)
    ins = [t.requires_grad_(True) for t in (theta, phi, g)]
    out = fn(*ins)
    (out.float() * cot.float()).sum().backward()
    return [t.detach().float().numpy() for t in (out, *(i.grad for i in ins))]


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("jax_fn", sorted(JAX_FNS))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_version_matches_jax(jax_fn, dtype, shape):
    arrays = _inputs(shape=shape)
    want = _jax(JAX_FNS[jax_fn], arrays, getattr(jnp, dtype))
    got = _torch(TA.sagan_attention_reference, arrays, getattr(torch, dtype))
    tol_o, tol_g = TOL[dtype]
    np.testing.assert_allclose(got[0], want[0], rtol=tol_o, atol=tol_o,
                               err_msg="output")
    for a, b, name in zip(got[1:], want[1:], ("dtheta", "dphi", "dg")):
        np.testing.assert_allclose(a, b, rtol=tol_g, atol=tol_g, err_msg=name)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_wrapper_runs_the_plain_version_on_cpu(dtype):
    arrays = _inputs(1)
    TA.reset_launch_counts()
    got = _torch(TA.sagan_attention, arrays, dtype)
    want = _torch(TA.sagan_attention_reference, arrays, dtype)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    assert TA.launch_counts() == {"fwd": 0, "bwd": 0}
    assert TA.sagan_attention(*(torch.tensor(a).to(dtype)
                                for a in arrays[:3])).dtype == dtype


def test_plain_version_rounds_probabilities_to_g_dtype():
    # one key dominating everywhere: p rounds to 1.0 in bf16, so the output
    # is exactly that key's value row
    theta = torch.ones(1, 4, 2, dtype=torch.bfloat16)
    phi = torch.tensor([[[8.0, 8.0], [0.0, 0.0]]], dtype=torch.bfloat16)
    g = torch.tensor([[[1.5, -2.0], [7.0, 3.0]]], dtype=torch.bfloat16)
    out = TA.sagan_attention_reference(theta, phi, g)
    assert out.dtype == torch.bfloat16
    np.testing.assert_array_equal(out.float().numpy(),
                                  np.tile([[1.5, -2.0]], (1, 4, 1)))


# --------------------------------------------------------------------- #
# The float32 kernel's arithmetic: 3xTF32                                #
# --------------------------------------------------------------------- #
# The kernel runs float32 on the tensor cores: each f32 operand is split
# into tf32 hi (rounded to nearest, ties away) + lo (x - hi, which the
# tensor core reads rounded toward zero), and each product is
# lo.hi + hi.lo + hi.hi, summed in f32 by mma.sync in k-steps of 8. This
# emulation (products in f64, f32 sums per k-step of 8) runs the route's
# products at a small BigGAN-deep-256-like shape: with the three terms it
# stays within the float32 tolerances of the plain version; with one TF32
# product (hi.hi) every product misses them, which is why the kernel splits.

def _tf32(x, nearest=True):
    bits = x.contiguous().view(torch.int32)
    if nearest:
        bits = bits + 0x1000
    return (bits & ~0x1FFF).view(torch.float32)


def _mm_tf32(a, b, terms):
    """``a @ b`` for [n, M, K] and [n, K, N] as the kernel's tf32 products
    (``terms`` 3 or 1) form it."""
    ah = _tf32(a)
    bh = _tf32(b)
    al, bl = _tf32(a - ah, nearest=False), _tf32(b - bh, nearest=False)
    pairs = [(al, bh), (ah, bl), (ah, bh)] if terms == 3 else [(ah, bh)]
    acc = torch.zeros(a.shape[0], a.shape[1], b.shape[2])
    for k0 in range(0, a.shape[2], 8):
        for x, y in pairs:
            part = torch.einsum("nmk,nkj->nmj", x[:, :, k0:k0 + 8].double(),
                                y[:, k0:k0 + 8].double())
            acc = (acc.double() + part).float()
    return acc


def _route(theta, phi, g, do, terms):
    """Output and gradients of the float32 route with ``terms`` products."""
    t = lambda x: x.transpose(1, 2).contiguous()
    p = torch.softmax(_mm_tf32(theta, t(phi), terms), dim=-1)
    o = _mm_tf32(p, g, terms)
    dp = _mm_tf32(do, t(g), terms)
    ds = p * (dp - (do * o).sum(-1, keepdim=True))
    return o, _mm_tf32(ds, phi, terms), _mm_tf32(t(ds), theta, terms), \
        _mm_tf32(t(p), do, terms)


def _tolerance_ratios(terms):
    # 0.5 * N(0, 1) inputs, as the card tests and chip_smoke.py draw them
    theta, phi, g, do = (0.5 * torch.tensor(a) for a in
                         _inputs(4, (1, 128, 64, 64, 256)))
    ins = [t.clone().requires_grad_(True) for t in (theta, phi, g)]
    out = TA.sagan_attention_reference(*ins)
    want = [out.detach()] + list(torch.autograd.grad(out, ins, do))
    got = _route(theta, phi, g, do, terms)
    tols = TOL["float32"]
    return [float(((a - b).abs() / (tol + tol * b.abs())).max())
            for a, b, tol in zip(got, want, (tols[0],) + (tols[1],) * 3)]


def test_three_tf32_products_keep_float32_tolerances():
    # output, dtheta, dphi, dg
    assert max(_tolerance_ratios(3)) < 0.25


def test_one_tf32_product_misses_float32_tolerances():
    assert min(_tolerance_ratios(1)) > 2.0


def test_tf32_rounding_is_to_nearest_ties_away():
    one = 1.0 + 2.0 ** -10                       # the tf32 neighbour of 1
    x = torch.tensor([1.0 + 2.0 ** -11, -(1.0 + 2.0 ** -11),
                      1.0 + 2.0 ** -11 - 2.0 ** -23, 3.0])
    np.testing.assert_array_equal(_tf32(x).numpy(),
                                  np.float32([one, -one, 1.0, 3.0]))
