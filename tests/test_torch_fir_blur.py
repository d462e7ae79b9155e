"""The port's separable FIR blur (K2) against the JAX package's Pallas kernel.

On the CPU the port's ``fir_blur`` runs its autograd Function with the plain
version in both directions, so these tests reach the custom backward (the
reversed taps and the adjoint pad). The JAX side runs ``fir_blur_pallas`` in
interpret mode, as ``tests/test_pallas_fir.py`` does, with that file's
tolerances: atol 1e-5 on the output, 1e-4 on the gradient; pads (1, 1), the
StyleGAN2 up-path blur's, and (2, 1).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from pix2latent_tpu.ops.pallas_fir import fir_blur_pallas
from pix2latent_tpu.ops.pallas_fir import separable_taps as jax_taps
from pix2latent_tpu.ops.upfirdn2d import make_kernel
from pix2latent_tpu_torch.ops import fir_blur as FB

# the up-path blur: [1, 3, 3, 1] / 8 with the 2x upsample gain on each axis
TAPS = np.asarray([1, 3, 3, 1], np.float64) / 8.0 * 2.0
PADS = [(1, 1), (2, 1)]


def _inputs(pad, seed=0, shape=(2, 3, 10, 12)):
    rng = np.random.RandomState(seed)
    n, c, h, w = shape
    x = rng.randn(*shape).astype(np.float32)
    cot = rng.randn(n, c, h + sum(pad) - 3, w + sum(pad) - 3).astype(np.float32)
    return x, cot


@pytest.mark.parametrize("pad", PADS)
def test_forward_matches_pallas(pad):
    x, _ = _inputs(pad)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(fir_blur_pallas(jnp.asarray(x.transpose(0, 2, 3, 1)),
                                          TAPS, pad)).transpose(0, 3, 1, 2)
    FB.reset_launch_counts()
    got = FB.fir_blur(torch.tensor(x), TAPS, pad).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-5)
    assert FB.launch_counts() == {"fwd": 0, "bwd": 0}   # CPU: plain version


@pytest.mark.parametrize("pad", PADS)
def test_gradient_matches_pallas(pad):
    x, cot = _inputs(pad, seed=1)

    def f_pallas(xj):
        return jnp.sum(jnp.sin(fir_blur_pallas(xj, TAPS, pad))
                       * jnp.asarray(cot.transpose(0, 2, 3, 1)))

    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jax.grad(f_pallas)(
            jnp.asarray(x.transpose(0, 2, 3, 1)))).transpose(0, 3, 1, 2)
    xt = torch.tensor(x, requires_grad=True)
    (torch.sin(FB.fir_blur(xt, TAPS, pad)) * torch.tensor(cot)).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), want, atol=1e-4)


def test_backward_is_the_adjoint_blur():
    pad = (2, 1)
    x, cot = _inputs(pad, seed=2, shape=(1, 2, 9, 7))
    xt = torch.tensor(x, requires_grad=True)
    FB.fir_blur(xt, TAPS, pad).backward(torch.tensor(cot))
    taps, adj = FB.adjoint(tuple(TAPS), pad)
    assert taps == tuple(TAPS[::-1]) and adj == (1, 2)
    want = FB.fir_blur_reference(torch.tensor(cot), taps, adj)
    torch.testing.assert_close(xt.grad, want, rtol=0, atol=0)
    # <blur(x), cot> == <x, adjoint(cot)>
    lhs = (FB.fir_blur_reference(torch.tensor(x).double(), tuple(TAPS), pad)
           * torch.tensor(cot).double()).sum()
    rhs = (torch.tensor(x).double() * want.double()).sum()
    assert abs(float(lhs - rhs)) < 1e-4


def test_bf16_rounds_once_from_f32():
    x, _ = _inputs((1, 1), seed=3)
    xb = torch.tensor(x).bfloat16()
    got = FB.fir_blur(xb, TAPS, (1, 1))
    want = FB.fir_blur_reference(xb.float(), tuple(float(t) for t in TAPS),
                                 (1, 1)).bfloat16()
    assert got.dtype == torch.bfloat16
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_separable_taps_match_jax():
    k2d = np.asarray(make_kernel([1, 3, 3, 1])) * 4.0
    np.testing.assert_allclose(FB.separable_taps(k2d), jax_taps(k2d),
                               rtol=1e-6)
    np.testing.assert_allclose(np.outer(FB.separable_taps(k2d),
                                        FB.separable_taps(k2d)), k2d,
                               atol=1e-6)
    assert FB.separable_taps(np.eye(4, dtype=np.float32)) is None


def test_tensors_off_the_cpu_never_reach_the_plain_version():
    """A tensor that is not on the CPU goes to the kernel's wrapper, which
    raises here (it takes CUDA tensors only): no fallback."""
    x = torch.empty((1, 2, 8, 8), device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        FB.fir_blur(x, TAPS, (1, 1))
    with pytest.raises(ValueError, match="CUDA"):
        FB.kernel_backward(x, tuple(TAPS), (1, 1))
    assert FB.launch_counts() == {"fwd": 0, "bwd": 0}


@pytest.mark.parametrize("shape,k,pad,dtype,error", [
    ((1, 2, 8, 8), 4, (1, 1), torch.float16, TypeError),    # not f32 or bf16
    ((2, 8, 8), 4, (1, 1), torch.float32, ValueError),      # not NCHW
    ((1, 2, 8, 8), 9, (1, 1), torch.float32, ValueError),   # more than 8 taps
    ((1, 2, 2, 2), 4, (0, 0), torch.bfloat16, ValueError),  # empty output
])
def test_kernel_work_checks_before_loading_the_kernel(shape, k, pad, dtype, error):
    """kernel_work refuses what the kernel does not take before it loads the
    kernel's library (which needs nvcc), so these raise on any machine."""
    with pytest.raises(error):
        FB.kernel_work(shape, k, pad, dtype)
