"""The port's upfirdn2d family against the JAX package's, on the same inputs.

``upfirdn2d`` with up, down and asymmetric pads and a non-symmetric kernel
(which pins the correlation convention), ``Blur`` (on both of its routes),
``Upsample``, ``Downsample``, ``make_kernel`` and ``fused_leaky_relu``. The
JAX functions take NHWC, the port's NCHW; inputs are numpy arrays
transposed between the two. All float32: rtol 1e-5, atol 1e-6 (depthwise
sums of at most 16 products).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pix2latent_tpu.ops import upfirdn2d as J
from pix2latent_tpu_torch.ops import fir_blur as FB
from pix2latent_tpu_torch.ops import upfirdn2d as T

TOL = dict(rtol=1e-5, atol=1e-6)


def _x(shape=(2, 3, 11, 13), seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _jax(fn, x_nchw, *args, **kwargs):
    out = fn(jnp.asarray(x_nchw.transpose(0, 2, 3, 1)), *args, **kwargs)
    return np.asarray(out).transpose(0, 3, 1, 2)


@pytest.mark.parametrize("up,down,pad,ksize", [
    (1, 1, (0, 0), 4), (1, 1, (2, 1), 4), (2, 1, (2, 1), 4),
    (1, 2, (1, 1), 4), (2, 2, (1, 2), 3), (1, 1, (1, 3), 3),
])
def test_upfirdn2d_matches_jax(up, down, pad, ksize):
    x = _x()
    k = np.random.RandomState(1).rand(ksize, ksize).astype(np.float32)
    want = _jax(J.upfirdn2d, x, jnp.asarray(k), up=up, down=down, pad=pad)
    got = T.upfirdn2d(torch.tensor(x), torch.tensor(k), up=up, down=down,
                      pad=pad).numpy()
    n, c, h, w = x.shape
    assert got.shape == (n, c, (h * up + sum(pad) - ksize) // down + 1,
                         (w * up + sum(pad) - ksize) // down + 1)
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("kernel,gain", [((1, 3, 3, 1), 1.0), ((1, 2, 1), 4.0),
                                         (np.outer([1, 2, 1], [1, 3, 1]), 2.0)])
def test_make_kernel_matches_jax(kernel, gain):
    np.testing.assert_array_equal(T.make_kernel(kernel, gain).numpy(),
                                  np.asarray(J.make_kernel(kernel, gain)))


@pytest.mark.parametrize("use_kernel", [False, True])
@pytest.mark.parametrize("pad,factor", [((1, 1), 2), ((2, 1), 1)])
def test_blur_matches_jax(use_kernel, pad, factor):
    x = _x(seed=2)
    FB.reset_launch_counts()
    blur = T.Blur((1, 3, 3, 1), pad=pad, upsample_factor=factor,
                  use_kernel=use_kernel)
    assert (blur._taps is not None) == use_kernel
    want = _jax(J.Blur((1, 3, 3, 1), pad=pad, upsample_factor=factor), x)
    np.testing.assert_allclose(blur(torch.tensor(x)).numpy(), want, **TOL)
    assert FB.launch_counts() == {"fwd": 0, "bwd": 0}   # CPU: plain version


def test_upsample_and_downsample_match_jax():
    x = _x(seed=3)
    np.testing.assert_allclose(T.Upsample()(torch.tensor(x)).numpy(),
                               _jax(J.Upsample(), x), **TOL)
    np.testing.assert_allclose(T.Downsample()(torch.tensor(x)).numpy(),
                               _jax(J.Downsample(), x), **TOL)
    assert T.Upsample()(torch.tensor(x)).shape == (2, 3, 22, 26)
    assert T.Downsample()(torch.tensor(x)).shape == (2, 3, 5, 6)


def test_fused_leaky_relu_matches_jax():
    rng = np.random.RandomState(4)
    x = rng.randn(2, 5, 3, 3).astype(np.float32)
    b = rng.randn(5).astype(np.float32)
    want = _jax(lambda v: J.fused_leaky_relu(v, jnp.asarray(b)), x)
    np.testing.assert_allclose(
        T.fused_leaky_relu(torch.tensor(x), torch.tensor(b)).numpy(), want,
        **TOL)
    v = rng.randn(4, 5).astype(np.float32)          # [n, features]
    np.testing.assert_allclose(
        T.fused_leaky_relu(torch.tensor(v), torch.tensor(b)).numpy(),
        np.asarray(J.fused_leaky_relu(jnp.asarray(v), jnp.asarray(b))), **TOL)
    np.testing.assert_allclose(
        T.fused_leaky_relu(torch.tensor(v)).numpy(),
        np.asarray(J.fused_leaky_relu(jnp.asarray(v))), **TOL)
