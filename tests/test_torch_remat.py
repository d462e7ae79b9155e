"""Recompute in the backward (``remat``) in the port's generators, against
their own runs without it and against the JAX package's ``nn.remat`` runs,
and the FFHQ-1024 parameter tree.

- StyleGAN2 (im_res 32, channel multiplier 1, equalized weights from the
  JAX tree; ``remat_from_res`` 16 and 32), both kernel flags on (their plain
  versions on the CPU): the z-gradient equals the run without remat to f32
  rounding (rtol 1e-6, atol 1e-6 of the largest entry: the recompute runs
  the same operations on the same inputs), and the JAX package's
  ``remat_from_res`` run at the tolerances of
  ``tests/test_torch_stylegan2.py`` (rtol 1e-3, atol 1e-3 of the largest
  entry).
- BigGAN-deep-128 (channel width 8, ``remat`` and ``remat_from_res`` 64):
  the same against its run without remat, and against the JAX package's
  gradient at the tolerances of ``tests/test_torch_biggan.py`` (rtol 1e-4,
  atol 1e-4 of the largest entry). The JAX package's own ``remat`` BigGAN
  cannot be differentiated: ``nn.remat(GenBlock)`` traces the truncation,
  which ``StandingBatchNorm`` requires as a Python number, and raises a
  TypeError; the reference value is its run without remat, which remat
  must not change.
- FFHQ-1024 at full width: the JAX package's random-init tree carries over
  through the ``STYLEGAN2`` layout, the port's random init draws the same
  numbers, and the ``equalized`` init builds (18 w layers, 17 noise maps).
"""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pix2latent_tpu.models.biggan import BigGAN as JaxBigGAN
from pix2latent_tpu.models.biggan import convert_torch_biggan
from pix2latent_tpu.models.stylegan2 import StyleGAN2 as JaxStyleGAN2
from pix2latent_tpu.utils.params_io import _flatten
from pix2latent_tpu_torch.models import stylegan2 as S
from pix2latent_tpu_torch.models.biggan import BigGAN
from test_biggan_golden import make_state_dict
from test_torch_stylegan2 import Pair, _unflatten


@pytest.fixture(scope="module")
def sg2():
    return Pair(32, 1)


def _port_z_grad(model, z, cot):
    zt = torch.tensor(z, requires_grad=True)
    (model(z=zt) * torch.tensor(cot)).sum().backward()
    return zt.grad.numpy()


@pytest.mark.parametrize("remat_from_res", [16, 32])
def test_stylegan2_remat_gradients(sg2, remat_from_res):
    rng = np.random.RandomState(4)
    z = rng.randn(2, 512).astype(np.float32)
    cot = rng.randn(2, 32, 32, 3).astype(np.float32)
    flags = dict(fused_mod_bwd=True, fir_kernel=True)
    plain = _port_z_grad(sg2.port(**flags), z, cot)
    remat = sg2.port(remat_from_res=remat_from_res, **flags)
    got = _port_z_grad(remat, z, cot)
    np.testing.assert_allclose(got, plain, rtol=1e-6,
                               atol=1e-6 * np.abs(plain).max())

    jm = sg2.jax_model(params=_unflatten(sg2.flat),
                       remat_from_res=remat_from_res)
    want = np.asarray(jax.grad(lambda zj: jnp.sum(
        jm.apply(jm.params, z=zj) * cot))(jnp.asarray(z)))
    np.testing.assert_allclose(got, want, rtol=1e-3,
                               atol=1e-3 * np.abs(want).max())
    assert np.abs(want).max() > 0
    # without gradients the blocks run directly, to the same images
    with torch.no_grad():
        np.testing.assert_array_equal(remat(z=torch.tensor(z)).numpy(),
                                      sg2.port(**flags)(z=torch.tensor(z)).numpy())


@pytest.fixture(scope="module")
def biggan_params():
    rng = np.random.RandomState(0)
    return convert_torch_biggan(make_state_dict(rng, "biggan-deep-128", 8),
                                "biggan-deep-128")


@pytest.mark.parametrize("remat", [dict(remat=True),
                                   dict(remat_from_res=64)])
def test_biggan_remat_gradients(biggan_params, remat):
    rng = np.random.RandomState(1)
    z = rng.randn(2, 128).astype(np.float32) * 0.5
    c = rng.randn(2, 128).astype(np.float32) * 0.1
    cot = rng.randn(2, 128, 128, 3).astype(np.float32)

    def port_grads(**kwargs):
        tm = BigGAN("biggan-deep-128", params=_flatten(biggan_params),
                    channel_width=8, device="cpu", **kwargs)
        zt = torch.tensor(z, requires_grad=True)
        ct = torch.tensor(c, requires_grad=True)
        (tm(zt, ct, 0.5) * torch.tensor(cot)).sum().backward()
        return zt.grad.numpy(), ct.grad.numpy()

    plain, got = port_grads(), port_grads(**remat)
    jm = JaxBigGAN("biggan-deep-128", params=biggan_params, channel_width=8)
    want = jax.jit(jax.grad(lambda zj, cj: jnp.sum(
        jm.apply(jm.params, z=zj, c=cj, truncation=0.5) * cot),
        argnums=(0, 1)))(jnp.asarray(z), jnp.asarray(c))
    for g, p, w in zip(got, plain, want):
        w = np.asarray(w)
        np.testing.assert_allclose(g, p, rtol=1e-6, atol=1e-6 * np.abs(p).max())
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-4 * np.abs(w).max())


def test_ffhq_1024_tree_and_inits():
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jm = JaxStyleGAN2("ffhq", seed=5)
        port = S.StyleGAN2("ffhq", seed=5, device="cpu")
        carried = S.StyleGAN2("ffhq", params=jm.params, device="cpu")
        equalized = S.StyleGAN2("ffhq", seed=5, init="equalized",
                                device="cpu")
    g = port.generator
    assert g.im_res == 1024 and g.num_layers == 17 and g.log_size * 2 - 2 == 18
    assert tuple(g.convs_14.conv.weight.shape) == (32, 64, 3, 3)
    assert tuple(g.noise_16.shape) == (1, 1, 1024, 1024)
    assert port.noise_dim() == sum(r * r for r in g.noise_resolutions())
    got, want = port.state_dict(), carried.state_dict()
    assert got.keys() == want.keys() == equalized.state_dict().keys()
    for name in want:
        assert torch.equal(got[name], want[name]), name
    # the layouts at the 1024 level: HWIO -> OIHW, NHWC -> NCHW
    np.testing.assert_array_equal(
        g.convs_15.conv.weight.numpy(),
        np.asarray(jm.params["convs_15"]["conv"]["weight"]).transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(
        g.noise_16.numpy(), np.asarray(jm.params["noise_16"]).transpose(0, 3, 1, 2))
    assert float(equalized.generator.to_rgbs_7.conv.modulation.bias[0]) == 1.0
