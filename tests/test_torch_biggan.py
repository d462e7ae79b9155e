"""The port's BigGAN-deep against the JAX package's, with the same weights.

Weights come from the golden test's synthetic HuggingFace-layout state_dict
(tests/test_biggan_golden.py), converted by the JAX package and carried to
the port through the flat ``save_params_npz`` layout. Forward and the
gradients with respect to z and c agree at f32 rtol 1e-4 (atol 2e-5 on the
images, as the golden test, and 1e-4 of the largest gradient entry).
"""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pix2latent_tpu.models.biggan import BigGAN as JaxBigGAN
from pix2latent_tpu.models.biggan import convert_torch_biggan
from pix2latent_tpu.utils.params_io import _flatten, save_params_npz
from pix2latent_tpu_torch.models.biggan import BigGAN
from test_biggan_golden import make_state_dict

VERSION, CH = "biggan-deep-128", 8


@pytest.fixture(scope="module")
def models():
    rng = np.random.RandomState(0)
    params = convert_torch_biggan(make_state_dict(rng, VERSION, CH), VERSION)
    jm = JaxBigGAN(VERSION, params=params, channel_width=CH)
    tm = BigGAN(VERSION, params=_flatten(params), channel_width=CH,
                device="cpu")
    return jm, tm


def _inputs(seed=1):
    rng = np.random.RandomState(seed)
    z = rng.randn(2, 128).astype(np.float32) * 0.5
    c = rng.randn(2, 128).astype(np.float32) * 0.1
    cot = rng.randn(2, 128, 128, 3).astype(np.float32)
    return z, c, cot


@pytest.mark.parametrize("truncation", [1.0, 0.5, 0.31])
def test_forward_and_grads_match_jax(models, truncation):
    jm, tm = models
    z, c, cot = _inputs()

    def jloss(z_, c_):
        out = jm.apply(jm.params, z=z_, c=c_, truncation=truncation)
        return jnp.sum(out * cot), out

    (_, want), (jdz, jdc) = jax.jit(jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True))(jnp.asarray(z), jnp.asarray(c))

    zt = torch.tensor(z, requires_grad=True)
    ct = torch.tensor(c, requires_grad=True)
    got = tm(zt, ct, truncation)
    (got * torch.tensor(cot)).sum().backward()

    assert got.shape == (2, 128, 128, 3) and got.dtype == torch.float32
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-4, atol=2e-5)
    for g_t, g_j, name in ((zt.grad, jdz, "dz"), (ct.grad, jdc, "dc")):
        g_j = np.asarray(g_j)
        np.testing.assert_allclose(g_t.numpy(), g_j, rtol=1e-4,
                                   atol=1e-4 * np.abs(g_j).max(),
                                   err_msg=name)


def test_class_embedding_matches_jax(models):
    jm, tm = models
    onehot = np.zeros((2, 1000), np.float32)
    onehot[0, 153], onehot[1, 7] = 1.0, 1.0
    want = np.asarray(jm.get_class_embedding(jnp.asarray(onehot)))
    np.testing.assert_allclose(
        tm.get_class_embedding(onehot).numpy(), want, rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(tm.get_class_embedding(153).numpy(),
                               want[:1], rtol=1e-6, atol=1e-7)


def test_random_init_matches_jax_for_the_same_seed():
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jm = JaxBigGAN(VERSION, channel_width=CH, seed=5)
        tm = BigGAN(VERSION, channel_width=CH, seed=5, device="cpu")
        ref = BigGAN(VERSION, channel_width=CH, device="cpu", params=_flatten(
            {"generator": jm.params, "embeddings": jm._embed.params}))
    got, want = tm.state_dict(), ref.state_dict()
    assert got.keys() == want.keys()
    for name in want:
        np.testing.assert_array_equal(got[name].numpy(), want[name].numpy(),
                                      err_msg=name)


def test_npz_weights_load_through_pretrained_path(models, tmp_path):
    jm, tm = models
    path = str(tmp_path / "biggan.npz")
    save_params_npz(path, {"generator": jm.params,
                           "embeddings": jm._embed.params})
    loaded = BigGAN(VERSION, pretrained_path=path, channel_width=CH,
                    device="cpu")
    for name, t in tm.state_dict().items():
        np.testing.assert_array_equal(loaded.state_dict()[name].numpy(),
                                      t.numpy(), err_msg=name)
    # the kernel layouts: conv HWIO -> OIHW, dense [in, out] -> [out, in]
    k = np.asarray(jm.params["block_0"]["conv_1"]["kernel"])
    np.testing.assert_array_equal(
        loaded.generator.block_0.conv_1.weight.numpy(), k.transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(loaded.generator.gen_z.weight.numpy(),
                                  np.asarray(jm.params["gen_z"]["kernel"]).T)


def test_sliced_output_conv_keeps_full_kernel(models):
    _, tm = models
    conv = tm.generator.conv_to_rgb
    assert tuple(conv.weight.shape) == (CH, CH, 3, 3)
    x = torch.randn(1, CH, 8, 8)
    full = torch.nn.functional.conv2d(x, conv.weight, conv.bias, padding=1)
    torch.testing.assert_close(conv(x), full[:, :3], rtol=1e-6, atol=1e-6)
