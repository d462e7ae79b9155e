"""The port's population-pair packing (``pack_pairs_max_ch``) in StyleGAN2.

Every case of ``tests/test_stylegan2.py``'s ``TestPopulationPairPacking``,
on the port: the 2-group conv against the batched one, the packed
generator against the default one (z path, w path with per-sample noise,
z gradients), member isolation, the transition block and the even
population; then the port's packed generator against the JAX package's
packed generator on the same weights. Tolerances are the JAX tests':
outputs rtol 2e-4, atol 2e-4; z gradients within 1e-4 of the largest
entry between the port's two forms, 1e-3 against the JAX package (as
``tests/test_torch_stylegan2.py``); isolation bitwise.
"""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from pix2latent_tpu.models import stylegan2 as JS
from pix2latent_tpu.utils.params_io import _flatten
from pix2latent_tpu_torch.models import stylegan2 as S
from pix2latent_tpu_torch.utils.params_io import STYLEGAN2, from_jax_params


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_params(im_res, cm):
    mod = JS.StyleGAN2Generator(im_res=im_res, channel_multiplier=cm)
    return mod.init(jax.random.PRNGKey(0), jnp.zeros((2, 512)))["params"]


def _port(params, im_res, cm, pack=0, **kwargs):
    g = S.StyleGAN2Generator(im_res=im_res, channel_multiplier=cm,
                             pack_pairs_max_ch=pack, **kwargs)
    g.load_state_dict(from_jax_params(_flatten(params), STYLEGAN2),
                      strict=True)
    return g.requires_grad_(False)


@pytest.fixture(scope="module")
def sg2():
    params = _jax_params(32, 1)
    return params, _port(params, 32, 1), _port(params, 32, 1, pack=512)


def _z(seed, n=4):
    return torch.from_numpy(np.array(
        jax.random.normal(jax.random.PRNGKey(seed), (n, 512))))


def _z_grad(g, z):
    z = z.clone().requires_grad_(True)
    (g(z) ** 2).sum().backward()
    return z.grad


def _assert_grads_close(ga, gb, scale=1e-4):
    ga, gb = np.asarray(ga), np.asarray(gb)
    assert np.abs(ga - gb).max() < scale * np.abs(ga).max(), (
        np.abs(ga - gb).max(), np.abs(ga).max())


# --------------------------------------------------------------------- #
# the helpers                                                             #
# --------------------------------------------------------------------- #

def test_pack_helpers_match_jax():
    x = np.random.RandomState(0).randn(6, 5, 5, 3).astype(np.float32)
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)              # NCHW
    packed = S.pack_pairs(xt)
    want = np.asarray(JS.pack_pairs(jnp.asarray(x)))
    np.testing.assert_array_equal(packed.permute(0, 2, 3, 1).numpy(), want)
    assert torch.equal(S.unpack_pairs(packed), xt)
    s = np.random.RandomState(1).randn(6, 4).astype(np.float32)
    np.testing.assert_array_equal(S.pack_rows(torch.from_numpy(s)).numpy(),
                                  np.asarray(JS.pack_rows(jnp.asarray(s))))


@pytest.mark.parametrize("up", [False, True])
def test_grouped_conv_matches_batched(up):
    """The packed pair's shared conv as a 2-group conv with the kernel
    repeated per group: the batched conv's values, and its input
    gradients."""
    P, H, C, O, K = 4, 16, 8, 6, 3
    rng = np.random.RandomState(0)
    w = torch.from_numpy(0.1 * rng.randn(O, C, K, K).astype(np.float32))
    x = torch.from_numpy(rng.randn(P, C, H, H).astype(np.float32))

    def conv(x, packed):
        g = 2 if packed else 1
        if up:
            return F.conv_transpose2d(x, w.transpose(0, 1).repeat(g, 1, 1, 1),
                                      stride=2, groups=g)
        return F.conv2d(x, w.repeat(g, 1, 1, 1), padding=1, groups=g)

    y = conv(x, False)
    yp = S.unpack_pairs(conv(S.pack_pairs(x), True))
    np.testing.assert_allclose(yp.numpy(), y.numpy(), rtol=1e-6, atol=1e-6)
    xa = x.clone().requires_grad_(True)
    xb = x.clone().requires_grad_(True)
    (conv(xa, False) ** 2).sum().backward()
    (conv(S.pack_pairs(xb), True) ** 2).sum().backward()
    np.testing.assert_allclose(xb.grad.numpy(), xa.grad.numpy(), rtol=1e-6,
                               atol=1e-6)


# --------------------------------------------------------------------- #
# the packed generator against the default one                           #
# --------------------------------------------------------------------- #

def test_packed_generator_matches_default(sg2):
    _, mod, packed = sg2
    z = _z(5)
    with torch.no_grad():
        a, b = mod(z), packed(z)
    np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=2e-4, atol=2e-4)
    noises = [torch.from_numpy(np.array(jax.random.normal(
        jax.random.PRNGKey(10 + i), (4, 1, r, r))))
        for i, r in enumerate(mod.noise_resolutions())]
    with torch.no_grad():
        a = mod(z, noises=noises, input_is_latent=True)
        b = packed(z, noises=noises, input_is_latent=True)
    np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=2e-4, atol=2e-4)
    _assert_grads_close(_z_grad(mod, z), _z_grad(packed, z))


def test_packed_members_are_isolated(sg2):
    _, _, packed = sg2
    z = _z(6)
    z2 = z.clone()
    z2[1], z2[3] = -z[1], 2.0 * z[3]
    with torch.no_grad():
        a, b = packed(z), packed(z2)
    assert torch.equal(a[0], b[0]) and torch.equal(a[2], b[2])
    assert float((a[1] - b[1]).abs().max()) > 0


def test_transition_block_matches_default():
    """im_res 64, channel multiplier 1, max 256 channels: the pack sits at
    the entry of the 64-px block, whose up-conv takes the 512-channel
    input of the block before."""
    params = _jax_params(64, 1)
    mod, packed = _port(params, 64, 1), _port(params, 64, 1, pack=256)
    assert [getattr(packed, f"convs_{i}").packed for i in range(8)] == \
        [False] * 6 + [True] * 2
    z = _z(7)
    with torch.no_grad():
        a, b = mod(z), packed(z)
    np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=2e-4, atol=2e-4)
    _assert_grads_close(_z_grad(mod, z), _z_grad(packed, z))


def test_single_sample_runs_unpacked(sg2):
    _, mod, packed = sg2
    z = _z(8, n=1)
    with torch.no_grad():
        assert torch.equal(mod(z), packed(z))


def test_packed_requires_even_population(sg2):
    _, _, packed = sg2
    with pytest.raises(ValueError, match="even population"):
        packed(_z(1, n=3))


def test_packing_excludes_fused_mod_bwd():
    with pytest.raises(ValueError, match="mutually exclusive"):
        S.StyleGAN2Generator(im_res=32, channel_multiplier=1,
                             pack_pairs_max_ch=512, fused_mod_bwd=True)
    # no layer thin enough to pack: nothing to exclude
    S.StyleGAN2Generator(im_res=32, channel_multiplier=1,
                         pack_pairs_max_ch=8, fused_mod_bwd=True)


def test_wrapper_threads_the_limit():
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        m = S.StyleGAN2("cars", pack_pairs_max_ch=64, device="cpu")
    g = m.generator
    packed = {name for name, mod in g.named_modules()
              if getattr(mod, "packed", False)}
    assert packed == {"convs_12", "convs_13", "to_rgbs_6"}
    assert S.channels_for(512) == 64 and S.channels_for(256) == 128


# --------------------------------------------------------------------- #
# against the JAX package's packed generator                             #
# --------------------------------------------------------------------- #

@pytest.mark.parametrize("im_res,cm,pack", [(32, 1, 512), (64, 1, 256)])
def test_packed_generator_matches_jax_packed(im_res, cm, pack):
    params = _jax_params(im_res, cm)
    jmod = JS.StyleGAN2Generator(im_res=im_res, channel_multiplier=cm,
                                 pack_pairs_max_ch=pack)
    port = _port(params, im_res, cm, pack=pack)
    z = np.array(jax.random.normal(jax.random.PRNGKey(9), (4, 512)))
    want = np.asarray(jmod.apply({"params": params}, jnp.asarray(z)))
    with torch.no_grad():
        got = port(torch.from_numpy(z)).permute(0, 2, 3, 1)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-4, atol=2e-4)

    noises_np = [np.array(jax.random.normal(jax.random.PRNGKey(20 + i),
                                            (4, r, r, 1)))
                 for i, r in enumerate(port.noise_resolutions())]
    want = np.asarray(jmod.apply({"params": params}, jnp.asarray(z),
                                 noises=[jnp.asarray(n) for n in noises_np],
                                 input_is_latent=True))
    with torch.no_grad():
        got = port(torch.from_numpy(z), noises=[
            torch.from_numpy(n).permute(0, 3, 1, 2) for n in noises_np],
            input_is_latent=True).permute(0, 2, 3, 1)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-4, atol=2e-4)

    jgrad = jax.grad(lambda zz: jnp.sum(
        jmod.apply({"params": params}, zz) ** 2))(jnp.asarray(z))
    _assert_grads_close(jgrad, _z_grad(port, torch.from_numpy(z)),
                        scale=1e-3)
