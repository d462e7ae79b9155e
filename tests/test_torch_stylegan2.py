"""The port's StyleGAN2 against the JAX package's, with the same weights.

Two small configurations of the same machinery as cars-512: im_res 32 with
channel multiplier 1, and im_res 16 with channel multiplier 2. Weights reach
the port from the JAX parameter tree (``params_io`` layout ``STYLEGAN2``),
from a rosinality state_dict (the golden test's synthetic one) through both
packages' converters, or from the same-seed random init, which must equal
the JAX package's. Forward (z and w+) agrees at rtol 2e-4, atol 2e-4 (as
``tests/test_stylegan2_golden.py``); z-gradients at rtol 1e-3 and 1e-3 of
the largest entry (as ``tests/test_mod_backward.py:71-91``), with the
port's two kernel flags off and on (their plain versions on the CPU).

The search tests use the ``equalized`` random init, built here from the JAX
parameter tree's own leaves: under the JAX package's init (every leaf x 0.1)
the mapping network's output does not depend on z to float32 precision, so
z-gradients would test nothing.
"""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pix2latent_tpu.models.stylegan2 import StyleGAN2 as JaxStyleGAN2
from pix2latent_tpu.models.stylegan2 import \
    convert_torch_stylegan2 as jax_convert
from pix2latent_tpu.utils.params_io import _flatten, save_params_npz
from pix2latent_tpu_torch.models import stylegan2 as S
from pix2latent_tpu_torch.ops import fir_blur as FB
from pix2latent_tpu_torch.ops import mod_backward as MB
from test_stylegan2_golden import make_state_dict

CONFIGS = [(32, 1), (16, 2)]          # (im_res, channel_multiplier)


def _unflatten(flat):
    tree = {}
    for path, v in flat.items():
        *parents, leaf = path.split("/")
        node = tree
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = jnp.asarray(v)
    return tree


def equalized_params(jax_params, seed):
    """The port's ``init="equalized"``, built from the JAX tree's leaves:
    one ``randn`` per leaf in JAX's sorted order, scaled by
    ``models/stylegan2.py:_equalized``."""
    flat = _flatten(jax_params)
    rng = np.random.RandomState(seed)
    out = {}
    for path in sorted(flat, key=lambda p: tuple(p.split("/"))):
        arr = np.asarray(rng.randn(*flat[path].shape), np.float32)
        out[path] = S._equalized(path, arr)
    return out


class Pair:
    """The JAX and the port's model of one configuration, same weights."""

    def __init__(self, res, cm):
        self.name = f"t{res}x{cm}"
        self.res, self.cm = res, cm
        self.jax_init = self.jax_model(seed=5)
        self.port_init = self.port(params=None, seed=5)
        self.flat = equalized_params(self.jax_init.params, seed=7)
        self.jm = self.jax_model(params=_unflatten(self.flat))

    def jax_model(self, **kwargs):
        saved = JaxStyleGAN2.MODELS
        JaxStyleGAN2.MODELS = dict(saved, **{self.name: self.res})
        try:
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")
                return JaxStyleGAN2(self.name, channel_multiplier=self.cm,
                                    **kwargs)
        finally:
            JaxStyleGAN2.MODELS = saved

    def port(self, **kwargs):
        """The port's model; by default with the equalized weights."""
        kwargs.setdefault("params", getattr(self, "flat", None))
        saved = S.StyleGAN2.MODELS
        S.StyleGAN2.MODELS = dict(saved, **{self.name: self.res})
        try:
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")
                return S.StyleGAN2(self.name, channel_multiplier=self.cm,
                                   device="cpu", **kwargs)
        finally:
            S.StyleGAN2.MODELS = saved


@pytest.fixture(scope="module", params=CONFIGS,
                ids=lambda c: f"res{c[0]}cm{c[1]}")
def pair(request):
    return Pair(*request.param)


def _z(n=2, seed=1):
    return np.random.RandomState(seed).randn(n, 512).astype(np.float32)


def test_random_init_matches_jax_for_the_same_seed(pair):
    ref = pair.port(params=pair.jax_init.params)
    got, want = pair.port_init.state_dict(), ref.state_dict()
    assert got.keys() == want.keys()
    for name in want:
        np.testing.assert_array_equal(got[name].numpy(), want[name].numpy(),
                                      err_msg=name)
    # and the layouts: HWIO -> OIHW, [in, out] -> [out, in], NHWC -> NCHW
    j = pair.jax_init.params
    g = pair.port_init.generator
    np.testing.assert_array_equal(g.convs_0.conv.weight.numpy(), np.asarray(
        j["convs_0"]["conv"]["weight"]).transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(g.style_3.weight.numpy(),
                                  np.asarray(j["style_3"]["weight"]).T)
    np.testing.assert_array_equal(g.noise_2.numpy(), np.asarray(
        j["noise_2"]).transpose(0, 3, 1, 2))
    assert float(g.conv1.noise.weight) == 0.0


def test_equalized_init_draws_the_jax_leaves(pair):
    got = pair.port(params=None, seed=7, init="equalized").state_dict()
    want = pair.port().state_dict()
    for name in want:
        np.testing.assert_array_equal(got[name].numpy(), want[name].numpy(),
                                      err_msg=name)


def test_rosinality_weights_carry_across(pair, tmp_path):
    sd = make_state_dict(np.random.RandomState(0), pair.res, pair.cm)
    want_flat = _flatten(jax_convert(sd, im_res=pair.res))
    got_flat = S.convert_torch_stylegan2(sd, im_res=pair.res)
    assert got_flat.keys() == want_flat.keys()
    for k in want_flat:
        np.testing.assert_array_equal(got_flat[k], want_flat[k], err_msg=k)

    path = str(tmp_path / "sg2.npz")
    save_params_npz(path, jax_convert(sd, im_res=pair.res))
    tm = pair.port(params=None, pretrained_path=path)
    jm = pair.jax_model(params=jax_convert(sd, im_res=pair.res))
    z = _z()
    want = np.asarray(jm(z=jnp.asarray(z)))
    got = tm(z=torch.tensor(z)).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)


def test_z_forward_matches_jax(pair):
    z = _z(3, seed=2)
    want = np.asarray(pair.jm(z=jnp.asarray(z)))
    got = pair.port()(z=torch.tensor(z))
    assert got.shape == (3, pair.res, pair.res, 3) and got.dtype == torch.float32
    assert float(got.abs().max()) <= 1.0
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-4, atol=2e-4)
    assert np.abs(want[0] - want[1]).mean() > 1e-2     # the image depends on z


def test_wplus_forward_and_reshape_noise_match_jax(pair):
    tm = pair.port(search="w+")
    nd = tm.noise_dim()
    assert nd == sum(r * r for r in tm.generator.noise_resolutions())
    rng = np.random.RandomState(3)
    w = rng.randn(2, 512).astype(np.float32)
    noises = rng.randn(2, nd).astype(np.float32)
    pair.jm.search = "w+"
    try:
        want = np.asarray(pair.jm.apply(pair.jm.params, z=jnp.asarray(w),
                                        noises=jnp.asarray(noises)))
        jmaps = pair.jm.reshape_noise(jnp.asarray(noises))
    finally:
        pair.jm.search = "z"
    got = tm(z=torch.tensor(w), noises=torch.tensor(noises)).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)
    maps = tm.reshape_noise(torch.tensor(noises))
    assert len(maps) == len(jmaps) == tm.generator.num_layers
    for a, b in zip(maps, jmaps):
        np.testing.assert_array_equal(a.numpy(),
                                      np.asarray(b).transpose(0, 3, 1, 2))
    with pytest.raises(ValueError):
        tm.reshape_noise(torch.zeros(2, nd + 1))


@pytest.mark.parametrize("fused_mod_bwd,fir_kernel",
                         [(False, False), (True, True), (True, False)])
def test_z_gradients_match_jax(pair, fused_mod_bwd, fir_kernel):
    z = _z(2, seed=4)
    cot = np.random.RandomState(5).randn(2, pair.res, pair.res, 3).astype(
        np.float32)

    def jloss(zj):
        return jnp.sum(pair.jm.apply(pair.jm.params, z=zj) * cot)

    want = np.asarray(jax.grad(jloss)(jnp.asarray(z)))
    tm = pair.port(fused_mod_bwd=fused_mod_bwd, fir_kernel=fir_kernel)
    zt = torch.tensor(z, requires_grad=True)
    (tm(z=zt) * torch.tensor(cot)).sum().backward()
    np.testing.assert_allclose(zt.grad.numpy(), want, rtol=1e-3,
                               atol=1e-3 * np.abs(want).max())
    assert np.abs(want).max() > 0
    assert FB.launch_counts() == {"fwd": 0, "bwd": 0}      # CPU: plain
    assert MB.launch_counts() == {"bwd": 0}


def test_latent_statistics(pair):
    tm = pair.port()
    gen = torch.Generator().manual_seed(0)
    mean, std = tm.latent_stats(64, generator=gen)
    z = torch.randn((64, 512), generator=torch.Generator().manual_seed(0))
    w = tm.generator.style(z)
    torch.testing.assert_close(mean, w.mean(0))
    torch.testing.assert_close(std, torch.sqrt(((w - w.mean(0)) ** 2).sum()
                                               / 64))
    ml = tm.mean_latent(64, generator=torch.Generator().manual_seed(0))
    assert ml.shape == (1, 512)
    torch.testing.assert_close(ml[0], mean)
    assert tm.mean_latent(8) is ml                            # cached


def test_bf16_forward_tracks_f32(pair):
    z = torch.tensor(_z(2, seed=6))
    f32 = pair.port()(z=z)
    bf16 = pair.port(dtype=torch.bfloat16, fused_mod_bwd=True,
                     fir_kernel=True)(z=z)
    assert bf16.dtype == torch.float32 and torch.isfinite(bf16).all()
    assert float((bf16 - f32).abs().mean()) < 0.05


def test_entry_points_need_a_device_without_cuda(monkeypatch):
    from pix2latent_tpu_torch import VariableManager
    from pix2latent_tpu_torch.optimizers import (CMAOptimizer,
                                                 GradientOptimizer)

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        S.StyleGAN2("cars")
    vm = VariableManager(device="cpu")
    for driver in (GradientOptimizer, CMAOptimizer):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            driver(lambda z: z, vm, lambda out, target: out)
