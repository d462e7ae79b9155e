"""The port's LPIPS-alex and inversion losses against the JAX package's, with
the same weights (the golden test's synthetic lpips-layout state_dict,
converted by the JAX package), at the tolerances of
tests/test_lpips_golden.py (rtol 1e-4; atol 1e-5 spatial, 1e-6 per sample)."""

import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pix2latent_tpu.loss_functions as JLF
import pix2latent_tpu_torch.loss_functions as LF
from pix2latent_tpu.losses.lpips import LPIPS as JaxLPIPS
from pix2latent_tpu.losses.lpips import convert_torch_lpips, random_init_params
from pix2latent_tpu.utils.params_io import _flatten
from pix2latent_tpu_torch.losses.lpips import LPIPS
from test_lpips_golden import make_alex_state_dict

HW = 64


@pytest.fixture(scope="module")
def alex_params():
    return convert_torch_lpips(make_alex_state_dict(np.random.RandomState(0)),
                               net="alex")


def _images(seed, n=2):
    rng = np.random.RandomState(seed)
    return [rng.uniform(-1, 1, (n, HW, HW, 3)).astype(np.float32)
            for _ in range(2)]


@pytest.mark.parametrize("spatial", [True, False])
def test_lpips_distance_matches_jax(alex_params, spatial):
    x, y = _images(0)
    jl = JaxLPIPS("alex", params=alex_params, spatial=spatial)
    tl = LPIPS("alex", params=alex_params, spatial=spatial, device="cpu")
    want = np.asarray(jl(jnp.asarray(x), jnp.asarray(y)))
    got = tl(torch.tensor(x), torch.tensor(y)).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-4,
                               atol=1e-5 if spatial else 1e-6)


def test_lpips_features_match_jax(alex_params):
    _, y = _images(1)
    jl = JaxLPIPS("alex", params=alex_params)
    tl = LPIPS("alex", params=_flatten(alex_params), device="cpu")
    want = jl.features(jnp.asarray(y))
    got = tl.features(torch.tensor(y))
    assert len(got) == len(want) == 5
    for a, b in zip(got, want):                  # port NCHW, JAX NHWC
        np.testing.assert_allclose(a.permute(0, 2, 3, 1).numpy(),
                                   np.asarray(b), rtol=1e-4, atol=1e-5)
    # distance against a precomputed 1-row pyramid == the full call
    x, _ = _images(2)
    xt = torch.tensor(x)
    torch.testing.assert_close(
        tl.distance(xt, tl.features(torch.tensor(y[:1]))),
        tl(xt, torch.tensor(np.repeat(y[:1], 2, 0))), rtol=1e-5, atol=1e-6)


def test_lpips_random_init_matches_jax():
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        tl = LPIPS("alex", device="cpu")
    ref = LPIPS("alex", params=random_init_params("alex"), device="cpu")
    for name, t in ref.state_dict().items():
        np.testing.assert_array_equal(tl.state_dict()[name].numpy(),
                                      t.numpy(), err_msg=name)


def test_projection_loss_matches_jax(alex_params):
    x, target = _images(3, n=3)
    rng = np.random.RandomState(4)
    weight = rng.uniform(0, 1, (1, HW, HW, 3)).astype(np.float32)
    jloss = JLF.ProjectionLoss("alex", beta=10.0, lpips_params=alex_params)
    tloss = LF.ProjectionLoss("alex", beta=10.0, lpips_params=alex_params,
                              device="cpu")
    want = np.asarray(jloss(jnp.asarray(x), jnp.asarray(target[:1]),
                            weight=jnp.asarray(weight)))
    got = tloss(torch.tensor(x), torch.tensor(target[:1]),
                weight=torch.tensor(weight)).numpy()
    assert got.shape == (3,)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-6)

    ctx = tloss.precompute(torch.tensor(target[:1]), torch.tensor(weight))
    np.testing.assert_allclose(tloss.from_ctx(torch.tensor(x), ctx).numpy(),
                               got, rtol=1e-6, atol=1e-7)

    # unweighted: the per-pixel map that the execution core averages
    want_map = np.asarray(jloss(jnp.asarray(x), jnp.asarray(target)))
    got_map = tloss(torch.tensor(x), torch.tensor(target)).numpy()
    assert got_map.shape == want_map.shape == (3, HW, HW, 3)
    np.testing.assert_allclose(got_map, want_map, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("name", ["masked_l1_loss", "masked_l2_loss"])
def test_masked_losses_match_jax(name):
    x, target = _images(5, n=3)
    mask = (np.random.RandomState(6).rand(1, HW, HW, 3) > 0.3).astype(
        np.float32)
    want = getattr(JLF, name)(jnp.asarray(x), jnp.asarray(target[:1]),
                              jnp.asarray(mask))
    got = getattr(LF, name)(torch.tensor(x), torch.tensor(target[:1]),
                            torch.tensor(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-7)


def test_reconstruction_loss_weighting_matches_jax():
    x, target = _images(7, n=2)
    rng = np.random.RandomState(8)
    weight = rng.uniform(0, 1, (1, HW, HW, 3)).astype(np.float32)
    loss_mask = (rng.rand(1, HW, HW, 3) > 0.5).astype(np.float32)
    for kind in ("l1", "l2"):
        want = JLF.ReconstructionLoss(kind)(
            jnp.asarray(x), jnp.asarray(target), jnp.asarray(weight),
            jnp.asarray(loss_mask))
        got = LF.ReconstructionLoss(kind)(
            torch.tensor(x), torch.tensor(target), torch.tensor(weight),
            torch.tensor(loss_mask))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                                   atol=1e-7, err_msg=kind)
