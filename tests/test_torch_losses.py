"""The port's LPIPS (alex, vgg16, squeeze) and inversion losses against the
JAX package's, with the same weights (the golden test's synthetic
lpips-layout state_dicts, converted by the JAX package; for squeeze, whose
checkpoints the JAX package does not convert, its random-init tree), at the
tolerances of tests/test_lpips_golden.py (rtol 1e-4; atol 1e-5 spatial,
1e-6 per sample)."""

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
from pix2latent_tpu_torch.losses.lpips import \
    convert_torch_lpips as port_convert
from test_lpips_golden import make_alex_state_dict, make_vgg_state_dict

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


def _net_params(net):
    if net == "vgg16":
        return convert_torch_lpips(
            make_vgg_state_dict(np.random.RandomState(0)), net="vgg16")
    return random_init_params(net)


@pytest.mark.parametrize("spatial", [True, False])
@pytest.mark.parametrize("net", ["vgg16", "squeeze"])
def test_lpips_vgg16_and_squeeze_match_jax(net, spatial):
    params = _net_params(net)
    x, y = _images(9)
    jl = JaxLPIPS(net, params=params, spatial=spatial)
    tl = LPIPS(net, params=_flatten(params), spatial=spatial, device="cpu")
    want = np.asarray(jl(jnp.asarray(x), jnp.asarray(y)))
    got = tl(torch.tensor(x), torch.tensor(y)).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-4,
                               atol=1e-5 if spatial else 1e-6)
    fj, ft = jl.features(jnp.asarray(y)), tl.features(torch.tensor(y))
    assert len(ft) == len(fj) == {"vgg16": 5, "squeeze": 7}[net]
    for a, b in zip(ft, fj):                     # port NCHW, JAX NHWC
        np.testing.assert_allclose(a.permute(0, 2, 3, 1).numpy(),
                                   np.asarray(b), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("net", ["vgg16", "squeeze"])
def test_lpips_random_init_matches_jax_for_every_net(net):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        tl = LPIPS(net, device="cpu")
    ref = LPIPS(net, params=random_init_params(net), device="cpu")
    for name, t in ref.state_dict().items():
        np.testing.assert_array_equal(tl.state_dict()[name].numpy(),
                                      t.numpy(), err_msg=name)


@pytest.mark.parametrize("net,make_sd", [("alex", make_alex_state_dict),
                                         ("vgg16", make_vgg_state_dict)])
def test_convert_torch_lpips_matches_jax(net, make_sd):
    sd = make_sd(np.random.RandomState(1))
    want = _flatten(convert_torch_lpips(sd, net=net))
    got = port_convert(sd, net=net)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_convert_torch_lpips_squeeze_layout():
    """The lpips package's squeeze checkpoint layout (torchvision
    squeezenet1_1 features in seven slices) lands on the port's modules."""
    tl = LPIPS("squeeze", params=random_init_params("squeeze"), device="cpu")
    rng = np.random.RandomState(2)
    where = {"conv1": "net.slice1.0", "fire2": "net.slice2.3",
             "fire3": "net.slice2.4", "fire4": "net.slice3.6",
             "fire5": "net.slice3.7", "fire6": "net.slice4.9",
             "fire7": "net.slice5.10", "fire8": "net.slice6.11",
             "fire9": "net.slice7.12"}
    sd = {}
    for name, p in tl.named_parameters():
        parts = name.split(".")
        if parts[0] == "backbone":
            key = ".".join([where[parts[1]]] + parts[2:])
        else:
            key = f"{parts[0]}.model.1.{parts[1]}"
        sd[key] = torch.tensor(rng.randn(*p.shape).astype(np.float32))
    loaded = LPIPS("squeeze", params=port_convert(sd, net="squeeze"),
                   device="cpu")
    assert torch.equal(loaded.backbone.fire7.expand3x3.weight,
                       sd["net.slice5.10.expand3x3.weight"])
    assert torch.equal(loaded.backbone.conv1.bias, sd["net.slice1.0.bias"])
    assert torch.equal(loaded.lin6.weight, sd["lin6.model.1.weight"])
