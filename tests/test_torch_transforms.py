"""The port's transforms and warps against the JAX package's
(``tests/test_transforms.py``), the same inputs made from a numpy seed for
both:

- ``affine_grid``, ``grid_sample`` and the two-product warp (both ways) at
  H != W with tx != ty: atol 1e-5; their gradients in the parameter against
  ``jax.grad``: rtol 1e-4;
- ``SpatialTransform``: identity, invertibility, sensitivity, both warp
  routes, ``pre_align`` from a synthetic mask;
- the mask statistics of ``transform/utils`` and ``setup_transform_fn``;
- ``rgb_to_hsv`` / ``hsv_to_rgb`` on random and edge pixels (gray, ties, 0
  and 1): atol 1e-5; each color transform forward and inverse, and its
  gradient away from the clamp rails;
- ``ComposeTransform``, ``SpatialOnly`` and ``get_search_identity``;
- ``invertibility_loss``.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pix2latent_tpu.loss_functions as JLF
import pix2latent_tpu.transform as JT
import pix2latent_tpu.transform.color as JC
import pix2latent_tpu.transform.utils as JU
import pix2latent_tpu_torch.loss_functions as LF
import pix2latent_tpu_torch.transform as T
import pix2latent_tpu_torch.transform.color as TC
import pix2latent_tpu_torch.transform.utils as TU
from pix2latent_tpu_torch.ops import affine_matmul as AM
from pix2latent_tpu_torch.ops import grid_sample as GS

# the JAX package's ops/__init__ binds the name grid_sample to the function
JAM = importlib.import_module("pix2latent_tpu.ops.affine_matmul")
JGS = importlib.import_module("pix2latent_tpu.ops.grid_sample")

H, W = 17, 23
# [s, tx, ty] rows with tx != ty: zoom in, zoom out past the frame, a small
# shift (none puts a sampling point on a pixel, where the warp has a kink)
T_ROWS = np.array([[0.8, 0.2, -0.3], [1.3, -0.45, 0.15],
                   [1.05, 0.11, 0.37]], np.float32)
COLOR_CLASSES = ["HueTransform", "BrightnessTransform", "GammaTransform",
                 "SaturationTransform", "ContrastTransform"]
# a parameter of each, inside its clamp range and away from its identity
COLOR_T = {"HueTransform": 0.21, "BrightnessTransform": 0.8,
           "GammaTransform": 1.3, "SaturationTransform": 1.2,
           "ContrastTransform": 0.75}


def _images(seed, shape=(3, H, W, 3), low=-1.0, high=1.0):
    """Uniform images in the package's range [-1, 1]."""
    return np.random.RandomState(seed).uniform(
        low, high, shape).astype(np.float32)


def _theta(t):
    theta = np.zeros((t.shape[0], 2, 3), np.float32)
    theta[:, 0, 0] = theta[:, 1, 1] = t[:, 0]
    theta[:, :, 2] = t[:, 1:]
    return theta


def _close(got, want, **tol):
    np.testing.assert_allclose(
        got.detach().cpu().numpy() if isinstance(got, torch.Tensor) else got,
        np.asarray(want), **tol)


# --------------------------------------------------------------------- #
# warps                                                                   #
# --------------------------------------------------------------------- #

@pytest.mark.parametrize("shear", [False, True])
def test_affine_grid_and_grid_sample_match_jax(shear):
    im = _images(0)
    theta = _theta(T_ROWS)
    if shear:
        theta[:, 0, 1], theta[:, 1, 0] = 0.1, -0.07
    grid = GS.affine_grid(torch.tensor(theta), (H, W))
    want_grid = JGS.affine_grid(jnp.asarray(theta), (H, W))
    assert grid.shape == (3, H, W, 2)
    _close(grid, want_grid, atol=1e-5)
    _close(GS.grid_sample(torch.tensor(im), grid),
           JGS.grid_sample(jnp.asarray(im), want_grid), atol=1e-5)
    _close(GS.affine_warp(torch.tensor(im), torch.tensor(theta)),
           JGS.affine_warp(jnp.asarray(im), jnp.asarray(theta)), atol=1e-5)


@pytest.mark.parametrize("invert", [False, True])
def test_affine_warp_matmul_matches_jax_both_ways(invert):
    im = _images(1)
    fn, jfn = ((AM.inverse_affine_warp_matmul_t,
                JAM.inverse_affine_warp_matmul_t) if invert else
               (AM.affine_warp_matmul_t, JAM.affine_warp_matmul_t))
    got = fn(torch.tensor(im), torch.tensor(T_ROWS))
    assert got.shape == (3, H, W, 3) and got.dtype == torch.float32
    _close(got, jfn(jnp.asarray(im), jnp.asarray(T_ROWS)), atol=1e-5)


def test_affine_warp_matmul_is_grid_sample():
    im = _images(2)
    got = AM.affine_warp_matmul_t(torch.tensor(im), torch.tensor(T_ROWS))
    want = GS.affine_warp(torch.tensor(im), torch.tensor(_theta(T_ROWS)))
    _close(got, want.numpy(), atol=2e-5)


def test_affine_warp_matmul_rows_follow_ty_and_columns_tx():
    # a pure shift by one pixel down (ty) differs from one right (tx): a swap
    # of the two axes would pass on square images with tx == ty
    im = np.zeros((1, 4, 6, 1), np.float32)
    im[0, 1, 2] = 1.0
    down = AM.affine_warp_matmul_t(torch.tensor(im),
                                   torch.tensor([[1.0, 0.0, -2.0 / 4]]))
    right = AM.affine_warp_matmul_t(torch.tensor(im),
                                    torch.tensor([[1.0, -2.0 / 6, 0.0]]))
    assert float(down[0, 2, 2, 0]) == pytest.approx(1.0)
    assert float(right[0, 1, 3, 0]) == pytest.approx(1.0)


def test_affine_warp_matmul_output_is_float32_for_bf16():
    im = torch.tensor(np.random.RandomState(3).randn(2, 8, 6, 3)).bfloat16()
    out = AM.affine_warp_matmul_t(im, torch.tensor(T_ROWS[:2]))
    assert out.dtype == torch.float32
    _close(out, AM.affine_warp_matmul_t(im.float(),
                                        torch.tensor(T_ROWS[:2])).numpy(),
           atol=0)


@pytest.mark.parametrize("route", ["matmul", "grid_sample"])
def test_warp_gradient_in_t_matches_jax(route):
    im = _images(4)

    if route == "matmul":
        def jf(t):
            return jnp.sum(JAM.affine_warp_matmul_t(jnp.asarray(im), t) ** 2)

        def tf(t):
            return (AM.affine_warp_matmul_t(torch.tensor(im), t) ** 2).sum()
    else:
        def jf(t):
            theta = jnp.stack([
                jnp.stack([t[:, 0], 0 * t[:, 0], t[:, 1]], -1),
                jnp.stack([0 * t[:, 0], t[:, 0], t[:, 2]], -1)], 1)
            return jnp.sum(JGS.affine_warp(jnp.asarray(im), theta) ** 2)

        def tf(t):
            theta = T.SpatialTransform._theta(t[:, 0], t[:, 1:])
            return (GS.affine_warp(torch.tensor(im), theta) ** 2).sum()

    want = np.asarray(jax.grad(jf)(jnp.asarray(T_ROWS)))
    t = torch.tensor(T_ROWS, requires_grad=True)
    tf(t).backward()
    assert np.abs(want).min() > 1.0          # not vacuous
    np.testing.assert_allclose(t.grad.numpy(), want, rtol=1e-4)


# --------------------------------------------------------------------- #
# SpatialTransform                                                        #
# --------------------------------------------------------------------- #

@pytest.mark.parametrize("matmul", [True, False])
def test_spatial_transform_matches_jax(matmul):
    im = _images(5)
    delta = np.random.RandomState(6).randn(3, 3).astype(np.float32)
    tf = T.SpatialTransform(t=(1.1, 0.05, -0.1), sensitivity=0.2,
                            use_matmul_warp=matmul, device="cpu")
    jtf = JT.SpatialTransform(t=(1.1, 0.05, -0.1), sensitivity=0.2,
                              use_matmul_warp=matmul)
    for invert in (False, True):
        _close(tf(torch.tensor(im), torch.tensor(delta), invert=invert),
               jtf(jnp.asarray(im), jnp.asarray(delta), invert=invert),
               atol=1e-5)
    _close(tf.get_default_param(), jtf.get_default_param(), atol=0)
    _close(tf.get_identity_param(), jtf.get_identity_param(), atol=0)
    assert tf.get_default_param().device.type == "cpu"


def test_spatial_identity_and_sensitivity():
    im = torch.tensor(_images(7, (2, 16, 16, 3)))
    tf = T.SpatialTransform(device="cpu")
    _close(tf(im, torch.zeros(2, 3)), im.numpy(), atol=1e-6)
    big = tf(im, torch.tensor([[1.0, 0.0, 0.0]]))
    same = tf.transform(im, torch.tensor([[1.1, 0.0, 0.0]]))
    _close(big, same.numpy(), atol=1e-5)


def test_spatial_invertibility():
    # bilinear resampling round-trips smooth content: a low-frequency image
    g = torch.linspace(-1, 1, 32)
    gy, gx = torch.meshgrid(g, g, indexing="ij")
    im = torch.stack([torch.sin(2 * gy), torch.cos(2 * gx), gy * gx], -1)
    im = im[None].expand(2, 32, 32, 3)
    tf = T.SpatialTransform(sensitivity=1.0, device="cpu")
    t = torch.tensor([[0.7, 0.05, -0.1], [0.9, 0.0, 0.2]])
    back = tf.invert_transform(tf.transform(im, t), t)
    center = np.s_[:, 10:22, 10:22, :]
    assert float((back[center] - im[center]).abs().mean()) < 0.02


def _mask():
    mask = np.zeros((64, 48, 3), np.float32)
    mask[16:48, 8:40] = 1.0
    mask[20, 9] = 0.5                     # below the binarization threshold
    return mask


@pytest.mark.parametrize("as_tensor", [False, True])
def test_spatial_pre_align_from_mask_matches_jax(as_tensor):
    mask = _mask()
    tf = T.SpatialTransform(
        pre_align=torch.tensor(mask) if as_tensor else mask, device="cpu")
    want = JT.SpatialTransform(pre_align=jnp.asarray(mask)).t
    np.testing.assert_allclose(tf.t, want, rtol=1e-6)
    _close(tf.get_default_param(), want, rtol=1e-6)
    assert tf.t[0] > 0


# --------------------------------------------------------------------- #
# transform/utils                                                         #
# --------------------------------------------------------------------- #

@pytest.mark.parametrize("region", [(4, 20, 8, 28), (0, 0, 0, 0),
                                    (10, 11, 0, 32)])
def test_bbox_and_stats_match_jax(region):
    mask = np.zeros((32, 40, 1), np.float32)
    mask[region[0]:region[1], region[2]:region[3]] = 1.0
    assert TU.bbox_from_mask(mask) == JU.bbox_from_mask(mask)
    assert TU.bbox_from_mask(torch.tensor(mask)) == JU.bbox_from_mask(mask)
    assert TU.compute_stat_from_mask(mask[None]) == \
        JU.compute_stat_from_mask(mask[None])


def test_convert_to_t_and_pre_alignment_match_jax():
    stats = TU.compute_stat_from_mask(_mask())
    assert TU.get_biggan_stats() == JU.get_biggan_stats()
    t = TU.convert_to_t(*stats, *TU.get_biggan_stats())
    assert t.dtype == torch.float32 and t.shape == (3,)
    _close(t, JU.convert_to_t(*stats, *JU.get_biggan_stats()), rtol=1e-6)
    _close(TU.compute_pre_alignment(_mask()),
           JU.compute_pre_alignment(jnp.asarray(_mask())), rtol=1e-6)


@pytest.mark.parametrize("colors", [(), ("hue",), ("brightness", "hue"),
                                    ("contrast", "gamma", "saturation")])
@pytest.mark.parametrize("spatial,align", [(True, False), (False, True),
                                           (False, False)])
def test_setup_transform_fn_matches_jax(spatial, align, colors):
    mask = _mask()[:, :, :1].repeat(3, -1)
    kw = dict(spatial_transform=spatial, align=align, color_transform=colors)
    fn, t = TU.setup_transform_fn(weight=mask, device="cpu", **kw)
    jfn, jt = JU.setup_transform_fn(weight=jnp.asarray(mask), **kw)
    if jfn is None:
        assert fn is None and t is None
        return
    assert [type(f).__name__ for f, _ in fn.transform_list] == \
        [type(f).__name__ for f, _ in jfn.transform_list]
    assert [w for _, w in fn.transform_list] == \
        [w for _, w in jfn.transform_list]
    _close(t, jt, rtol=1e-6)
    n, dim = 2, t.shape[1]
    im = _images(8, (n, 16, 12, 3), -0.9, 0.9)
    delta = t + 0.3 * torch.tensor(
        np.random.RandomState(9).randn(n, dim).astype(np.float32))
    for invert in (False, True):
        _close(fn(torch.tensor(im), delta, invert=invert),
               jfn(jnp.asarray(im), jnp.asarray(delta.numpy()),
                   invert=invert), atol=1e-5)


def test_setup_transform_fn_reads_an_args_namespace():
    import argparse
    args = argparse.Namespace(spatial_transform=True, align=False,
                              color_transform=("gamma",))
    fn, t = TU.setup_transform_fn(args, device="cpu")
    assert [type(f).__name__ for f, _ in fn.transform_list] == \
        ["SpatialTransform", "GammaTransform"]
    assert fn.transform_list[1][1] == 0.2 and t.shape == (1, 4)


# --------------------------------------------------------------------- #
# color                                                                   #
# --------------------------------------------------------------------- #

def _edge_pixels():
    vals = [0.0, 1.0, 0.5, 0.25]
    px = [[a, b, c] for a in vals for b in vals for c in vals]
    px += [[0.3, 0.3, 0.3], [0.7, 0.7, 0.2], [0.2, 0.7, 0.7],
           [0.7, 0.2, 0.7], [1.0, 1.0, 0.0], [1e-7, 0.0, 0.0]]
    return np.asarray(px, np.float32).reshape(1, -1, 1, 3)


@pytest.mark.parametrize("kind", ["random", "edges"])
def test_hsv_round_trip_matches_jax(kind):
    rgb = (_images(10, (2, 9, 7, 3), 0.0, 1.0) if kind == "random"
           else _edge_pixels())
    hsv = TC.rgb_to_hsv(torch.tensor(rgb))
    _close(hsv, JC.rgb_to_hsv(jnp.asarray(rgb)), atol=1e-5)
    _close(TC.hsv_to_rgb(hsv), JC.hsv_to_rgb(jnp.asarray(hsv.numpy())),
           atol=1e-5)
    _close(TC.hsv_to_rgb(hsv), rgb, atol=1e-5)
    assert float(hsv.min()) >= 0.0 and float(hsv.max()) <= 1.0


def test_hue_wraps_as_a_floor_modulo():
    # a negative hue shift wraps to the top of [0, 1): fmod would keep it
    # negative and hsv_to_rgb would pick the wrong sector
    rgb = np.asarray([[[[0.9, 0.2, 0.25]]]], np.float32)
    t = np.full((1, 1), -0.3, np.float32)
    got = T.HueTransform(device="cpu")(torch.tensor(rgb * 2 - 1),
                                       torch.tensor(t))
    want = JT.HueTransform()(jnp.asarray(rgb * 2 - 1), jnp.asarray(t))
    _close(got, want, atol=1e-5)


@pytest.mark.parametrize("name", COLOR_CLASSES)
def test_color_transform_forward_and_inverse_match_jax(name):
    im = _images(11, (2, 9, 7, 3), -0.9, 0.9)
    t = np.array([[COLOR_T[name]], [COLOR_T[name] * 0.9]], np.float32)
    tf, jtf = getattr(T, name)(device="cpu"), getattr(JT, name)()
    assert (tf.t_min, tf.t_max) == (jtf.t_min, jtf.t_max)
    for invert in (False, True):
        _close(tf(torch.tensor(im), torch.tensor(t), invert=invert),
               jtf(jnp.asarray(im), jnp.asarray(t), invert=invert),
               atol=1e-5)
    # the identity parameter leaves the image
    ident = np.broadcast_to(tf.get_identity_param(as_tensor=False),
                            (2, 1)).copy()
    _close(tf(torch.tensor(im), torch.tensor(ident)), im, atol=1e-5)


@pytest.mark.parametrize("name", COLOR_CLASSES)
def test_color_transform_gradients_match_jax(name):
    im = _images(12, (2, 9, 7, 3), -0.9, 0.9)
    t0 = np.array([[COLOR_T[name]], [COLOR_T[name] * 0.9]], np.float32)
    w = np.random.RandomState(13).randn(*im.shape).astype(np.float32)
    jtf, tf = getattr(JT, name)(), getattr(T, name)(device="cpu")

    def jf(ims, t):
        return jnp.sum(jtf(ims, t) * w)

    want_im, want_t = jax.grad(jf, argnums=(0, 1))(jnp.asarray(im),
                                                   jnp.asarray(t0))
    ims = torch.tensor(im, requires_grad=True)
    t = torch.tensor(t0, requires_grad=True)
    (tf(ims, t) * torch.tensor(w)).sum().backward()
    assert np.abs(np.asarray(want_t)).min() > 0    # away from the rails
    np.testing.assert_allclose(t.grad.numpy(), np.asarray(want_t),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(ims.grad.numpy(), np.asarray(want_im),
                               rtol=1e-4, atol=1e-4)


def test_color_transform_clamps_to_its_range():
    im = torch.tensor(_images(14, (1, 8, 8, 3), -0.5, 0.5))
    tf = T.BrightnessTransform(t_min=0.8, t_max=1.2, device="cpu")
    _close(tf(im, torch.full((1, 1), 99.0)),
           tf(im, torch.full((1, 1), 1.2)).numpy(), atol=0)


# --------------------------------------------------------------------- #
# compose                                                                 #
# --------------------------------------------------------------------- #

def _compose_pair():
    return (TU.setup_transform_fn(spatial_transform=True,
                                  color_transform=("hue", "brightness"),
                                  device="cpu")[0],
            JU.setup_transform_fn(spatial_transform=True,
                                  color_transform=("hue", "brightness"))[0])


@pytest.mark.parametrize("only_spatial", [False, True])
@pytest.mark.parametrize("rows", [1, 3])
def test_compose_matches_jax(rows, only_spatial):
    fn, jfn = _compose_pair()
    im = _images(15, (3, 12, 10, 3), -0.9, 0.9)
    t = np.random.RandomState(16).randn(rows, 5).astype(np.float32)
    for invert in (False, True):
        _close(fn(torch.tensor(im), torch.tensor(t), invert=invert,
                  only_spatial=only_spatial),
               jfn(jnp.asarray(im), jnp.asarray(t), invert=invert,
                   only_spatial=only_spatial), atol=1e-5)
    assert fn.get_opt_param().tolist() == jfn.get_opt_param().tolist()
    _close(fn.get_identity_param(), jfn.get_identity_param(), atol=0)
    _close(fn.get_default_param(), jfn.get_default_param(), atol=0)


def test_search_identity_is_the_identity():
    fn, jfn = _compose_pair()
    ident = fn.get_search_identity(as_tensor=True)
    np.testing.assert_array_equal(ident.numpy(), jfn.get_search_identity())
    np.testing.assert_array_equal(ident.numpy(), [0, 0, 0, 0, 1])
    ims = torch.tensor(_images(17, (2, 12, 12, 3)))
    _close(fn(ims, ident[None].expand(2, 5)), ims.numpy(), rtol=1e-4,
           atol=1e-4)
    assert float((fn(ims, torch.zeros(2, 5)) - ims).abs().max()) > 0.1


def test_spatial_only_keeps_a_mask_binary():
    fn, _ = _compose_pair()
    mask = torch.ones(1, 16, 16, 3)
    # a shift of two whole pixels (0.1 * 2.5 of the half-width) and a
    # brightness of 1.2 (0.2 * (2 - 1) + 1)
    t = torch.tensor([[0.0, 2.5, 0.0, 0.0, 2.0]])
    got = T.SpatialOnly(fn)(mask, t)
    want = T.SpatialTransform(sensitivity=0.1, device="cpu")(mask, t[:, :3])
    _close(got, want.numpy(), atol=1e-6)
    assert set(np.unique(np.round(got.numpy(), 5))) == {0.0, 1.0}
    assert float((fn(mask, t) - want).abs().max()) > 0.05


def test_compose_rejects_transforms_on_two_devices():
    a = T.SpatialTransform(device="cpu")
    b = T.HueTransform(device="cpu")
    b.device = torch.device("meta")
    with pytest.raises(ValueError, match="several devices"):
        T.ComposeTransform([a, b])


def test_transform_package_exports_jax_names():
    assert T.__all__ == JT.__all__


# --------------------------------------------------------------------- #
# invertibility_loss                                                      #
# --------------------------------------------------------------------- #

@pytest.mark.parametrize("rows,masked", [(1, False), (3, False), (3, True)])
def test_invertibility_loss_matches_jax(rows, masked):
    im = _images(18, (rows, 16, 12, 3))
    t = T_ROWS
    mask = (np.random.RandomState(19).rand(3, 16, 12, 3) > 0.3).astype(
        np.float32) if masked else None
    tf = T.SpatialTransform(sensitivity=1.0, device="cpu")
    jtf = JT.SpatialTransform(sensitivity=1.0)
    got = LF.invertibility_loss(torch.tensor(im), tf, torch.tensor(t),
                                None if mask is None else torch.tensor(mask))
    want = JLF.invertibility_loss(jnp.asarray(im), jtf, jnp.asarray(t),
                                  None if mask is None else jnp.asarray(mask))
    assert got.shape == (3,)
    _close(got, want, rtol=1e-5, atol=1e-7)
    assert float(got.min()) > 0
