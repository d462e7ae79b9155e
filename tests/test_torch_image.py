"""The port's collage helpers (``utils/image.py``) and console helpers
(``utils/misc.py``) against the JAX package's: ``to_grid``, ``to_image``,
``center_crop`` and ``binarize`` exactly; ``smart_resize`` within one uint8
level of the JAX package's (cv2's ``INTER_AREA`` / ``INTER_LINEAR``) at the
integer factors the logs use."""

import numpy as np
import pytest
import torch

from pix2latent_tpu.utils import image as JI
from pix2latent_tpu.utils import misc as JM
from pix2latent_tpu_torch.utils import image as TI
from pix2latent_tpu_torch.utils import misc as TM


@pytest.mark.parametrize("n", [1, 4, 7, 22])
def test_to_grid_and_to_image_match_jax(n):
    x = np.random.RandomState(n).uniform(-1.2, 1.2, (n, 9, 11, 3)).astype(
        np.float32)
    want = np.asarray(JI.to_grid(x))
    got = TI.to_grid(torch.tensor(x))
    assert got.shape == want.shape and got.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(TI.to_image(got), np.asarray(JI.to_image(want)))
    np.testing.assert_array_equal(
        TI.to_image(got, jpg_format=False),
        np.asarray(JI.to_image(want, jpg_format=False)))


@pytest.mark.parametrize("shape", [(12, 8, 3), (8, 12, 3), (5, 5)])
def test_center_crop_and_binarize_match_jax(shape):
    x = np.random.RandomState(1).rand(*shape).astype(np.float32)
    np.testing.assert_array_equal(TI.center_crop(x), JI.center_crop(x))
    x[x > 0.5] = 1.0
    np.testing.assert_array_equal(TI.binarize(x), np.asarray(JI.binarize(x)))
    t = TI.binarize(torch.tensor(x))
    assert isinstance(t, torch.Tensor)
    np.testing.assert_array_equal(t.numpy(), np.asarray(JI.binarize(x)))


@pytest.mark.parametrize("size,target", [((5132, 5132), (1283, 1283)),
                                         ((64, 96), (16, 24)),
                                         ((16, 24), (32, 48)),
                                         ((20, 20), (50, 50))])
def test_smart_resize_matches_jax_within_one_level(size, target):
    rng = np.random.RandomState(2)
    # a smooth image with noise, as a collage of generated images is
    yy, xx = np.mgrid[0:size[0], 0:size[1]] / max(size)
    base = np.stack([xx, yy, 0.5 * (xx + yy)], -1) * 200.0 + 20.0
    im = np.clip(base + rng.randn(*base.shape) * 10.0, 0, 255).astype(np.uint8)
    want = np.asarray(JI.smart_resize(im, target))
    got = TI.smart_resize(im, target)
    assert got.shape == want.shape == (*target, 3) and got.dtype == np.uint8
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1


def test_color_helpers_and_progress_match_jax(capsys):
    for s, c in (("hi", "g"), ("hi", "unknown"), (3, "r")):
        assert TM.color_str(s, c) == JM.color_str(s, c)
    for loss in (0.005, 0.05, 0.2, 0.35, 0.7):
        assert TM.color_loss(loss) == JM.color_loss(loss)
        assert TM.loss_to_color(loss) == JM.loss_to_color(loss)
    JM.progress_print("optimize", 50, 1200, "c", 0.25)
    want = capsys.readouterr().out
    TM.progress_print("optimize", 50, 1200, "c", 0.25)
    assert capsys.readouterr().out == want
    assert isinstance(TM.to_numpy(torch.ones(2, requires_grad=True)),
                      np.ndarray)
