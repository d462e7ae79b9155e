"""The port's three entry points on real inputs (``--fp``, ``--mask_fp``,
``--make_video``, ``--checkpoint``) on the CPU, at smaller sizes than
``tests/test_torch_examples.py``'s (BigGAN-deep with a 32 px layout of six
blocks and 4 channels a layer, FFHQ at 32 px with 8): each runs on a PNG
target with
a PNG mask and writes the result bundle (``out.jpg``, ``best.jpg``,
``out.mp4``, ``vars.npy``, ``losses.npy``, ``result.npz``) with the target
read as ``utils/image.read`` reads it; BigGAN's loader takes a
``pytorch_pretrained_biggan`` ``.pth`` (spectral norm as ``weight_orig`` /
``weight_u``) and its conversion by the port's CLI to the same weights, and
raises ``ValueError`` on other files."""

import argparse
import os
import warnings

import numpy as np
import pytest
import torch

from pix2latent_tpu_torch.examples import common
from pix2latent_tpu_torch.examples import invert_biggan_basincma as bg
from pix2latent_tpu_torch.examples import \
    invert_biggan_with_transform as tf_ex
from pix2latent_tpu_torch.examples import \
    invert_stylegan2_ffhq_basincma as ffhq
from pix2latent_tpu_torch.models import biggan as B
from pix2latent_tpu_torch.models import stylegan2 as S
from tests.test_torch_examples import one_thread, tiny_biggan  # noqa: F401

# BigGAN-deep cut to 32 px: three upsampling blocks, attention at 16 x 16
SMALL_BIGGAN = dict(output_dim=32,
                    layers=[(False, 16, 16), (True, 16, 8), (False, 8, 4),
                            (True, 4, 2), (False, 2, 2), (True, 2, 1)],
                    attention_position=4)


@pytest.fixture
def small_biggan(monkeypatch):
    """The entry points' BigGAN-deep-256 as the 32 px layout with 4
    channels a layer."""
    class SmallBigGAN(B.BigGAN):
        def __init__(self, *args, **kwargs):
            kwargs.setdefault("channel_width", 4)
            super().__init__(*args, **kwargs)

    monkeypatch.setattr(B, "BigGAN", SmallBigGAN)
    monkeypatch.setitem(B.BIGGAN_CONFIGS, "biggan-deep-256", SMALL_BIGGAN)


@pytest.fixture
def small_ffhq(monkeypatch):
    monkeypatch.setitem(S.StyleGAN2.MODELS, "ffhq", 32)
    monkeypatch.setattr(S, "channels_for", lambda res, cm=2: 8)


def _png(path, im_res, seed=0, mask=False):
    """A PNG of ``im_res`` x ``im_res`` pixels (noise, or a box mask)."""
    from pix2latent_tpu_torch.utils import image
    rng = np.random.RandomState(seed)
    if mask:
        m = np.zeros((im_res, im_res, 3), np.uint8)
        m[im_res // 4:3 * im_res // 4, im_res // 8:im_res // 2] = 255
        im = m
    else:
        im = rng.randint(0, 256, (im_res, im_res, 3)).astype(np.uint8)
    image.save(str(path), im)
    return str(path)


def _assert_codec_outputs(save_dir, frames):
    from PIL import Image
    for name in ("out.jpg", "best.jpg"):
        assert Image.open(save_dir / name).size[0] > 0, name
    assert os.path.getsize(save_dir / "out.mp4") > 0
    assert (save_dir / "vars.npy").exists() and (save_dir /
                                                 "losses.npy").exists()
    losses = np.load(save_dir / "losses.npy", allow_pickle=True)
    assert len(losses) == frames


def test_ffhq_image_mask_and_video_options(small_ffhq, tmp_path):
    # a target of another size: padded to a square, resized by PIL
    fp = _png(tmp_path / "t.png", 48, seed=1)
    mask = _png(tmp_path / "m.png", 64, mask=True)
    save = tmp_path / "out"
    ffhq.main(["--device", "cpu", "--smoke", "--no_recipe", "--fp", fp,
               "--mask_fp", mask, "--make_video", "--save_dir", str(save)])
    result = dict(np.load(save / "result.npz"))
    target = result["variables/output/target"]
    from pix2latent_tpu_torch.utils import image
    want = image.read(fp, im_size=32, transform_style="stylegan2",
                      device="cpu").numpy()
    np.testing.assert_array_equal(target[0], want)
    weight = result["variables/output/weight"][0]
    assert weight.min() == pytest.approx(0.3) and weight.max() == 1.0
    # logged every 5 steps: (2 x 4 + 8) / ... runs of at most 5 steps
    _assert_codec_outputs(save, frames=2 * 1 + 2)


def _tiny_biggan_weights(tmp_path):
    """A pytorch_pretrained_biggan state dict of the tiny layout (SN
    layers as weight_orig / weight_u), saved as .pth, and its conversion
    by the port's CLI."""
    from pix2latent_tpu_torch.scripts import convert
    from tests.test_biggan_golden import make_state_dict
    from tests.test_torch_convert import _with_sn
    sd = _with_sn(make_state_dict(np.random.RandomState(0),
                                  "biggan-deep-128", 4))
    pth = tmp_path / "biggan.pth"
    torch.save(sd, pth)
    npz = tmp_path / "biggan.npz"
    convert.main(["biggan", str(pth), str(npz), "--model", "biggan-deep-256"])
    return pth, npz


@pytest.mark.parametrize("suffix", [".pth", ".npz"])
def test_biggan_checkpoint_torch_or_converted(tiny_biggan, tmp_path, suffix):
    pth, npz = _tiny_biggan_weights(tmp_path)
    path = pth if suffix == ".pth" else npz
    other = npz if suffix == ".pth" else pth
    # the entry point's loader takes either file, to the same weights
    got = common.load_biggan(argparse.Namespace(
        checkpoint=str(path), device="cpu")).state_dict()
    want = common.load_biggan(argparse.Namespace(
        checkpoint=str(other), device="cpu")).state_dict()
    assert sorted(got) == sorted(want)
    assert all(torch.equal(got[k], want[k]) for k in got)
    # and not the random init
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        rand = B.BigGAN("biggan-deep-256", device="cpu").state_dict()
    assert not torch.equal(got["generator.gen_z.weight"],
                           rand["generator.gen_z.weight"])


@pytest.mark.parametrize("name,match", [("weights.npz", "not a .npz"),
                                        ("weights.bin", ".pt / .pth")])
def test_biggan_checkpoint_of_another_kind_raises(tiny_biggan, tmp_path,
                                                  name, match):
    path = tmp_path / name
    path.write_bytes(b"not a zip archive")
    with pytest.raises(ValueError, match=match):
        bg.main(["--device", "cpu", "--smoke", "--checkpoint", str(path)])


def test_biggan_image_mask_and_video_options(small_biggan, tmp_path):
    # a target at the model's size: read without PIL's resize
    fp = _png(tmp_path / "t.png", 32, seed=2)
    mask = _png(tmp_path / "m.png", 32, mask=True)
    save = tmp_path / "out"
    bg.main(["--device", "cpu", "--smoke", "--fp", fp, "--mask_fp", mask,
             "--make_video", "--save_dir", str(save)])
    result = dict(np.load(save / "result.npz"))
    from pix2latent_tpu_torch.utils import image
    want = image.read(fp, im_size=32, device="cpu").numpy()
    np.testing.assert_array_equal(result["variables/output/target"][0], want)
    assert np.isfinite(result["loss"]).all()
    # logged runs of 5 steps: 2 generations of 5, then 10 final steps
    _assert_codec_outputs(save, frames=2 + 2)


def test_transform_example_image_mask_and_video_options(small_biggan,
                                                       tmp_path):
    fp = _png(tmp_path / "t.png", 32, seed=3)
    mask = _png(tmp_path / "m.png", 32, mask=True)
    save = tmp_path / "out"
    tf_ex.main(["--device", "cpu", "--smoke", "--method", "adam", "--fp", fp,
                "--mask_fp", mask, "--make_video", "--save_dir", str(save)])
    result = dict(np.load(save / "result.npz"))
    # the mask pre-aligned the search: t = pre-alignment + 0.1 delta
    from pix2latent_tpu_torch.transform.utils import compute_pre_alignment
    from pix2latent_tpu_torch.utils import image
    weight = image.read(mask, im_size=32, device="cpu")
    pre = np.asarray(compute_pre_alignment(
        image.binarize(torch.clamp((weight + 1) / 2, 0.3, 1.0))))
    assert not np.allclose(pre, [1.0, 0.0, 0.0])
    assert np.isfinite(result["loss"]).all()
    # phase 2 Adam: 20 steps logged by runs of 5
    _assert_codec_outputs(save, frames=4)
