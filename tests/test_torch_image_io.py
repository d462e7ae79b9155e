"""The port's image and video IO (``utils/image.py``, ``utils/png.py``,
``utils/video.py``, ``native``) against the JAX package's and PIL, on
numpy-seeded images:

- ``read`` (both transform styles, at the target size and resized),
  ``to_tensor``, ``to_mask`` and ``center_crop_to`` give the JAX package's
  arrays bitwise;
- the PNG codec reads what PIL reads and writes what PIL reads back, bitwise,
  for 8-bit gray, RGB and RGBA, and decodes each of the five scanline
  filters;
- ``seamless_clone`` (the port's build of the same C++ source with the same
  flags) gives the JAX package's native output bitwise, and ``poisson_blend``
  the JAX package's;
- ``make_video`` and ``make_gif`` write files that read back.
"""

import struct
import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from pix2latent_tpu.utils import image as jax_image
from pix2latent_tpu_torch import native
from pix2latent_tpu_torch.utils import image, png, video


def _photo(h, w, seed=0, channels=3):
    """A smooth image with noise (so PNG filters other than None win)."""
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    base = np.stack([(xx * 255 // max(w - 1, 1)), (yy * 255 // max(h - 1, 1)),
                     ((xx + yy) * 127 // max(h + w - 2, 1))], -1)
    im = np.clip(base + rng.randint(-8, 9, (h, w, 3)), 0, 255)
    if channels == 4:
        im = np.concatenate([im, rng.randint(0, 256, (h, w, 1))], -1)
    return im.astype(np.uint8)


@pytest.mark.parametrize("style", ["biggan", "stylegan2"])
@pytest.mark.parametrize("size", [(64, 64), (48, 80), (90, 60)])
def test_read_matches_jax(tmp_path, style, size):
    path = str(tmp_path / "im.png")
    Image.fromarray(_photo(*size, seed=size[0])).save(path)
    want = np.asarray(jax_image.read(path, im_size=64, transform_style=style))
    got = image.read(path, im_size=64, transform_style=style, device="cpu")
    assert got.dtype == torch.float32 and got.device.type == "cpu"
    np.testing.assert_array_equal(got.numpy(), want)        # bitwise
    raw = image.read(path, as_transformed_tensor=False)
    np.testing.assert_array_equal(
        raw, jax_image.read(path, as_transformed_tensor=False))


def test_read_at_the_target_size_needs_no_pil(tmp_path, monkeypatch):
    path = str(tmp_path / "im.png")
    image.save(path, _photo(32, 32))

    def no_pil():
        raise ImportError("this image format or a resize needs PIL")
    monkeypatch.setattr(image, "_pil", no_pil)
    got = image.read(path, im_size=32, device="cpu")
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jax_image.read(path, im_size=32)))
    with pytest.raises(ImportError, match="PIL"):
        image.read(path, im_size=16, device="cpu")
    with pytest.raises(ImportError, match="PIL"):
        image.save(str(tmp_path / "x.jpg"), _photo(8, 8))


def test_to_tensor_to_mask_center_crop_match_jax(tmp_path):
    im = _photo(40, 50, seed=3)
    path = str(tmp_path / "im.png")
    Image.fromarray(im).save(path)
    for src in (im, path, im.astype(np.float32) / 255.0):
        np.testing.assert_array_equal(
            image.to_tensor(src, device="cpu").numpy(),
            np.asarray(jax_image.to_tensor(src)))
    rgb_mask = str(tmp_path / "mask_rgb.png")
    gray_mask = str(tmp_path / "mask_gray.png")
    Image.fromarray(im).save(rgb_mask)                # RGB -> L by luma
    Image.fromarray(im[..., 1]).save(gray_mask)
    for src in (rgb_mask, gray_mask, (im[..., 0] > 100).astype(np.float32)):
        got = image.to_mask(src, device="cpu")
        np.testing.assert_array_equal(got.numpy(),
                                      np.asarray(jax_image.to_mask(src)))
    for size in (16, 40, 64):
        np.testing.assert_array_equal(image.center_crop_to(im, size),
                                      jax_image.center_crop_to(im, size))


@pytest.mark.parametrize("mode,shape", [("L", (23, 31)), ("RGB", (23, 31, 3)),
                                        ("RGBA", (23, 31, 4))])
def test_png_codec_is_bitwise_pil(tmp_path, mode, shape):
    im = _photo(23, 31, seed=5, channels=4 if mode == "RGBA" else 3)
    im = im[..., 0] if mode == "L" else im
    assert im.shape == shape
    # PIL writes (adaptive filters), the codec reads
    a = str(tmp_path / "pil.png")
    Image.fromarray(im, mode).save(a)
    np.testing.assert_array_equal(png.read_png(a), np.asarray(Image.open(a)))
    np.testing.assert_array_equal(png.read_png(a), im)
    # the codec writes, PIL reads
    b = str(tmp_path / "port.png")
    png.write_png(b, im)
    back = Image.open(b)
    assert back.mode == mode
    np.testing.assert_array_equal(np.asarray(back), im)


def _filtered_png(path, im, kind):
    """Write RGB ``im`` with every scanline filtered by ``kind`` (PNG
    specification, section 9)."""
    h, w, bpp = im.shape
    rows = im.reshape(h, w * bpp).astype(np.int64)
    out = []
    for y in range(h):
        cur = rows[y]
        up = rows[y - 1] if y else np.zeros_like(cur)
        left = np.concatenate([np.zeros(bpp, np.int64), cur[:-bpp]])
        ul = np.concatenate([np.zeros(bpp, np.int64), up[:-bpp]])
        if kind == 0:
            pred = 0
        elif kind == 1:
            pred = left
        elif kind == 2:
            pred = up
        elif kind == 3:
            pred = (left + up) // 2
        else:
            p = left + up - ul
            pa, pb, pc = abs(p - left), abs(p - up), abs(p - ul)
            pred = np.where((pa <= pb) & (pa <= pc), left,
                            np.where(pb <= pc, up, ul))
        out.append(bytes([kind]) + ((cur - pred) % 256).astype(
            np.uint8).tobytes())

    def chunk(k, body):
        return (struct.pack(">I", len(body)) + k + body
                + struct.pack(">I", zlib.crc32(k + body) & 0xFFFFFFFF))
    with open(path, "wb") as f:
        f.write(png.SIGNATURE
                + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
                + chunk(b"IDAT", zlib.compress(b"".join(out)))
                + chunk(b"IEND", b""))


@pytest.mark.parametrize("kind", [0, 1, 2, 3, 4])
def test_png_codec_decodes_every_filter(tmp_path, kind):
    im = _photo(9, 13, seed=kind)
    path = str(tmp_path / f"f{kind}.png")
    _filtered_png(path, im, kind)
    np.testing.assert_array_equal(np.asarray(Image.open(path)), im)
    np.testing.assert_array_equal(png.read_png(path), im)


def _clone_inputs(seed=0, h=48, w=64):
    rng = np.random.RandomState(seed)
    src = _photo(h, w, seed=seed)
    dst = np.clip(_photo(h, w, seed=seed + 1)[::-1] + 0, 0, 255).astype(
        np.uint8)
    mask = np.zeros((h, w), np.uint8)
    mask[10:30, 15:45] = 255
    mask[12:16, 20:24] = 0
    return src, dst, mask, rng


def test_seamless_clone_is_bitwise_the_jax_packages():
    from pix2latent_tpu.native import seamless_clone as jax_clone
    src, dst, mask, _ = _clone_inputs()
    for center in ((30, 20), (36, 24)):
        got = native.seamless_clone(src, dst, mask, center)
        np.testing.assert_array_equal(got, jax_clone(src, dst, mask, center))
    assert native.library_path().parent.name == "_build"


def test_poisson_blend_matches_jax():
    src, dst, mask, _ = _clone_inputs(seed=4)
    target = dst.astype(np.float32) / 255.0
    generated = src.astype(np.float32) / 255.0
    m = (mask > 0).astype(np.float32)
    got = image.poisson_blend(target, m, generated)
    want = jax_image.poisson_blend(target, m, generated)
    np.testing.assert_array_equal(got, want)
    got3 = image.poisson_blend(torch.tensor(target), m[..., None] * 255.0,
                               torch.tensor(generated))
    np.testing.assert_array_equal(got3, want)


def test_make_video_and_gif_write_readable_files(tmp_path):
    frames = [(_photo(32, 48, seed=i).astype(np.float32) / 127.5 - 1.0)
              for i in range(4)]
    path = video.make_video(str(tmp_path / "out.mp4"), frames, fps=5)
    import cv2
    cap = cv2.VideoCapture(path)
    n = 0
    while True:
        ok, frame = cap.read()
        if not ok:
            break
        assert frame.shape == (32, 48, 3)
        n += 1
    cap.release()
    assert n == 4
    gif = video.make_gif(str(tmp_path / "out.gif"), frames, duration=0.2)
    with Image.open(gif) as g:
        assert g.n_frames == 4 and g.size == (48, 32)


def test_save_writes_pngs_and_collages(tmp_path):
    batch = np.stack([_photo(8, 8, seed=i) for i in range(3)]).astype(
        np.float32) / 127.5 - 1.0
    path = str(tmp_path / "grid.png")
    image.save(path, batch)
    want = jax_image.to_image(jax_image.to_grid(batch))
    np.testing.assert_array_equal(png.read_png(path), want)
    image.save(str(tmp_path / "grid.jpg"), jnp.asarray(batch[0]))
