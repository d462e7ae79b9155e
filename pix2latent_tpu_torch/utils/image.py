"""Host-side image IO and formatting (counterpart of
``pix2latent_tpu/utils/image.py``): ``read``, ``save``, ``to_tensor``,
``to_mask``, ``center_crop_to``, ``poisson_blend``, and the collage helpers
``to_grid``, ``to_image``, ``center_crop``, ``binarize``, ``smart_resize``.

Images are NHWC (``[N, H, W, C]``) or HWC, float in [-1, 1], as numpy arrays
or tensors on any device (tensors are read to the host first); ``read``,
``to_tensor`` and ``to_mask`` return tensors on the device asked for.

PNG is read and written by the port's own codec (``utils/png.py``), with no
imaging library. Other formats (JPEG for ``save``'s ``.jpg``), and resizing
an image that is not already at the size asked for, use PIL, imported when
needed: without it they raise ``ImportError``. ``poisson_blend`` runs the
native C++ solver (``pix2latent_tpu_torch.native``) and, where that cannot
be built, ``cv2.seamlessClone``.
"""

from __future__ import annotations

import math
import os

import numpy as np
import torch
import torch.nn.functional as F

from pix2latent_tpu_torch.utils import png
from pix2latent_tpu_torch.utils.device import resolve_device
from pix2latent_tpu_torch.utils.misc import to_numpy


def _pil():
    try:
        from PIL import Image
    except ImportError as e:
        raise ImportError("this image format or a resize needs PIL "
                          "(Pillow); PNG at the target size does not") from e
    return Image


def _load(path, mode):
    """The pixels of an image file as PIL's ``convert(mode)`` gives them,
    uint8: ``mode`` "RGB" ``[H, W, 3]`` or "L" ``[H, W]``. PNGs this
    package's codec reads need no PIL."""
    if png.is_png(path):
        try:
            im = png.read_png(path)
        except png.UnsupportedPNG:
            im = None
        if im is not None:
            return _convert(im, mode)
    return np.array(_pil().open(path).convert(mode))


def _convert(im, mode):
    """PIL's ``convert`` of decoded pixels: alpha dropped, gray replicated
    to RGB, RGB to gray by ITU-R 601-2 luma in PIL's integer arithmetic."""
    if im.ndim == 3 and im.shape[2] in (2, 4):
        im = im[..., :-1]
    if im.ndim == 3 and im.shape[2] == 1:
        im = im[..., 0]
    if mode == "RGB":
        return np.repeat(im[..., None], 3, axis=2) if im.ndim == 2 else im
    if im.ndim == 2:
        return im
    rgb = im.astype(np.uint32)
    luma = rgb[..., 0] * 19595 + rgb[..., 1] * 38470 + rgb[..., 2] * 7471
    return ((luma + 0x8000) >> 16).astype(np.uint8)


def _resize_np(im, size_hw, smooth=True):
    """uint8 HWC resize by PIL (bilinear, or nearest without ``smooth``);
    an image already at ``size_hw`` is returned as it is, which is what
    PIL's resize to the same size gives."""
    im = im.astype(np.uint8)
    if tuple(im.shape[:2]) == tuple(size_hw):
        return im
    Image = _pil()
    resample = Image.BILINEAR if smooth else Image.NEAREST
    return np.asarray(Image.fromarray(im).resize((size_hw[1], size_hw[0]),
                                                 resample))


def read(im_path, as_transformed_tensor=True, im_size=256,
         transform_style=None, device="cuda"):
    """Read an image as an ``[H, W, 3]`` float32 tensor in [-1, 1] on
    ``device``.

    ``transform_style='biggan'`` (or None) resizes the short side to
    ``im_size`` and center-crops; ``'stylegan'`` / ``'stylegan2'`` pads to a
    square and resizes. Without ``as_transformed_tensor``, the uint8 RGB
    pixels as they are in the file (numpy)."""
    im = _load(im_path, "RGB")
    if im.max() <= 1.0 + 1e-6:
        im = (im * 255).astype(np.uint8)
    h, w = im.shape[:2]

    if not as_transformed_tensor:
        return im

    if transform_style in ("stylegan", "stylegan2"):
        if h < w:
            pt, pb = (w - h) // 2, (w - h) - (w - h) // 2
            pl = pr = 0
        else:
            pl, pr = (h - w) // 2, (h - w) - (h - w) // 2
            pt = pb = 0
        im = np.pad(im, ((pt, pb), (pl, pr), (0, 0)))
        im = _resize_np(im, (im_size, im_size))
    elif transform_style in (None, "biggan"):
        scale = im_size / min(h, w)
        nh, nw = int(round(h * scale)), int(round(w * scale))
        im = _resize_np(im, (nh, nw))
        im = center_crop_to(im, im_size)
    else:
        raise ValueError(f"unknown transformation style {transform_style}")

    im = im.astype(np.float32) / 255.0
    return torch.as_tensor(2.0 * im - 1.0).to(resolve_device(device))


def center_crop_to(im, size):
    """The centered ``size`` x ``size`` crop of an ``[H, W, ...]`` image."""
    h, w = im.shape[:2]
    top = max((h - size) // 2, 0)
    left = max((w - size) // 2, 0)
    return im[top:top + size, left:left + size]


def save(save_path, im, quality=100):
    """Save an image (``[-1, 1]`` float HWC, an NHWC batch as its collage,
    or uint8): PNG by the port's codec, other formats by PIL."""
    im = to_numpy(im)
    if im.ndim == 4:
        im = to_grid(im)
    if im.dtype != np.uint8:
        im = to_image(im)
    if str(save_path).lower().endswith(".png"):
        png.write_png(save_path, im)
        return
    _pil().fromarray(im).save(save_path, quality=quality)


def to_tensor(im, device="cuda"):
    """A path or uint8 / float HWC image as ``[1, H, W, 3]`` float32 in
    [-1, 1] on ``device`` (values above 1 are taken as 0..255)."""
    if isinstance(im, str):
        im = _load(im, "RGB")
    im = np.asarray(to_numpy(im), np.float32)
    if im.max() > 1.0:
        im = im / 255.0
    return torch.as_tensor(2.0 * (im - 0.5))[None].to(resolve_device(device))


def to_mask(mask, device="cuda"):
    """A path or array as a binary ``[1, H, W, 1]`` float32 mask in {0, 1}
    on ``device`` (a file: gray above one half)."""
    if isinstance(mask, str):
        if not os.path.exists(mask):
            raise FileNotFoundError(mask)
        m = _load(mask, "L").astype(np.float32) / 255.0
        mask = (m > 0.5).astype(np.float32)[..., None]
    mask = np.asarray(to_numpy(mask), np.float32)
    if mask.max() > 1.0 or mask.min() < 0.0:
        raise ValueError("a mask's values must lie in [0, 1]")
    if mask.ndim == 2:
        mask = mask[..., None]
    return torch.as_tensor(np.clip(mask, 0.0, 1.0))[None].to(
        resolve_device(device))


def to_grid(x, pad_value=-1.0):
    """Collage a batch ``[N, H, W, C]`` into one image: rows of
    ``ceil(sqrt(N))`` tiles with 2-pixel borders of ``pad_value``."""
    x = to_numpy(x)
    n, h, w, c = x.shape
    cols = int(math.ceil(math.sqrt(n)))
    rows = int(math.ceil(n / cols))
    pad = 2
    grid = np.full((rows * (h + pad) + pad, cols * (w + pad) + pad, c),
                   pad_value, x.dtype)
    for i in range(n):
        r, cc = divmod(i, cols)
        top = r * (h + pad) + pad
        left = cc * (w + pad) + pad
        grid[top:top + h, left:left + w] = x[i]
    return grid


def to_image(output, denormalize=True, jpg_format=True):
    """[-1, 1] float image(s) -> uint8 in [0, 255] (``jpg_format``), or
    float in [0, 1] without it."""
    x = np.asarray(to_numpy(output), np.float32)
    if denormalize:
        x = (x + 1.0) / 2.0
    if jpg_format:
        x = np.clip(x * 255.0, 0, 255).astype(np.uint8)
    return x


def binarize(mask, min=0.0, max=1.0, eps=1e-3):
    """Continuous mask -> {0, 1} float32 (values above ``1 - eps`` are 1),
    clipped to ``[min, max]``; a tensor stays a tensor on its device."""
    if isinstance(mask, torch.Tensor):
        return (mask > 1.0 - eps).float().clamp(min, max)
    out = (np.asarray(mask) > 1.0 - eps).astype(np.float32)
    return np.clip(out, min, max)


def center_crop(image):
    """Square center crop along the longer of the first two axes."""
    h, w = image.shape[:2]
    if h > w:
        st = (h - w) // 2
        out = image[st:st + w]
    else:
        st = (w - h) // 2
        out = image[:, st:st + h]
    if out.shape[0] != out.shape[1]:
        raise ValueError(f"center_crop: got {tuple(out.shape)}")
    return out


def smart_resize(im, target_size=(256, 256)):
    """Resize an HWC image to ``target_size`` (h, w) on the host: area
    averaging when the image shrinks (``F.interpolate(mode="area")``, the
    block mean at integer factors, as cv2's ``INTER_AREA``), bilinear with
    half-pixel centers when it grows (cv2's ``INTER_LINEAR``). A uint8 image
    is rounded back to uint8."""
    im = to_numpy(im)
    th, tw = int(target_size[0]), int(target_size[1])
    x = torch.as_tensor(np.asarray(im, np.float32))
    squeeze = x.dim() == 2
    if squeeze:
        x = x[..., None]
    x = x.permute(2, 0, 1)[None]
    if np.prod(im.shape[:2]) >= th * tw:
        y = F.interpolate(x, size=(th, tw), mode="area")
    else:
        y = F.interpolate(x, size=(th, tw), mode="bilinear",
                          align_corners=False)
    y = y[0].permute(1, 2, 0)
    if squeeze:
        y = y[..., 0]
    y = y.numpy()
    if im.dtype == np.uint8:
        return np.clip(np.rint(y), 0, 255).astype(np.uint8)
    return y.astype(im.dtype)


def poisson_blend(target, mask, generated):
    """Composite the generated object into the original frame, seamlessly:
    ``target`` and ``generated`` ``[H, W, 3]`` in [0, 1] or [0, 255];
    ``mask`` ``[H, W]`` or ``[H, W, C]`` in [0, 1] or [0, 255].
    The region is the mask's, moved to the mask's bounding-box center.
    Returns uint8 ``[H, W, 3]``. The native solver runs unless it cannot be
    built; then ``cv2.seamlessClone``, and without cv2 ``RuntimeError``."""
    from pix2latent_tpu_torch.transform.utils import compute_stat_from_mask

    target = np.asarray(to_numpy(target), np.float32)
    generated = np.asarray(to_numpy(generated), np.float32)
    mask = np.asarray(to_numpy(mask), np.float32)
    if target.max() <= 1.0:
        target = target * 255.0
    if generated.max() <= 1.0:
        generated = generated * 255.0
    if mask.max() > 1.0:
        mask = mask / 255.0

    m3 = mask if mask.ndim == 3 else mask[..., None]
    obj_center, _ = compute_stat_from_mask((m3 > 0.5).astype(np.float32))
    center_xy = (int(obj_center[1] * target.shape[1]),
                 int(obj_center[0] * target.shape[0]))
    mask_u8 = (255 * (m3[..., 0] > 0.5)).astype(np.uint8)

    try:
        from pix2latent_tpu_torch.native import seamless_clone
        return seamless_clone(generated.astype(np.uint8),
                              target.astype(np.uint8), mask_u8, center_xy)
    except (OSError, RuntimeError):
        pass
    try:
        import cv2
    except ImportError:
        raise RuntimeError("poisson_blend needs the native solver (g++) or "
                           "cv2") from None
    return cv2.seamlessClone(generated.astype(np.uint8),
                             target.astype(np.uint8), mask_u8,
                             center_xy, cv2.NORMAL_CLONE)
