"""Videos and GIFs of an optimization's frames (counterpart of
``pix2latent_tpu/utils/video.py``). Frames are uint8 HWC or [-1, 1] float.
``make_video`` writes with cv2, else imageio; ``make_gif`` with imageio,
else PIL. Each is imported when called: without any of them the call
raises ``ImportError``."""

from __future__ import annotations

import numpy as np

from pix2latent_tpu_torch.utils.image import to_image
from pix2latent_tpu_torch.utils.misc import to_numpy


def _to_uint8_frames(ims):
    out = []
    for im in ims:
        im = to_numpy(im)
        if im.dtype != np.uint8:
            im = to_image(im)
        out.append(im)
    return out


def _imageio():
    try:
        import imageio
    except ImportError:
        return None
    return imageio


def make_gif(save_path, ims, duration=0.1):
    """Write frames to a GIF, ``duration`` seconds each."""
    frames = _to_uint8_frames(ims)
    if not frames:
        raise ValueError("no frames to write")
    imageio = _imageio()
    if imageio is not None:
        imageio.mimsave(save_path, frames, duration=duration)
        return save_path
    try:
        from PIL import Image
    except ImportError as e:
        raise ImportError("make_gif needs imageio or PIL (Pillow)") from e
    pics = [Image.fromarray(f) for f in frames]
    pics[0].save(save_path, save_all=True, append_images=pics[1:],
                 duration=int(round(1000 * duration)), loop=0)
    return save_path


def make_video(save_path, ims, fps=30):
    """Write frames to a video (``.mp4``: mp4v; ``.webm``: VP8) at ``fps``.
    With imageio but no cv2 and no ffmpeg, a GIF is written beside the path
    instead, as the JAX package does; returns the path written."""
    frames = _to_uint8_frames(ims)
    if not frames:
        raise ValueError("no frames to write")
    try:
        import cv2
    except ImportError:
        cv2 = None
    if cv2 is not None:
        h, w = frames[0].shape[:2]
        codec = "VP80" if save_path.endswith(".webm") else "mp4v"
        writer = cv2.VideoWriter(save_path, cv2.VideoWriter_fourcc(*codec),
                                 fps, (w, h))
        if not writer.isOpened():
            raise RuntimeError(f"cv2 cannot open a {codec} writer for "
                               f"{save_path}")
        for f in frames:
            writer.write(np.ascontiguousarray(f[:, :, ::-1]))
        writer.release()
        return save_path
    imageio = _imageio()
    if imageio is None:
        raise ImportError("make_video needs cv2 (opencv-python) or imageio")
    try:
        imageio.mimsave(save_path, frames, fps=fps)
    except Exception:
        alt = save_path.rsplit(".", 1)[0] + ".gif"
        imageio.mimsave(alt, frames, duration=1.0 / fps)
        return alt
    return save_path
