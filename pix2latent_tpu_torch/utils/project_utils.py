"""The result bundle of one inversion run (counterpart of
``pix2latent_tpu/utils/project_utils.py``): the variables and final losses,
the loss entries, the last collage as ``out.jpg``, the frames as a video and
the best sample as ``best.jpg``."""

from __future__ import annotations

import os
import os.path as osp

import numpy as np

from pix2latent_tpu_torch.utils import image, video
from pix2latent_tpu_torch.utils.misc import to_numpy
from pix2latent_tpu_torch.variables import save_variables


def save_result(save_dir, variables, outs, losses, out_images=None,
                make_video=False, best_metric="loss"):
    """Write the bundle to ``save_dir`` (created) and return it.

    Args:
        variables: the final Variables.
        outs: the logged collage frames, or ``[final collage]``.
        losses: ``[[step, {metric: per-sample array}], ...]``.
        out_images: the final per-sample images ``[pop, H, W, 3]``; the
            best by ``best_metric`` is saved as ``best.jpg``.
        make_video: write ``out.mp4`` from ``outs`` (two frames or more).
    """
    os.makedirs(save_dir, exist_ok=True)

    final = losses[-1][1]
    loss = np.asarray(to_numpy(final.get(best_metric,
                                         list(final.values())[0])))
    save_variables(osp.join(save_dir, "vars.npy"), variables,
                   extras={"loss": loss})
    with open(osp.join(save_dir, "losses.npy"), "wb") as f:
        np.save(f, np.array(losses, dtype=object), allow_pickle=True)

    if outs:
        image.save(osp.join(save_dir, "out.jpg"), outs[-1])
    if make_video and len(outs) > 1:
        video.make_video(osp.join(save_dir, "out.mp4"), outs)
    if out_images is not None:
        best = int(np.argmin(loss.reshape(-1)))
        image.save(osp.join(save_dir, "best.jpg"),
                   to_numpy(out_images[best]))
    return save_dir
