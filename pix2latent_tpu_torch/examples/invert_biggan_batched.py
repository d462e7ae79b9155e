"""Invert several images at once with batched BasinCMA (counterpart of the
JAX package's ``examples/invert_biggan_batched.py``).

M independent CMA searches, one per image and class label, run their
populations through BigGAN-deep-256 together (``BatchedBasinCMAOptimizer``):
30 generations of population 18 with 30 inner Adam steps, then 300 final
steps; ``--smoke`` runs 2 x 5 + 10. The generator and the loss run in
bfloat16, so the SA-GAN attention takes the kernel's bfloat16 route.
``--fps`` names the images (PNG needs no imaging library), one class label
each in ``--class_lbls``; without it the targets are the generator's own
images. ``--max_batch_size`` bounds the rows a forward takes at once,
``--resume PATH`` checkpoints the run there and resumes it from there,
``--device cpu`` runs the plain PyTorch paths.

    python -m pix2latent_tpu_torch.examples.invert_biggan_batched \\
        [--fps A.png B.png] [--class_lbls 153 254] [--checkpoint WEIGHTS] \\
        [--max_batch_size N] [--resume PATH] [--smoke] [--device cpu]
"""

from __future__ import annotations

import argparse
import os
import os.path as osp
import warnings

import numpy as np
import torch

import pix2latent_tpu_torch.loss_functions as LF
from pix2latent_tpu_torch import hooks
from pix2latent_tpu_torch.optimizers import BatchedBasinCMAOptimizer
from pix2latent_tpu_torch.utils import image
from pix2latent_tpu_torch.utils.misc import to_numpy


def parser():
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--fps", type=str, nargs="*", default=None,
                   help="target image paths (synthetic if omitted)")
    p.add_argument("--class_lbls", type=int, nargs="*", default=[153, 254])
    p.add_argument("--checkpoint", type=str, default=None,
                   help="pretrained weights: a converted .npz or a "
                        "pytorch_pretrained_biggan .pt/.pth")
    p.add_argument("--save_dir", type=str, default="./results/biggan_batched")
    p.add_argument("--max_batch_size", type=int, default=None,
                   help="rows of the M*pop batch a forward and backward "
                        "take at once (bounds peak memory)")
    p.add_argument("--resume", type=str, default=None,
                   help="checkpoint path for crash-safe resume")
    p.add_argument("--smoke", action="store_true")
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (default) or cpu")
    return p


def schedule(args):
    """(generations, inner steps, final steps)."""
    return (2, 5, 10) if args.smoke else (30, 30, 300)


def load_model_and_loss(args):
    """BigGAN-deep-256 and ProjectionLoss in bfloat16, as the JAX batched
    examples build them."""
    from pix2latent_tpu_torch.models.biggan import BigGAN
    with warnings.catch_warnings():
        if not args.checkpoint:
            warnings.simplefilter("ignore")
        model = BigGAN("biggan-deep-256", pretrained_path=args.checkpoint,
                       dtype=torch.bfloat16, device=args.device)
        loss_fn = LF.ProjectionLoss(dtype=torch.bfloat16, device=args.device)
    return model, loss_fn


def read_targets(args, model, m):
    """``[M, 256, 256, 3]`` targets from ``--fps`` (short side resized,
    center-cropped), one a class label."""
    if len(args.fps) != m:
        raise ValueError(f"{len(args.fps)} images for {m} class labels: "
                         "need one class label per image")
    return torch.stack([image.read(fp, im_size=model.im_res,
                                   transform_style="biggan",
                                   device=args.device) for fp in args.fps])


def main(argv=None):
    """Run the inversion; returns ``{"save_dir", "result", "optimizer"}``."""
    args = parser().parse_args(argv)
    model, loss_fn = load_model_and_loss(args)
    c = torch.cat([model.get_class_embedding(lbl) for lbl in args.class_lbls])
    m = c.shape[0]

    if args.fps:
        targets = read_targets(args, model, m)
    else:
        print("no --fps given: synthetic self-generated targets")
        gen = torch.Generator(device=model.device).manual_seed(1)
        with torch.no_grad():
            targets = model(torch.randn((m, 128), generator=gen,
                                        device=model.device), c).float()
    weights = torch.ones_like(targets)

    opt = BatchedBasinCMAOptimizer(
        model, loss_fn, z_dim=128, learning_rate=0.05,
        learnable_inputs={"c": 0.01}, hook_fn=hooks.Clamp(2.0),
        max_batch_size=args.max_batch_size, device=args.device)
    meta, grad, last = schedule(args)
    res = opt.optimize(targets, weights, fixed_inputs={"c": c},
                       meta_steps=meta, grad_steps=grad,
                       last_grad_steps=last, checkpoint_path=args.resume)

    os.makedirs(args.save_dir, exist_ok=True)
    for i in range(m):
        image.save(osp.join(args.save_dir, f"out_{i}.jpg"),
                   to_numpy(res["out"][i].float()))
        image.save(osp.join(args.save_dir, f"target_{i}.jpg"),
                   to_numpy(targets[i]))
    with open(osp.join(args.save_dir, "results.npy"), "wb") as f:
        np.save(f, {k: (to_numpy(v.float()) if isinstance(v, torch.Tensor)
                        else np.asarray(v))
                    for k, v in res.items() if k != "cma_states"},
                allow_pickle=True)
    print(f"done: per-image losses {to_numpy(res['loss']).round(4)} "
          f"-> {args.save_dir}")
    return {"save_dir": args.save_dir, "result": res, "optimizer": opt}


if __name__ == "__main__":
    main()
