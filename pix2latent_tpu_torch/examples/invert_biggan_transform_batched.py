"""Align M misaligned images, then invert all of them at once (counterpart
of the JAX package's ``examples/invert_biggan_transform_batched.py``).

Phase 1 runs M spatial-alignment searches together
(``TransformBasinCMAOptimizer.optimize_fused_batched``, 50 generations of 10
inner steps at population 7, z propagated). Phase 2 freezes each image's
best ``t``, warps its target and a weight of ones by it once, and inverts
the M warped targets together with ``BatchedBasinCMAOptimizer`` (30 x 30 +
300 at population 18), whose tells take the image back to the original
frame (``tell_inverted``). ``--smoke`` runs 3 x 3, then 2 x 3 + 5. The
generator and the loss run in bfloat16. Rows in flight: phase 1 chunks by
``--p1_mbs`` from M = 8 on, phase 2 by ``--p2_mbs`` past 126 rows.
``--resume PATH`` checkpoints both phases (``PATH.p1.npz``,
``PATH.p2.npz``); ``--device cpu`` runs the plain PyTorch paths.

    python -m pix2latent_tpu_torch.examples.invert_biggan_transform_batched \\
        [--fps A.png B.png] [--class_lbls 153 254] [--checkpoint WEIGHTS] \\
        [--resume PATH] [--smoke] [--device cpu]
"""

from __future__ import annotations

import argparse
import os
import os.path as osp

import numpy as np
import torch

from pix2latent_tpu_torch import VariableManager
from pix2latent_tpu_torch import distribution as dist
from pix2latent_tpu_torch import hooks
from pix2latent_tpu_torch.examples.invert_biggan_batched import (
    load_model_and_loss, read_targets)
from pix2latent_tpu_torch.optimizers import BatchedBasinCMAOptimizer
from pix2latent_tpu_torch.transform import (SpatialTransform,
                                            TransformBasinCMAOptimizer)
from pix2latent_tpu_torch.utils import image
from pix2latent_tpu_torch.utils.misc import to_numpy


def parser():
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--fps", type=str, nargs="*", default=None,
                   help="target image paths (synthetic misaligned "
                        "self-targets if omitted)")
    p.add_argument("--class_lbls", type=int, nargs="*", default=[153, 254])
    p.add_argument("--checkpoint", type=str, default=None,
                   help="pretrained weights: a converted .npz or a "
                        "pytorch_pretrained_biggan .pt/.pth")
    p.add_argument("--save_dir", type=str,
                   default="./results/biggan_transform_batched")
    p.add_argument("--sensitivity", type=float, default=0.1,
                   help="alignment-search warp sensitivity")
    p.add_argument("--p1_mbs", type=int, default=4,
                   help="phase-1 microbatch (rows in flight), applied from "
                        "M = 8 on")
    p.add_argument("--p2_mbs", type=int, default=108,
                   help="phase-2 microbatch over the M*pop rows, applied "
                        "past 126 rows")
    p.add_argument("--resume", type=str, default=None,
                   help="checkpoint path prefix for crash-safe resume "
                        "(phase 1 and 2 get separate files)")
    p.add_argument("--smoke", action="store_true")
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (default) or cpu")
    return p


def schedule(args):
    """``((phase-1 generations, inner steps), (phase-2 generations, inner
    steps, final steps))``."""
    if args.smoke:
        return (3, 3), (2, 3, 5)
    return (50, 10), (30, 30, 300)


def main(argv=None):
    """Run both phases; returns ``{"save_dir", "search", "result",
    "search_optimizer", "optimizer"}``."""
    args = parser().parse_args(argv)
    model, loss_fn = load_model_and_loss(args)
    cs = torch.cat([model.get_class_embedding(lbl)
                    for lbl in args.class_lbls])
    m = cs.shape[0]

    if args.fps:
        targets = read_targets(args, model, m)
    else:
        print("no --fps given: synthetic misaligned self-targets")
        gen = torch.Generator(device=model.device).manual_seed(1)
        with torch.no_grad():
            clean = model(torch.randn((m, 128), generator=gen,
                                      device=model.device), cs).float()
        render_warp = SpatialTransform(sensitivity=1.0, device=args.device)
        shifts = np.linspace(-0.3, 0.3, m)
        targets = torch.cat([
            render_warp.transform(clean[i:i + 1], torch.tensor(
                [[1.0, float(s), 0.05]], device=model.device))
            for i, s in enumerate(shifts)])
    (p1_meta, p1_grad), (meta, grad, last) = schedule(args)

    # -- phase 1: M alignment searches, their rows together -------------- #
    im = targets.shape[1]
    vm = VariableManager(seed=0, device=args.device)
    vm.register("z", shape=(128,), var_type="input",
                distribution=dist.TruncatedNormalModulo(sigma=1.0, trunc=2.0),
                learning_rate=0.05, hook_fn=hooks.Clamp(2.0))
    vm.register("c", shape=(128,), var_type="input", learning_rate=0.01,
                default=torch.zeros(128))
    vm.register("target", shape=(im, im, 3), var_type="output",
                requires_grad=False, default=targets[0])
    vm.register("weight", shape=(im, im, 3), var_type="output",
                requires_grad=False, default=torch.ones(im, im, 3))
    vm.register("t", shape=(3,), var_type="transform", requires_grad=False,
                grad_free=(np.array([1.0, 0.0, 0.0]), 0.3))

    warp = SpatialTransform(sensitivity=args.sensitivity, device=args.device)
    p1 = TransformBasinCMAOptimizer(
        model, vm, loss_fn, track_variables=False,
        max_batch_size=args.p1_mbs if m >= 8 else None, device=args.device)
    p1.register_transform(warp, "t", "target")
    p1.register_transform(warp, "t", "weight")
    p1.set_variable_propagation("z")
    res1 = p1.optimize_fused_batched(
        {"target": targets, "c": cs}, meta_steps=p1_meta, grad_steps=p1_grad,
        seeds=np.arange(m),
        checkpoint_path=args.resume and args.resume + ".p1.npz")
    t_best = torch.as_tensor(res1["candidate"], device=model.device)
    print("best transforms:", res1["candidate"].round(3))

    # -- phase 2: t frozen, the warps computed once, all M inverted ------ #
    # the candidate is a delta: warp(x, delta) applies default_t +
    # sensitivity * delta
    with torch.no_grad():
        warped_t = torch.cat([warp(targets[i:i + 1], t_best[i:i + 1])
                              for i in range(m)])
        ones = torch.ones_like(targets[:1])
        warped_w = torch.cat([warp(ones, t_best[i:i + 1]) for i in range(m)])

    p2 = BatchedBasinCMAOptimizer(
        model, loss_fn, z_dim=128, learning_rate=0.05,
        learnable_inputs={"c": 0.01}, hook_fn=hooks.Clamp(2.0),
        max_batch_size=args.p2_mbs if m * 18 > 126 else None,
        device=args.device)
    res2 = p2.optimize(warped_t, warped_w, fixed_inputs={"c": cs},
                       meta_steps=meta, grad_steps=grad,
                       last_grad_steps=last,
                       # tells and winners in the original frame
                       tell_inverted={"transform_fn": warp, "t": t_best,
                                      "targets": targets},
                       checkpoint_path=args.resume and args.resume + ".p2.npz")

    os.makedirs(args.save_dir, exist_ok=True)
    for i in range(m):
        image.save(osp.join(args.save_dir, f"out_{i}.jpg"),
                   to_numpy(res2["out"][i].float()))
        image.save(osp.join(args.save_dir, f"aligned_target_{i}.jpg"),
                   to_numpy(warped_t[i]))
    with open(osp.join(args.save_dir, "results.npy"), "wb") as f:
        np.save(f, {"t": res1["candidate"], "z": to_numpy(res2["z"]),
                    "c": to_numpy(res2["c"]), "loss": to_numpy(res2["loss"]),
                    "loss_curves": res2["loss_curves"]}, allow_pickle=True)
    print(f"done: per-image losses {to_numpy(res2['loss']).round(4)} "
          f"-> {args.save_dir}")
    return {"save_dir": args.save_dir, "search": res1, "result": res2,
            "search_optimizer": p1, "optimizer": p2}


if __name__ == "__main__":
    main()
