"""BigGAN-deep-256 inversion with a spatial (and optionally color)
transform search first (counterpart of the JAX package's
``examples/invert_biggan_with_transform.py``).

Phase 1 searches the transform parameter ``t`` with TransformBasinCMA,
propagating z across generations (50 generations of 10 inner Adam steps;
``--fused`` drives ``optimize_fused``). Phase 2 freezes the best ``t`` and
inverts with ``--method`` adam (500 steps), cma (200 generations, then 300
Adam steps) or basincma (30 generations of 30 steps, then 300), the target
and the weight warped by ``t`` and the CMA tells taken in the un-warped
frame. ``--color_transform hue,brightness`` adds color transforms to the
search, the weight warped by the spatial part only. The generator runs in
float32, so the SA-GAN attention takes the kernel's float32 route.
``--mask_fp`` weights the loss by a mask and pre-aligns the search to
BigGAN's object prior. ``--smoke`` runs 3 x 4 search steps and a short
phase 2; ``--device cpu`` runs the plain PyTorch paths.

    python -m pix2latent_tpu_torch.examples.invert_biggan_with_transform \\
        [--smoke] [--fused] [--method adam|cma|basincma] \\
        [--color_transform hue,brightness] [--device cpu]
"""

from __future__ import annotations

from pix2latent_tpu_torch import VariableManager
from pix2latent_tpu_torch.examples.common import (base_parser, finish,
                                                  load_biggan, load_target,
                                                  make_loss,
                                                  register_biggan_vars)
from pix2latent_tpu_torch.optimizers import (BasinCMAOptimizer, CMAOptimizer,
                                             GradientOptimizer)
from pix2latent_tpu_torch.transform import (SpatialOnly, SpatialTransform,
                                            TransformBasinCMAOptimizer,
                                            setup_transform_fn)
from pix2latent_tpu_torch.utils.image import binarize


def parser():
    p = base_parser(__doc__)
    p.add_argument("--method", type=str, default="basincma",
                   choices=["adam", "cma", "basincma"])
    p.add_argument("--color_transform", type=str, default="",
                   help="comma list from {hue,gamma,saturation,brightness,"
                        "contrast} to search with the spatial transform; "
                        "the wider search needs the full 50 x 10 budget, "
                        "--smoke only runs the machinery")
    p.add_argument("--fused", action="store_true",
                   help="one function per generation of the phase-1 "
                        "search, reading nothing back")
    return p


def schedule(args):
    """``((phase-1 generations, inner steps), phase 2's schedule)``; phase 2
    is ``(steps,)`` for adam, ``(generations, finetune steps)`` for cma and
    ``(generations, inner steps, final steps)`` for basincma."""
    if args.smoke:
        phase2 = {"adam": (20,), "cma": (3, 10), "basincma": (2, 4, 8)}
        return (3, 4), phase2[args.method]
    phase2 = {"adam": (500,), "cma": (200, 300), "basincma": (30, 30, 300)}
    return (50, 10), phase2[args.method]


def build_transforms(vm, args, mask=None):
    """Register the searched ``t`` (a ``transform`` variable) and return the
    target's and the weight's transforms. ``mask`` pre-aligns the spatial
    default to BigGAN's object prior. With colors, the CMA seed is the
    composed search's identity and the weight follows the spatial warp
    only: color transforms would corrupt a 0/1 mask."""
    colors = tuple(c for c in args.color_transform.split(",") if c)
    if colors:
        target_tf, _ = setup_transform_fn(
            spatial_transform=True, align=mask is not None, weight=mask,
            color_transform=colors, device=args.device)
        weight_tf = SpatialOnly(target_tf)
        seed_mu = target_tf.get_search_identity()
        vm.register("t", shape=seed_mu.shape, var_type="transform",
                    requires_grad=False, grad_free=(seed_mu, 1.0))
    else:
        target_tf = SpatialTransform(pre_align=mask, device=args.device)
        weight_tf = SpatialTransform(pre_align=mask, device=args.device)
        vm.register("t", shape=target_tf.t.shape, var_type="transform",
                    requires_grad=False, grad_free=True)
    return target_tf, weight_tf


def main(argv=None):
    args = parser().parse_args(argv)
    args.grad_free = False            # z is Adam-only in the transform search
    model = load_biggan(args)
    target, weight = load_target(args, model)
    vm = register_biggan_vars(VariableManager(device=args.device), model,
                              args, target, weight)
    # a mask pre-aligns the search to BigGAN's object prior
    mask = binarize(weight) if args.mask_fp else None
    target_tf, weight_tf = build_transforms(vm, args, mask=mask)
    (meta, grad), phase2 = schedule(args)

    # -- phase 1: the transform search -- #
    t_opt = TransformBasinCMAOptimizer(model, vm, make_loss(args),
                                       log=args.make_video,
                                       max_batch_size=args.max_minibatch,
                                       device=args.device)
    t_opt.register_transform(target_tf, "t", "target")
    t_opt.register_transform(weight_tf, "t", "weight")
    t_opt.set_variable_propagation("z")
    drive = t_opt.optimize_fused if args.fused else t_opt.optimize
    drive(meta_steps=meta, grad_steps=grad)
    best_t = t_opt.get_candidate()
    if best_t is None:
        raise RuntimeError("the transform search found no finite loss")
    print("best transform:", best_t)

    # -- phase 2: the latent search with t frozen -- #
    vm.edit_variable("t", {"default": best_t, "grad_free": False})
    vm.edit_variable("z", {"learning_rate": args.lr,
                           "grad_free": args.method != "adam"})
    drivers = {"adam": GradientOptimizer, "cma": CMAOptimizer,
               "basincma": BasinCMAOptimizer}
    opt = drivers[args.method](model, vm, make_loss(args),
                               log=args.make_video,
                               max_batch_size=args.max_minibatch,
                               device=args.device)
    opt.register_transform(target_tf, "t", "target")
    opt.register_transform(weight_tf, "t", "weight")
    if args.method == "adam":
        variables, outs, losses = opt.optimize(
            num_samples=args.num_samples, grad_steps=phase2[0])
    elif args.method == "cma":
        variables, outs, losses = opt.optimize(meta_steps=phase2[0],
                                               grad_steps=phase2[1])
    else:
        variables, outs, losses = opt.optimize(
            meta_steps=phase2[0], grad_steps=phase2[1],
            last_grad_steps=phase2[2])
    return finish(args, opt, variables, outs, losses,
                  f"./results/biggan_256/{args.method}_w_transform")


if __name__ == "__main__":
    main()
