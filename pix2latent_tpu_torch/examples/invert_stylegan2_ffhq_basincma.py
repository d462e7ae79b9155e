"""StyleGAN2 FFHQ-1024 BasinCMA inversion with the one-card memory recipe
(counterpart of the JAX package's
``examples/invert_stylegan2_ffhq_basincma.py``).

At 1024x1024 and a population of 22 the recipe bounds the activations:

- ``--bf16``: bfloat16 generator compute,
- ``--remat_from_res 256``: recompute the synthesis blocks at 256 px and
  above in the backward pass (``torch.utils.checkpoint``),
- ``--max_minibatch 2``: run the population in microbatches of 2 (exact: the
  chunk gradients are scaled to the population mean, ``core/step.py``).

Flags override it (``--no_recipe`` turns it off; ``--model cars`` ignores
it). ``--fused`` drives ``optimize_fused`` (one function per generation that
reads nothing back), ``--resume PATH`` checkpoints the run there and resumes
it from there. ``--device cpu`` runs the plain PyTorch paths. ``--fp``
inverts an image (padded to a square, resized; ``--mask_fp`` weights the
loss), ``--make_video`` writes the logged frames as ``out.mp4``.

    python -m pix2latent_tpu_torch.examples.invert_stylegan2_ffhq_basincma \\
        [--smoke] [--fused] [--resume PATH] [--device cpu]
"""

from __future__ import annotations

from pix2latent_tpu_torch import VariableManager
from pix2latent_tpu_torch.examples.common import (base_parser,
                                                  cars_loss_mask,
                                                  finish,
                                                  load_stylegan2, load_target,
                                                  make_loss,
                                                  register_stylegan2_vars)
from pix2latent_tpu_torch.optimizers import BasinCMAOptimizer


def apply_ffhq_recipe(args):
    """Fill in the one-card FFHQ-1024 memory defaults without overriding
    anything the user set explicitly."""
    if args.model != "ffhq" or args.no_recipe:
        return args
    args.bf16 = True
    if args.remat_from_res == 0:
        args.remat_from_res = 256
    if args.max_minibatch is None:
        args.max_minibatch = 2
    return args


def main(argv=None):
    p = base_parser(__doc__, model="stylegan2")
    p.set_defaults(model="ffhq")
    p.add_argument("--no_recipe", action="store_true",
                   help="skip the FFHQ-1024 memory defaults (bf16 + "
                        "remat_from_res=256 + max_minibatch=2)")
    p.add_argument("--resume", type=str, default=None,
                   help="checkpoint path for crash-safe resume")
    p.add_argument("--fused", action="store_true",
                   help="one function per CMA generation, reading nothing "
                        "back")
    args = apply_ffhq_recipe(p.parse_args(argv))
    args.grad_free = True
    model = load_stylegan2(args)
    im = model.im_res
    target, weight = load_target(args, model)

    vm = register_stylegan2_vars(
        VariableManager(device=args.device), model, args, target, weight,
        loss_mask=cars_loss_mask(im, args.model))
    opt = BasinCMAOptimizer(model, vm, make_loss(args), log=args.make_video,
                            max_batch_size=args.max_minibatch,
                            device=args.device)
    opt.log_resize_factor = 0.25

    if args.smoke:
        meta, grad, last = 2, 4, 8
    else:
        meta, grad, last = 30, 30, 300
    drive = opt.optimize_fused if args.fused else opt.optimize
    variables, outs, losses = drive(meta_steps=meta, grad_steps=grad,
                                    last_grad_steps=last,
                                    checkpoint_path=args.resume,
                                    active=args.active_cma)
    return finish(args, opt, variables, outs, losses,
                  f"./results/stylegan2_{args.model}/basincma")


if __name__ == "__main__":
    main()
