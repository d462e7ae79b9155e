"""BigGAN-deep-256 BasinCMA inversion, the paper's method (counterpart of the
JAX package's ``examples/invert_biggan_basincma.py``): 30 CMA generations of
population 18, each candidate refined by 30 Adam steps, then 300 final Adam
steps.

The generator runs in float32, as the JAX example's does, so the SA-GAN
attention takes the kernel's float32 route. ``--fused`` drives
``optimize_fused`` (one function per generation that reads nothing back),
``--resume PATH`` checkpoints the run there and resumes it from there,
``--smoke`` runs 2 generations of 5 steps and 10 final steps. ``--device
cpu`` runs the plain PyTorch paths. ``--fp`` inverts an image (``--mask_fp``
weights the loss by a mask) and ``--checkpoint`` takes converted weights
(``.npz``) or a ``pytorch_pretrained_biggan`` ``.pt`` / ``.pth``.

    python -m pix2latent_tpu_torch.examples.invert_biggan_basincma \\
        [--fp IMAGE] [--mask_fp MASK] [--checkpoint WEIGHTS] [--smoke] \\
        [--fused] [--resume PATH] [--make_video] [--device cpu]
"""

from __future__ import annotations

from pix2latent_tpu_torch import VariableManager
from pix2latent_tpu_torch.examples.common import (base_parser, finish,
                                                  load_biggan, load_target,
                                                  make_loss,
                                                  register_biggan_vars)
from pix2latent_tpu_torch.optimizers import BasinCMAOptimizer


def parser():
    p = base_parser(__doc__)
    p.add_argument("--resume", type=str, default=None,
                   help="checkpoint path for crash-safe resume")
    p.add_argument("--fused", action="store_true",
                   help="one function per CMA generation, reading nothing "
                        "back")
    return p


def schedule(args):
    """(generations, inner steps, final steps)."""
    return (2, 5, 10) if args.smoke else (30, 30, 300)


def main(argv=None):
    args = parser().parse_args(argv)
    args.grad_free = True
    model = load_biggan(args)
    target, weight = load_target(args, model)

    vm = register_biggan_vars(VariableManager(device=args.device), model,
                              args, target, weight)
    opt = BasinCMAOptimizer(model, vm, make_loss(args), log=args.make_video,
                            max_batch_size=args.max_minibatch,
                            device=args.device)
    meta, grad, last = schedule(args)
    drive = opt.optimize_fused if args.fused else opt.optimize
    variables, outs, losses = drive(meta_steps=meta, grad_steps=grad,
                                    last_grad_steps=last,
                                    checkpoint_path=args.resume,
                                    active=args.active_cma)
    return finish(args, opt, variables, outs, losses,
                  "./results/biggan_256/basincma")


if __name__ == "__main__":
    main()
