"""BigGAN-deep-256 CMA-ES inversion with an Adam finetune (counterpart of
the JAX package's ``examples/invert_biggan_cma.py``): 200 eval-only CMA
generations of population 18, then 300 Adam steps on a final ask.

The generator runs in float32, so the SA-GAN attention takes the kernel's
float32 route. ``--fused`` drives ``optimize_fused`` (one function per
generation that reads nothing back), ``--resume PATH`` checkpoints the run
there and resumes it from there, ``--active_cma`` turns on aCMA,
``--smoke`` runs 5 generations and 10 steps. ``--device cpu`` runs the
plain PyTorch paths.

    python -m pix2latent_tpu_torch.examples.invert_biggan_cma \\
        [--fp IMAGE] [--smoke] [--fused] [--resume PATH] [--device cpu]
"""

from __future__ import annotations

from pix2latent_tpu_torch import VariableManager
from pix2latent_tpu_torch.examples.common import (base_parser, finish,
                                                  load_biggan, load_target,
                                                  make_loss,
                                                  register_biggan_vars)
from pix2latent_tpu_torch.optimizers import CMAOptimizer


def parser():
    p = base_parser(__doc__)
    p.add_argument("--fused", action="store_true",
                   help="one function per eval-only generation, reading "
                        "nothing back")
    p.add_argument("--resume", type=str, default=None,
                   help="checkpoint path for crash-safe resume")
    return p


def schedule(args):
    """(generations, finetune steps)."""
    return (5, 10) if args.smoke else (200, 300)


def main(argv=None):
    args = parser().parse_args(argv)
    args.grad_free = True
    model = load_biggan(args)
    target, weight = load_target(args, model)

    vm = register_biggan_vars(VariableManager(device=args.device), model,
                              args, target, weight)
    opt = CMAOptimizer(model, vm, make_loss(args), log=args.make_video,
                       max_batch_size=args.max_minibatch, device=args.device)
    meta, grad = schedule(args)
    drive = opt.optimize_fused if args.fused else opt.optimize
    variables, outs, losses = drive(meta_steps=meta, grad_steps=grad,
                                    active=args.active_cma,
                                    checkpoint_path=args.resume)
    return finish(args, opt, variables, outs, losses,
                  "./results/biggan_256/cma")


if __name__ == "__main__":
    main()
