"""BigGAN-deep-256 gradient-free inversion with a registry strategy
(counterpart of the JAX package's ``examples/invert_biggan_nevergrad.py``):
1000 eval-only generations of ``--ng_method`` (``strategies/registry.py``,
or ``Host:<name>``) at population ``--num_samples``, then 300 Adam steps on
a final ask.

The generator runs in float32, so the SA-GAN attention takes the kernel's
float32 route. ``--fused`` drives ``optimize_fused`` (one function per
generation that reads nothing back: no host sync in it for the strategies
without an ``eigh``, that is all but CMA, ActiveCMA and NGOpt's aCMA leaf),
``--resume PATH`` checkpoints the run there and resumes it from there,
``--smoke`` runs 5 generations and 10 steps. ``--device cpu`` runs the plain
PyTorch paths.

    python -m pix2latent_tpu_torch.examples.invert_biggan_nevergrad \\
        [--ng_method TBPSA] [--num_samples 18] [--smoke] [--fused] \\
        [--resume PATH] [--device cpu]
"""

from __future__ import annotations

from pix2latent_tpu_torch import VariableManager
from pix2latent_tpu_torch.examples.common import (base_parser, finish,
                                                  load_biggan, load_target,
                                                  make_loss,
                                                  register_biggan_vars)
from pix2latent_tpu_torch.optimizers import NevergradOptimizer


def parser():
    p = base_parser(__doc__)
    p.add_argument("--ng_method", type=str, default="CMA")
    p.add_argument("--fused", action="store_true",
                   help="one function per eval-only generation, reading "
                        "nothing back")
    p.add_argument("--resume", type=str, default=None,
                   help="checkpoint path for crash-safe resume")
    return p


def schedule(args):
    """(generations, finetune steps)."""
    return (5, 10) if args.smoke else (1000, 300)


def main(argv=None):
    args = parser().parse_args(argv)
    args.grad_free = True
    model = load_biggan(args)
    target, weight = load_target(args, model)

    vm = register_biggan_vars(VariableManager(device=args.device), model,
                              args, target, weight)
    opt = NevergradOptimizer(args.ng_method, model, vm, make_loss(args),
                             log=args.make_video,
                             max_batch_size=args.max_minibatch,
                             device=args.device)
    meta, grad = schedule(args)
    drive = opt.optimize_fused if args.fused else opt.optimize
    variables, outs, losses = drive(
        num_samples=args.num_samples, meta_steps=meta, grad_steps=grad,
        checkpoint_path=args.resume)
    return finish(args, opt, variables, outs, losses,
                  f"./results/biggan_256/ng_{args.ng_method}")


if __name__ == "__main__":
    main()
