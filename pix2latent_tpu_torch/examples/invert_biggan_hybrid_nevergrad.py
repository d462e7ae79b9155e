"""BigGAN-deep-256 hybrid inversion, a registry strategy outside and Adam
inside (counterpart of the JAX package's
``examples/invert_biggan_hybrid_nevergrad.py``): 30 generations of
``--ng_method`` (``strategies/registry.py``, or ``Host:<name>``) at
population ``--num_samples``, each candidate refined by 50 Adam steps, then
300 final Adam steps.

The generator runs in float32, so the SA-GAN attention takes the kernel's
float32 route. ``--fused`` drives ``optimize_fused`` (one function per
generation that reads nothing back; only the ``eigh`` of CMA, ActiveCMA and
NGOpt's aCMA leaf syncs in it), ``--resume PATH`` checkpoints the run there
and resumes it from there, ``--smoke`` runs 2 generations of 5 steps and
10 final steps. ``--device cpu`` runs the plain PyTorch paths.

    python -m pix2latent_tpu_torch.examples.invert_biggan_hybrid_nevergrad \\
        [--ng_method CMA] [--num_samples 18] [--smoke] [--fused] \\
        [--resume PATH] [--device cpu]
"""

from __future__ import annotations

from pix2latent_tpu_torch import VariableManager
from pix2latent_tpu_torch.examples.common import (base_parser, finish,
                                                  load_biggan, load_target,
                                                  make_loss,
                                                  register_biggan_vars)
from pix2latent_tpu_torch.optimizers import HybridNevergradOptimizer


def parser():
    p = base_parser(__doc__)
    p.add_argument("--ng_method", type=str, default="CMA")
    p.add_argument("--resume", type=str, default=None,
                   help="checkpoint path for crash-safe resume")
    p.add_argument("--fused", action="store_true",
                   help="one function per generation, reading nothing back")
    return p


def schedule(args):
    """(generations, inner steps, final steps)."""
    return (2, 5, 10) if args.smoke else (30, 50, 300)


def main(argv=None):
    args = parser().parse_args(argv)
    args.grad_free = True
    model = load_biggan(args)
    target, weight = load_target(args, model)

    vm = register_biggan_vars(VariableManager(device=args.device), model,
                              args, target, weight)
    opt = HybridNevergradOptimizer(args.ng_method, model, vm,
                                   make_loss(args), log=args.make_video,
                                   max_batch_size=args.max_minibatch,
                                   device=args.device)
    meta, grad, last = schedule(args)
    drive = opt.optimize_fused if args.fused else opt.optimize
    variables, outs, losses = drive(
        num_samples=args.num_samples, meta_steps=meta, grad_steps=grad,
        last_grad_steps=last, checkpoint_path=args.resume)
    return finish(args, opt, variables, outs, losses,
                  f"./results/biggan_256/hybridng_{args.ng_method}")


if __name__ == "__main__":
    main()
