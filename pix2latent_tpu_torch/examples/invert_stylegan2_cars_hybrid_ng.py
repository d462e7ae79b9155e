"""StyleGAN2 LSUN-Cars hybrid inversion, a registry strategy outside and
Adam inside (counterpart of the JAX package's
``examples/invert_stylegan2_cars_hybrid_ng.py``): 30 generations of
``--ng_method`` (``strategies/registry.py``, or ``Host:<name>``) at
population ``--num_samples``, each candidate refined by 50 Adam steps, then
300 final Adam steps, the 512x512 padded target under the cars border mask.

The generator runs in float32 unless ``--bf16``; on the card it runs the
hand-written FIR blur and modulation backward (``load_stylegan2``).
``--search w+`` searches the w latent and the noise maps. ``--fused`` drives
``optimize_fused``, ``--resume PATH`` checkpoints the run there and resumes it
from there, ``--smoke`` runs 2 generations of 4 steps and 8 final steps.
``--device cpu`` runs the plain PyTorch paths.

    python -m pix2latent_tpu_torch.examples.invert_stylegan2_cars_hybrid_ng \\
        [--ng_method DiagonalCMA] [--search w+] [--smoke] [--fused] \\
        [--resume PATH] [--device cpu]
"""

from __future__ import annotations

from pix2latent_tpu_torch.examples.common import (base_parser, finish,
                                                  make_loss,
                                                  stylegan2_problem)
from pix2latent_tpu_torch.optimizers import HybridNevergradOptimizer


def parser():
    p = base_parser(__doc__, model="stylegan2")
    p.add_argument("--ng_method", type=str, default="CMA")
    p.add_argument("--resume", type=str, default=None,
                   help="checkpoint path for crash-safe resume")
    p.add_argument("--fused", action="store_true",
                   help="one function per generation, reading nothing back")
    return p


def schedule(args):
    """(generations, inner steps, final steps)."""
    return (2, 4, 8) if args.smoke else (30, 50, 300)


def main(argv=None):
    args = parser().parse_args(argv)
    args.grad_free = True
    model, vm = stylegan2_problem(args)
    opt = HybridNevergradOptimizer(args.ng_method, model, vm,
                                   make_loss(args), log=args.make_video,
                                   max_batch_size=args.max_minibatch,
                                   device=args.device)
    opt.log_resize_factor = 0.5
    meta, grad, last = schedule(args)
    drive = opt.optimize_fused if args.fused else opt.optimize
    variables, outs, losses = drive(
        num_samples=args.num_samples, meta_steps=meta, grad_steps=grad,
        last_grad_steps=last, checkpoint_path=args.resume)
    return finish(args, opt, variables, outs, losses,
                  f"./results/stylegan2_{args.model}/hybridng_{args.ng_method}")


if __name__ == "__main__":
    main()
