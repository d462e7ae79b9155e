"""StyleGAN2 LSUN-Cars Adam inversion (counterpart of the JAX package's
``examples/invert_stylegan2_cars_adam.py``): 500 Adam steps on
``--num_samples`` seeds, the 512x512 padded target under the cars border
mask.

The generator runs in float32 unless ``--bf16``; on the card it runs the
hand-written FIR blur and modulation backward (``load_stylegan2``).
``--search w+`` searches the w latent and the noise maps. ``--smoke`` runs 10
steps at population 4. ``--device cpu`` runs the plain PyTorch paths.

    python -m pix2latent_tpu_torch.examples.invert_stylegan2_cars_adam \\
        [--search w+] [--smoke] [--device cpu]
"""

from __future__ import annotations

from pix2latent_tpu_torch.examples.common import (base_parser, finish,
                                                  make_loss,
                                                  stylegan2_problem)
from pix2latent_tpu_torch.optimizers import GradientOptimizer


def parser():
    return base_parser(__doc__, model="stylegan2")


def schedule(args):
    """(population, Adam steps)."""
    return (4, 10) if args.smoke else (args.num_samples, 500)


def main(argv=None):
    args = parser().parse_args(argv)
    args.grad_free = False
    model, vm = stylegan2_problem(args)
    opt = GradientOptimizer(model, vm, make_loss(args), log=args.make_video,
                            max_batch_size=args.max_minibatch,
                            device=args.device)
    opt.log_resize_factor = 0.5
    num_samples, grad_steps = schedule(args)
    variables, outs, losses = opt.optimize(num_samples=num_samples,
                                           grad_steps=grad_steps)
    return finish(args, opt, variables, outs, losses,
                  f"./results/stylegan2_{args.model}/adam")


if __name__ == "__main__":
    main()
