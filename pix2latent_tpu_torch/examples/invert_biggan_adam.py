"""BigGAN-deep-256 z-space inversion with Adam (counterpart of the JAX
package's ``examples/invert_biggan_adam.py``): 500 Adam steps on (z, c) of
``--num_samples`` seeds (lr 0.05 on z, 0.01 on c), under ProjectionLoss.

The generator runs in float32, so the SA-GAN attention takes the kernel's
float32 route. ``--smoke`` runs 20 steps at population 4. ``--device cpu``
runs the plain PyTorch paths. ``--fp`` inverts an image (``--mask_fp``
weights the loss by a mask) and ``--checkpoint`` takes converted weights.

    python -m pix2latent_tpu_torch.examples.invert_biggan_adam \\
        [--fp IMAGE] [--smoke] [--device cpu]
"""

from __future__ import annotations

from pix2latent_tpu_torch import VariableManager
from pix2latent_tpu_torch.examples.common import (base_parser, finish,
                                                  load_biggan, load_target,
                                                  make_loss,
                                                  register_biggan_vars)
from pix2latent_tpu_torch.optimizers import GradientOptimizer


def parser():
    return base_parser(__doc__)


def schedule(args):
    """(population, Adam steps)."""
    return (4, 20) if args.smoke else (args.num_samples, 500)


def main(argv=None):
    args = parser().parse_args(argv)
    args.grad_free = False
    model = load_biggan(args)
    target, weight = load_target(args, model)

    vm = register_biggan_vars(VariableManager(device=args.device), model,
                              args, target, weight)
    opt = GradientOptimizer(model, vm, make_loss(args), log=args.make_video,
                            max_batch_size=args.max_minibatch,
                            device=args.device)
    num_samples, grad_steps = schedule(args)
    variables, outs, losses = opt.optimize(num_samples=num_samples,
                                           grad_steps=grad_steps)
    return finish(args, opt, variables, outs, losses,
                  "./results/biggan_256/adam")


if __name__ == "__main__":
    main()
