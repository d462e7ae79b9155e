"""BigGAN-256 BasinCMA with the population split across cards (counterpart of
the JAX package's ``examples/invert_biggan_basincma_sharded.py``).

One process runs per card. Every rank holds the generator and the CMA state,
computes its block of the population's rows (forward, backward and Adam),
and the per-sample tell losses are gathered into the CMA update that every
rank runs alike (``pix2latent_tpu_torch/parallel/mesh.py``). The population
is padded to a multiple of the ranks. Rank 0 writes the results.

    torchrun --nproc_per_node=N -m \\
        pix2latent_tpu_torch.examples.invert_biggan_basincma_sharded \\
        [--smoke] [--n_devices N] [--fp IMAGE] [--checkpoint WEIGHTS]

Without ``torchrun`` it runs as one rank (``python -m ...``); ``--device
cpu`` runs the plain PyTorch paths, with gloo between the ranks. The
schedule is 30 generations of 30 inner steps and 300 final steps;
``--smoke`` runs 2 x 4 + 8.
"""

from __future__ import annotations

import torch

from pix2latent_tpu_torch import VariableManager
from pix2latent_tpu_torch.examples.common import (base_parser, finish,
                                                  load_biggan, load_target,
                                                  make_loss,
                                                  register_biggan_vars)
from pix2latent_tpu_torch.optimizers import BasinCMAOptimizer
from pix2latent_tpu_torch.parallel import make_mesh, multihost


def parser():
    p = base_parser(__doc__)
    p.add_argument("--n_devices", type=int, default=None,
                   help="the number of ranks, which must be the world size")
    return p


def schedule(args):
    """(generations, inner steps, final steps)."""
    return (2, 4, 8) if args.smoke else (30, 30, 300)


def main(argv=None):
    args = parser().parse_args(argv)
    args.grad_free = True
    on_card = torch.device(args.device).type == "cuda"
    multihost.initialize_multihost(backend=None if on_card else "gloo")
    mesh = make_mesh(args.n_devices, devices=args.device)
    print(f"population mesh: {mesh.shape['pop']} rank(s)")
    args.device = str(mesh.device)

    model = load_biggan(args)
    target, weight = load_target(args, model)
    vm = register_biggan_vars(VariableManager(device=mesh.device), model,
                              args, target, weight)
    opt = BasinCMAOptimizer(model, vm, make_loss(args), mesh=mesh,
                            log=args.make_video,
                            max_batch_size=args.max_minibatch)
    meta, grad, last = schedule(args)
    variables, outs, losses = opt.optimize(meta_steps=meta, grad_steps=grad,
                                           last_grad_steps=last)
    if not mesh.is_writer:
        return None
    return finish(args, opt, variables, outs, losses,
                  "./results/biggan_256/basincma_sharded")


if __name__ == "__main__":
    main()
