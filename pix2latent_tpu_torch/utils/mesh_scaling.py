"""Seconds per BasinCMA generation of the BigGAN-deep-256 entry point's
problem (float32) with the population split over the cards of a
``torch.distributed`` group, against the same generations on one card.

    torchrun --nproc_per_node=N -m pix2latent_tpu_torch.utils.mesh_scaling \\
        [--generations G] [--steps S] [--out PATH]

Every rank builds the problem with the entry points' functions
(``examples/common.py``: ``load_target``, ``register_biggan_vars``,
``make_loss``; random BigGAN weights of seed 0 at ``--channel_width``, 128
being the published width; the synthetic self-target) and runs G + 1
generations of S inner Adam steps and the tell (``refine_and_tell``) on the
mesh of the group from seed 0, the population (18 at d = 128) padded to the
ranks. Each generation is timed from its ask to its gathered tell losses on
the host; the first is left out. Then the group is destroyed and rank 0
runs the same generations on its card without a mesh, at the same
population. Rank 0 prints one JSON line: images/s both ways (population x S
/ mean seconds a generation), their ratio, the gathers of the mesh run, the
peak device memory of each run, and the largest relative difference between
the two runs' tell losses, generation by generation (the rows of a rank go
through kernels at another batch size, so they need not be bitwise equal).
With ``--device cpu`` the group runs gloo (a rehearsal at a small
``--channel_width``). It imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import statistics
import time
import warnings

import torch
import torch.distributed as dist

from pix2latent_tpu_torch import VariableManager
from pix2latent_tpu_torch.examples import common
from pix2latent_tpu_torch.optimizers import BasinCMAOptimizer
from pix2latent_tpu_torch.parallel import make_mesh, multihost
from pix2latent_tpu_torch.parallel.mesh import (gather_counts,
                                                pad_population,
                                                reset_gather_counts)
from pix2latent_tpu_torch.strategies import cma


def _problem(device, channel_width):
    """``(model, var_manager, loss)`` of the BigGAN BasinCMA entry point."""
    from pix2latent_tpu_torch.models.biggan import BigGAN
    args = common.base_parser("").parse_args(["--device", str(device)])
    args.grad_free = True
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        model = BigGAN("biggan-deep-256", channel_width=channel_width,
                       device=device)
    target, weight = common.load_target(args, model)
    vm = common.register_biggan_vars(VariableManager(device=device), model,
                                     args, target, weight)
    return model, vm, common.make_loss(args)


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _generations(problem, mesh, popsize, generations, steps, device):
    """``(tell losses [G + 1, pop], seconds of each generation, peak
    bytes)`` of G + 1 generations from seed 0."""
    model, vm, loss_fn = problem
    opt = BasinCMAOptimizer(model, vm, loss_fn, mesh=mesh, seed=0,
                            device=device)
    opt.setup_cma(vm, popsize=popsize)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    tells, seconds = [], []
    for gi in range(generations + 1):
        _sync(device)
        t0 = time.perf_counter()
        loss, _ = opt.refine_and_tell(opt._ask_population(), steps, gi)
        tells.append(loss.cpu())
        seconds.append(time.perf_counter() - t0)
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else None)
    return torch.stack(tells), seconds, peak


def _images_per_sec(popsize, steps, seconds):
    return popsize * steps / statistics.mean(seconds[1:] or seconds)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--generations", type=int, default=3)
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--channel_width", type=int, default=128)
    ap.add_argument("--device", type=str, default="cuda")
    ap.add_argument("--out", type=str, default=None)
    args = ap.parse_args(argv)
    on_card = torch.device(args.device).type == "cuda"
    multihost.initialize_multihost(backend=None if on_card else "gloo")
    mesh = make_mesh(devices=args.device)
    device = mesh.device
    problem = _problem(device, args.channel_width)
    popsize = pad_population(cma.default_popsize(128), mesh)

    reset_gather_counts()
    tells, seconds, peak = _generations(problem, mesh, popsize,
                                        args.generations, args.steps, device)
    gathers = gather_counts()
    if mesh.distributed:
        dist.barrier()
        dist.destroy_process_group()
    if not mesh.is_writer:
        return None

    plain, plain_seconds, plain_peak = _generations(
        problem, None, popsize, args.generations, args.steps, device)
    rel = ((tells - plain).abs()
           / plain.abs().clamp_min(1e-30)).amax(dim=1).tolist()
    on_mesh = _images_per_sec(popsize, args.steps, seconds)
    alone = _images_per_sec(popsize, args.steps, plain_seconds)
    result = {
        "model": "biggan-deep-256", "dtype": "float32",
        "channel_width": args.channel_width, "device": str(device),
        "card": (torch.cuda.get_device_name(device) if on_card else "cpu"),
        "ranks": mesh.size, "backend": mesh.backend,
        "population": popsize, "rows_per_rank": popsize // mesh.size,
        "generations_timed": args.generations, "steps": args.steps,
        "mesh_gen_seconds": seconds, "plain_gen_seconds": plain_seconds,
        "mesh_images_per_sec": on_mesh, "plain_images_per_sec": alone,
        "speedup": on_mesh / alone,
        "gathers": gathers,
        "mesh_peak_bytes_rank0": peak, "plain_peak_bytes": plain_peak,
        "tell_max_rel_by_generation": rel,
        "tells_finite": bool(torch.isfinite(tells).all()
                             and torch.isfinite(plain).all())}
    line = json.dumps(result)
    print(line, flush=True)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    if not result["tells_finite"]:
        raise RuntimeError("non-finite tell losses")
    return result


if __name__ == "__main__":
    main()
