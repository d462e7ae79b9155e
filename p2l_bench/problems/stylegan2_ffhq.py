"""StyleGAN2 FFHQ-1024 inversion in z, as
``examples/invert_stylegan2_ffhq_basincma.py`` sets it up under
``--no_recipe --remat_from_res 256``: float32, the population whole, the
synthesis blocks from ``remat_from_res`` on recomputed in the backward;
z searched by CMA from N(0, I), each step hooked by Normalize then
NormalPerturb(latent_noise), ProjectionLoss against a self-generated
target with no loss mask (FFHQ fills the frame). On a card the FIR blur
(K2) and the fused modulation backward (K3) run, as ``load_stylegan2``
turns them on.

The inputs and the reference are the cars family's (``problems/
stylegan2.py``) without its border mask: equalized weights, LPIPS-alex,
the reference's render of a normal z as the target, and the first
candidates, all from the seed on the device.
"""

from __future__ import annotations

import warnings

import torch

from p2l_bench.problems import common
from p2l_bench.problems import stylegan2 as cars

start = cars.start
meta_leaves = cars.meta_leaves


def make_inputs(cfg, seed: int, device, popsize: int) -> dict:
    inputs = cars.make_inputs(cfg, seed, device, popsize)
    del inputs["loss_mask"]
    return inputs


def build(cfg, inputs, device):
    """``(model, var_manager, loss)`` of the port as the FFHQ entry point
    builds them under ``--no_recipe --remat_from_res <cfg>``, with the
    inputs' weights loaded on the device."""
    from pix2latent_tpu_torch import VariableManager
    from pix2latent_tpu_torch.examples import common as ex
    from pix2latent_tpu_torch.examples import (
        invert_stylegan2_ffhq_basincma as entry)
    from pix2latent_tpu_torch.models.stylegan2 import StyleGAN2
    from pix2latent_tpu_torch.utils.params_io import STYLEGAN2

    args = entry.apply_ffhq_recipe(entry.parser().parse_args(
        ["--device", str(device), "--model", cfg["model"], "--lr",
         str(cfg["lr"]), "--latent_noise", str(cfg["latent_noise"]),
         "--no_recipe", "--remat_from_res", str(cfg["remat_from_res"])]))
    args.grad_free = True
    if StyleGAN2.MODELS[args.model] != cfg["im_res"]:
        raise ValueError(f"the port's {args.model} model is "
                         f"{StyleGAN2.MODELS[args.model]} px, the "
                         f"configuration {cfg['im_res']}")
    on_card = torch.device(device).type == "cuda"
    gen_shapes = {n[len("generator."):]: tuple(t.shape)
                  for n, t in inputs["W"].items()}
    model = StyleGAN2(args.model, search=args.search,
                      params=common.placeholder_params(gen_shapes, STYLEGAN2),
                      channel_multiplier=cfg["channel_multiplier"],
                      remat_from_res=args.remat_from_res,
                      dtype=torch.float32, fused_mod_bwd=on_card,
                      fir_kernel=on_card, device=device)
    common.load_model(model, inputs["W"])
    vm = ex.register_stylegan2_vars(
        VariableManager(device=device), model, args, inputs["target"][0],
        inputs["weight"][0],
        loss_mask=ex.cars_loss_mask(model.im_res, args.model))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        loss_fn = ex.make_loss(args)
    common.load_lpips(loss_fn, inputs["P"])
    return model, vm, loss_fn


class Reference(cars.Reference):
    """The cars family's reference with no loss mask."""

    def __init__(self, cfg, inputs):
        super().__init__(cfg, {**inputs, "loss_mask": None})


def meta_inputs(cfg) -> dict:
    inputs = cars.meta_inputs(cfg)
    del inputs["loss_mask"]
    return inputs
