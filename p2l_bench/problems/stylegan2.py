"""StyleGAN2 inversion in z, as ``examples/invert_stylegan2_cars_basincma.py``
sets it up (``examples/common.stylegan2_problem``): z searched by CMA from
N(0, I), each step hooked by Normalize then NormalPerturb(latent_noise),
ProjectionLoss against a self-generated target under the cars border mask.
The port's model is built with ``common.load_stylegan2``'s flags: on a
card the FIR blur (K2) and the fused modulation backward (K3) run.

Inputs from the seed, made on the device: the generator's weights in the
``equalized`` scheme (the port's ``init="equalized"``: equalized-linear
weights N(0, 1) / lr_mul, other weights, the constant input and the noise
maps N(0, 1), modulation biases 1, other biases and the noise gains 0),
LPIPS-alex's, the target (the reference's render of a normal z) and the
first generation's candidates, N(0, I).
"""

from __future__ import annotations

import warnings

import torch

from p2l_bench.problems import common
from p2l_bench.reference import loss as ref_loss
from p2l_bench.reference import stylegan2 as ref_sg2


def _equalized(name, t, lr_mul):
    if name.endswith("bias"):
        return torch.full_like(t, 1.0 if ".modulation." in name else 0.0)
    if t.dim() == 0:
        return torch.zeros_like(t)
    if name.startswith("generator.style_"):
        return t / lr_mul
    return t


def border_mask(cfg, device):
    """Ones on the middle 3/4 of the rows (the cars frame), ``[1, H, W, 3]``."""
    im = cfg["im_res"]
    m = torch.zeros((1, im, im, 3), device=device)
    pad = im // 8
    m[:, pad:im - pad] = 1.0
    return m


def make_inputs(cfg, seed: int, device, popsize: int) -> dict:
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    W = {n: _equalized(n, t, cfg["lr_mul"]) for n, t in common.draw(
        ref_sg2.param_shapes(cfg), gen, device).items()}
    P = common.lpips_weights(gen, device)
    z_t = torch.randn((1, cfg["style_dim"]), generator=gen, device=device)
    x0 = torch.randn((popsize, cfg["style_dim"]), generator=gen,
                     device=device)
    with torch.no_grad():
        target = ref_sg2.generate(W, z_t, cfg)
    return {"W": W, "P": P, "target": target,
            "weight": torch.ones_like(target),
            "loss_mask": border_mask(cfg, device), "x0": x0}


def build(cfg, inputs, device):
    """``(model, var_manager, loss)`` of the port as the cars entry point
    builds them, with the inputs' weights loaded on the device."""
    from pix2latent_tpu_torch import VariableManager
    from pix2latent_tpu_torch.examples import common as ex
    from pix2latent_tpu_torch.models.stylegan2 import StyleGAN2
    from pix2latent_tpu_torch.utils.params_io import STYLEGAN2

    args = ex.base_parser("", model="stylegan2").parse_args(
        ["--device", str(device), "--model", cfg["model"], "--lr",
         str(cfg["lr"]), "--latent_noise", str(cfg["latent_noise"])])
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
                      dtype=torch.float32, fused_mod_bwd=on_card,
                      fir_kernel=on_card, device=device)
    common.load_model(model, inputs["W"])
    vm = ex.register_stylegan2_vars(
        VariableManager(device=device), model, args, inputs["target"][0],
        inputs["weight"][0], loss_mask=inputs["loss_mask"][0])
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        loss_fn = ex.make_loss(args)
    common.load_lpips(loss_fn, inputs["P"])
    return model, vm, loss_fn


def _normalize(x):
    mean = x.mean(dim=1, keepdim=True)
    std = x.std(dim=1, keepdim=True, correction=1)
    return (x - mean) / (std + 1e-12)


class Reference(common.Reference):

    def __init__(self, cfg, inputs):
        self.cfg = cfg
        self.W = inputs["W"]
        self.leaves = {"z": cfg["lr"]}
        self.loss_fn = ref_loss.ProjectionLoss(
            inputs["P"], inputs["target"], inputs["weight"],
            loss_mask=inputs["loss_mask"], beta=cfg["beta"])

    def hook(self, name, pre, prog_pre, prog_hooked):
        """Normalize, then the program's own noise draw."""
        return _normalize(pre) + (prog_hooked - _normalize(prog_pre))

    def noise(self, prog_pre, prog_hooked):
        """The noise the program's hook drew, in units of its sigma."""
        return (prog_hooked - _normalize(prog_pre)) / self.cfg["latent_noise"]

    def images(self, leaves):
        return ref_sg2.generate(self.W, leaves["z"], self.cfg)


def start(cfg, inputs, rows: range) -> dict:
    return {"z": inputs["x0"][rows.start:rows.stop].clone()}


def meta_inputs(cfg) -> dict:
    W = {n: torch.empty(s, device="meta")
         for n, s in ref_sg2.param_shapes(cfg).items()}
    P = {n: torch.empty(s, device="meta")
         for n, s in ref_loss.param_shapes().items()}
    im = cfg["im_res"]
    t = torch.empty((1, im, im, 3), device="meta")
    return {"W": W, "P": P, "target": t, "weight": t, "loss_mask": t,
            "x0": torch.empty((1, cfg["style_dim"]), device="meta")}


def meta_leaves(cfg, rows: int) -> dict:
    return {"z": torch.empty((rows, cfg["style_dim"]), device="meta")}
