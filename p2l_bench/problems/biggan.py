"""BigGAN-deep inversion, as ``examples/invert_biggan_basincma.py`` and
``examples/invert_biggan_cma.py`` set it up: z searched by CMA with the
truncated-normal draw and the Clamp hook, c the class embedding refined by
Adam, ProjectionLoss (L1 + 10 LPIPS-alex) against a self-generated target
with a weight of ones.

Inputs from the seed, made on the device: the generator's weights, N(0,
0.02^2) as the port's own random init draws them (the attention gain
``attn_gamma``; every row of the standing statistics drawn, means N(0,
0.1^2) and variances 1 + |N(0, 0.1^2)|, so that a wrong truncation row
shows), LPIPS-alex's, the
target (the reference's render of a normal z and the class embedding), and
the first generation's candidates, N(0, I) as CMA's first ask draws them.
"""

from __future__ import annotations

import warnings

import torch

from p2l_bench.problems import common
from p2l_bench.reference import biggan as ref_biggan
from p2l_bench.reference import loss as ref_loss


def make_inputs(cfg, seed: int, device, popsize: int) -> dict:
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    shapes = ref_biggan.param_shapes(cfg)
    raw = common.draw(shapes, gen, device)
    W = {n: t * cfg["init_std"] for n, t in raw.items()}
    for n in W:
        if n.endswith("running_means"):
            W[n] = raw[n] * 0.1
        elif n.endswith("running_vars"):
            W[n] = 1.0 + (raw[n] * 0.1).abs()
        elif n.endswith(".gamma"):
            W[n] = torch.full_like(W[n], cfg["attn_gamma"])
    P = common.lpips_weights(gen, device)
    z_t = torch.randn((1, cfg["z_dim"]), generator=gen, device=device)
    x0 = torch.randn((popsize, cfg["z_dim"]), generator=gen, device=device)
    c = ref_biggan.class_embedding(W, cfg["class_label"])
    with torch.no_grad():
        target = ref_biggan.generate(W, z_t, c, cfg)
    return {"W": W, "P": P, "target": target,
            "weight": torch.ones_like(target), "x0": x0}


def _args(cfg, device):
    """The entry points' arguments (``examples/common.base_parser``)."""
    from pix2latent_tpu_torch.examples.common import base_parser
    args = base_parser("").parse_args(
        ["--device", str(device), "--class_lbl", str(cfg["class_label"]),
         "--truncate", str(cfg["truncation"]), "--lr", str(cfg["lr"])])
    args.grad_free = True
    return args


def build(cfg, inputs, device):
    """``(model, var_manager, loss)`` of the port, as the entry points
    build them, with the inputs' weights loaded on the device."""
    from pix2latent_tpu_torch import VariableManager
    from pix2latent_tpu_torch.examples import common as ex
    from pix2latent_tpu_torch.models.biggan import BigGAN
    from pix2latent_tpu_torch.utils.params_io import FLAX_KERNELS

    args = _args(cfg, device)
    shapes = {n: tuple(t.shape) for n, t in inputs["W"].items()}
    model = BigGAN(cfg["model_version"], channel_width=cfg["channel_width"],
                   params=common.placeholder_params(shapes, FLAX_KERNELS),
                   device=device)
    common.load_model(model, inputs["W"])
    vm = ex.register_biggan_vars(VariableManager(device=device), model, args,
                                 inputs["target"][0], inputs["weight"][0])
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        loss_fn = ex.make_loss(args)
    common.load_lpips(loss_fn, inputs["P"])
    return model, vm, loss_fn


class Reference(common.Reference):

    def __init__(self, cfg, inputs):
        self.cfg = cfg
        self.W = inputs["W"]
        self.leaves = {"c": cfg["class_lr"], "z": cfg["lr"]}
        self.trunc = float(cfg["truncation"])
        self.loss_fn = ref_loss.ProjectionLoss(inputs["P"], inputs["target"],
                                               inputs["weight"],
                                               beta=cfg["beta"])

    def hook(self, name, pre, prog_pre, prog_hooked):
        return pre.clamp(-self.trunc, self.trunc) if name == "z" else pre

    def images(self, leaves):
        return ref_biggan.generate(self.W, leaves["z"], leaves["c"], self.cfg)


def start(cfg, inputs, rows: range) -> dict:
    """The leaves entering the first inner step (before its hook): the
    candidates' rows and the class embedding."""
    z = inputs["x0"][rows.start:rows.stop]
    c = ref_biggan.class_embedding(inputs["W"], cfg["class_label"])
    return {"c": c.expand(len(rows), -1).clone(), "z": z.clone()}


def meta_inputs(cfg) -> dict:
    """Inputs of the right shapes on the meta device (FLOP counts)."""
    W = {n: torch.empty(s, device="meta")
         for n, s in ref_biggan.param_shapes(cfg).items()}
    P = {n: torch.empty(s, device="meta")
         for n, s in ref_loss.param_shapes().items()}
    im = cfg["output_dim"]
    target = torch.empty((1, im, im, 3), device="meta")
    return {"W": W, "P": P, "target": target, "weight": target,
            "x0": torch.empty((1, cfg["z_dim"]), device="meta")}


def meta_leaves(cfg, rows: int) -> dict:
    return {"c": torch.empty((rows, cfg["class_embed_dim"]), device="meta"),
            "z": torch.empty((rows, cfg["z_dim"]), device="meta")}
