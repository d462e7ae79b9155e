"""What the families share: weights drawn on the device in one call, the
construction of a port module without its host-side random init, the
LPIPS-alex weights, and the shape of a reference adapter."""

from __future__ import annotations

import math

import numpy as np
import torch

from p2l_bench.reference import loss as ref_loss


def draw(shapes: dict, gen: torch.Generator, device) -> dict:
    """Standard-normal tensors of ``shapes`` ({name: shape}), cut from one
    draw on ``device`` in sorted name order."""
    names = sorted(shapes)
    sizes = [math.prod(shapes[n]) for n in names]
    flat = torch.randn(sum(sizes), generator=gen, device=device)
    return {n: t.view(shapes[n]) for n, t in zip(names, flat.split(sizes))}


def placeholder_params(shapes: dict, layout) -> dict:
    """Zeros in the JAX layout ``layout`` (``utils/params_io.Layout``) of
    the port's parameters ``shapes``: what a port constructor takes as
    ``params=`` so that it skips its host-side random init; the real
    weights are loaded on the device after."""
    return {layout.to_jax_name(n, len(s)):
            np.zeros(layout.jax_shape(n, tuple(s)), np.float32)
            for n, s in shapes.items()}


def lpips_weights(gen, device) -> dict:
    """LPIPS-alex weights as the port's own random init scales them:
    He-scaled conv kernels, zero biases, linear heads ``10 N^2 / C``."""
    shapes = ref_loss.param_shapes()
    w = draw(shapes, gen, device)
    out = {}
    for name, t in w.items():
        if name.startswith("lin"):
            out[name] = t ** 2 * (10.0 / t.shape[1])
        elif name.endswith("bias"):
            out[name] = torch.zeros_like(t)
        else:
            out[name] = t * math.sqrt(2.0 / (t[0].numel()))
    return out


def load_lpips(loss_fn, weights: dict):
    """Load ``weights`` into the port's ProjectionLoss's LPIPS (its input
    scaling buffers stay)."""
    lp = loss_fn.ploss_fn.lpips
    missing, unexpected = lp.load_state_dict(weights, strict=False)
    if unexpected or set(missing) - {"shift", "scale"}:
        raise ValueError(f"LPIPS weights do not fit the port's: missing "
                         f"{missing}, unexpected {unexpected}")


def load_model(module: torch.nn.Module, weights: dict):
    missing, unexpected = module.load_state_dict(weights, strict=False)
    if missing or unexpected:
        raise ValueError(f"weights do not fit the port's module: missing "
                         f"{missing}, unexpected {unexpected}")


class Reference:
    """What the comparison needs of a family's reference: the Adam leaves
    with their learning rates, each leaf's hook, and the per-row loss of
    hooked leaves. ``hook(name, pre, prog_pre, prog_hooked)`` gives the
    hooked value of the reference's own ``pre``; a hook that draws noise
    takes the program's draw, ``prog_hooked`` less its own deterministic
    part of ``prog_pre``."""

    leaves: dict = {}

    def hook(self, name, pre, prog_pre, prog_hooked):
        return pre

    def images(self, leaves: dict):
        raise NotImplementedError

    def loss(self, leaves: dict):
        """Per-row loss ``[rows]`` of hooked leaves ``{name: [rows, d]}``."""
        return self.loss_fn(self.images(leaves))
