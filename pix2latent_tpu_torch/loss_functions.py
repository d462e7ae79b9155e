"""Inversion objectives (counterpart of ``pix2latent_tpu/loss_functions.py``).

Losses take NHWC image batches (``[pop, H, W, C]`` in [-1, 1]) and are
called as ``loss_fn(out, **output_vars)`` with the registered output
variable names as keywords. They return per-sample values ``[pop]`` or
per-element maps that the execution core averages per sample.
"""

from __future__ import annotations

import torch

from pix2latent_tpu_torch.utils.device import resolve_device

_SPATIAL_DIMS = (1, 2, 3)  # H, W, C of an NHWC batch


def l1_loss(out, target):
    return (target - out).abs()


def l2_loss(out, target):
    return (target - out) ** 2


def _broadcast_batch(x, n):
    if x.shape[0] == 1 and n != 1:
        return x.expand(n, *x.shape[1:])
    return x


def masked_l1_loss(out, target, mask):
    """Mask-normalized L1, per sample."""
    mask = _broadcast_batch(mask, out.shape[0])
    target = _broadcast_batch(target, out.shape[0])
    loss = l1_loss(out, target)
    return (loss * mask).sum(dim=_SPATIAL_DIMS) / mask.sum(dim=_SPATIAL_DIMS)


def masked_l2_loss(out, target, mask):
    """Mask-normalized L2, per sample."""
    mask = _broadcast_batch(mask, out.shape[0])
    target = _broadcast_batch(target, out.shape[0])
    loss = l2_loss(out, target)
    return (loss * mask).sum(dim=_SPATIAL_DIMS) / mask.sum(dim=_SPATIAL_DIMS)


def _weighted_pool(loss_map, weight, loss_mask):
    """Spatially weighted per-sample mean (the loss map itself without a
    weight). A 3-channel weight is averaged onto a 1-channel map."""
    if weight is None:
        return loss_map
    w = weight if loss_mask is None else (loss_mask * weight)
    w = _broadcast_batch(w, loss_map.shape[0])
    if w.shape[-1] != loss_map.shape[-1]:
        w = w.mean(dim=-1, keepdim=True)
    return ((loss_map * w).sum(dim=_SPATIAL_DIMS)
            / w.sum(dim=_SPATIAL_DIMS))


class ReconstructionLoss:
    """Spatially weighted L1 or L2."""

    def __init__(self, loss_type="l1"):
        if loss_type in ("l1", 1):
            self.loss_fn = l1_loss
        elif loss_type in ("l2", 2):
            self.loss_fn = l2_loss
        else:
            raise ValueError(f"Unknown loss_type {loss_type}")

    def __call__(self, output, target, weight=None, loss_mask=None):
        target = _broadcast_batch(target, output.shape[0])
        return _weighted_pool(self.loss_fn(output, target), weight, loss_mask)

    def precompute(self, target, weight=None, loss_mask=None):
        """Target-side context for :meth:`from_ctx` (the arguments as they
        are; kept so every loss shares the precompute protocol)."""
        return {"target": target, "weight": weight, "loss_mask": loss_mask}

    def from_ctx(self, output, ctx):
        return self(output, ctx["target"], ctx["weight"], ctx["loss_mask"])


class PerceptualLoss:
    """Spatial LPIPS with spatial weighting."""

    def __init__(self, net="alex", params=None, pretrained_path=None,
                 dtype=torch.float32, device="cuda"):
        from pix2latent_tpu_torch.losses.lpips import LPIPS
        self.lpips = LPIPS(net=net, params=params,
                           pretrained_path=pretrained_path, spatial=True,
                           dtype=dtype, device=device)

    def __call__(self, output, target, weight=None, loss_mask=None):
        target = _broadcast_batch(target, output.shape[0])
        return _weighted_pool(self.lpips(output, target), weight, loss_mask)

    def precompute(self, target, weight=None, loss_mask=None):
        """The target's LPIPS pyramid, computed once, so :meth:`from_ctx`
        neither re-extracts nor backpropagates through the target branch."""
        return {"fy": self.lpips.features(target),
                "weight": weight, "loss_mask": loss_mask}

    def from_ctx(self, output, ctx):
        loss = self.lpips.distance(output, ctx["fy"])
        return _weighted_pool(loss, ctx["weight"], ctx["loss_mask"])


class ProjectionLoss:
    """The paper's default objective: masked L1 + beta * LPIPS (beta=10,
    net='alex')."""

    def __init__(self, lpips_net="alex", beta=10.0, lpips_params=None,
                 pretrained_path=None, loss_type="l1", dtype=torch.float32,
                 device="cuda"):
        self.device = resolve_device(device)
        self.beta = float(beta)
        self.rloss_fn = ReconstructionLoss(loss_type=loss_type)
        self.ploss_fn = PerceptualLoss(net=lpips_net, params=lpips_params,
                                       pretrained_path=pretrained_path,
                                       dtype=dtype, device=self.device)

    def __call__(self, output, target, weight=None, loss_mask=None):
        rec = self.rloss_fn(output, target, weight, loss_mask)
        per = self.ploss_fn(output, target, weight, loss_mask)
        return rec + self.beta * per

    def precompute(self, target, weight=None, loss_mask=None):
        return {"rec": self.rloss_fn.precompute(target, weight, loss_mask),
                "per": self.ploss_fn.precompute(target, weight, loss_mask)}

    def from_ctx(self, output, ctx):
        rec = self.rloss_fn.from_ctx(output, ctx["rec"])
        per = self.ploss_fn.from_ctx(output, ctx["per"])
        return rec + self.beta * per
