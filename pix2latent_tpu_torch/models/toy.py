"""Tiny deterministic generator for cheap optimizer tests (counterpart of
``pix2latent_tpu/models/toy.py``)."""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from pix2latent_tpu_torch.utils.device import resolve_device


class ToyGenerator(nn.Module):
    """z [pop, z_dim] (+ optional c) -> NHWC image [pop, res, res, 3] in
    [-1, 1]: a linear layer to a 4x4 grid, nearest-2x-upsample + 3x3 conv
    stages up to ``res``, and a tanh head. Parameter names follow the Flax
    module's (``Dense_0``, ``Conv_i``) so its weights carry across."""

    def __init__(self, z_dim=16, c_dim=0, res=16, width=32):
        super().__init__()
        self.width = width
        self.Dense_0 = nn.Linear(z_dim + c_dim, 4 * 4 * width)
        n_up, size = 0, 4
        while size < res:
            size *= 2
            n_up += 1
        self.n_up = n_up
        for i in range(n_up):
            setattr(self, f"Conv_{i}", nn.Conv2d(width, width, 3, padding=1))
        setattr(self, f"Conv_{n_up}", nn.Conv2d(width, 3, 3, padding=1))

    def forward(self, z, c=None):
        h = z if c is None else torch.cat([z, c], dim=-1)
        x = self.Dense_0(h).view(-1, 4, 4, self.width).permute(0, 3, 1, 2)
        for i in range(self.n_up):
            x = F.interpolate(x, scale_factor=2, mode="nearest")
            x = F.relu(getattr(self, f"Conv_{i}")(x))
        x = getattr(self, f"Conv_{self.n_up}")(x)
        return torch.tanh(x).permute(0, 2, 3, 1)


def make_toy_model(z_dim=16, c_dim=0, res=16, width=32, seed=0,
                   device="cuda"):
    """A frozen ToyGenerator with deterministic (seeded) weights."""
    device = resolve_device(device)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        model = ToyGenerator(z_dim=z_dim, c_dim=c_dim, res=res, width=width)
    return model.to(device).requires_grad_(False)
