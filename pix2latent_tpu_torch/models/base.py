"""Model protocol for the execution core (counterpart of
``pix2latent_tpu/models/base.py``).

A model is an ``nn.Module`` whose ``forward(**inputs)`` takes the
population-batched input variables by name (``[pop, ...]`` tensors) and
returns NHWC images in [-1, 1]. The JAX package's
``apply(params, **inputs)`` becomes ``forward(**inputs)``: the weights live
in the module.
"""

from __future__ import annotations

from typing import Callable

import torch.nn as nn


class FunctionModel(nn.Module):
    """Wraps a bare function ``(**inputs) -> out`` (tests, closed-form toys)."""

    def __init__(self, fn: Callable):
        super().__init__()
        self.fn = fn

    def forward(self, **inputs):
        return self.fn(**inputs)


def as_model(model) -> nn.Module:
    """Coerce a callable into the model protocol."""
    if isinstance(model, nn.Module):
        return model
    if callable(model):
        return FunctionModel(model)
    raise TypeError(f"cannot wrap {type(model)} as a model")
