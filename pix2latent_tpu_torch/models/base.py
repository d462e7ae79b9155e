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
from torch.utils.checkpoint import checkpoint

from pix2latent_tpu_torch.utils import profiling


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


def checkpointed(block: Callable, *args, res: int):
    """``block(*args)`` under ``torch.utils.checkpoint`` (the JAX package's
    ``nn.remat``): the backward recomputes the block's activations instead
    of keeping them. The block must draw no random numbers: the RNG state
    is not stashed for the recompute. Each recomputation is a ``recompute``
    span (attr ``res``, the block's resolution); it runs inside the
    backward that needs it, so the span sits under that ``backward`` span.
    The first forward records nothing."""
    calls = []

    def run(*inputs):
        if not calls:
            calls.append(True)
            return block(*inputs)
        with profiling.span("recompute", res=res):
            return block(*inputs)
    return checkpoint(run, *args, use_reentrant=False,
                      preserve_rng_state=False)
