"""Plain PyTorch references of what the benchmark's cells run.

Every module here takes its weights as a dict of tensors named as the
port's ``state_dict`` names them, computes in the weights' dtype with no
hand-written kernel, and imports nothing of the program under test or of
JAX. ``precision(tf32)`` sets how float32 products run on the card while a
reference computes: strict float32 for the reference itself, TF32 for the
control that must fail the comparison.
"""

from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def precision(tf32: bool):
    """Float32 matmuls and convolutions in TF32 (``tf32=True``) or strict
    float32, restored on exit."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = bool(tf32)
    torch.backends.cudnn.allow_tf32 = bool(tf32)
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved
