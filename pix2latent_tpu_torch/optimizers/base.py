"""Shared optimizer plumbing (counterpart of
``pix2latent_tpu/optimizers/base.py``): model / variables / loss wiring, the
random stream, the inner gradient run and the result convention. Logging and
collages are not ported yet."""

from __future__ import annotations

import numpy as np
import torch

from pix2latent_tpu_torch.core.step import ExecutionCore
from pix2latent_tpu_torch.utils.device import resolve_device
from pix2latent_tpu_torch.variables import VariableManager


class _BaseOptimizer:
    """Base of the optimizers.

    Args:
        model: an ``nn.Module`` following the model protocol
            (``models/base.py``) or a bare callable.
        var_manager: the VariableManager with the registered variables.
        loss_fn: ``loss_fn(out, **output_vars)``.
        seed: seed of this optimizer's ``torch.Generator`` (the JAX
            package's key stream).
        device: must be the variable manager's device.
    """

    def __init__(self, model, var_manager: VariableManager, loss_fn,
                 seed: int = 0, device="cuda"):
        self.device = resolve_device(device)
        if var_manager.device != self.device:
            raise ValueError(f"the variable manager lives on "
                             f"{var_manager.device}, not {self.device}")
        self.var_manager = var_manager
        self.loss_fn = loss_fn
        self.core = ExecutionCore(model, var_manager, loss_fn)
        self.model = self.core.model
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(seed)
        self.losses = []
        self.outs = []
        self.out = None
        self.loss = None

    def _run_inner(self, variables, optimizer, n_steps, start_step):
        """``n_steps`` gradient steps (an evaluation when 0). Returns
        ``(variables, optimizer, out, losses [n, pop])``."""
        if n_steps == 0:
            out, loss = self.core.eval(variables, self.generator, start_step)
            self.out, self.loss = out, loss.cpu().numpy()
            return variables, optimizer, out, loss[None]
        variables, optimizer, out, ys = self.core.grad_steps(
            variables, optimizer, self.generator, n_steps,
            start_step=start_step)
        self.out = out
        self.loss = ys["loss"][-1].cpu().numpy()
        return variables, optimizer, out, ys["loss"]

    def _final_results(self, variables, total_steps):
        """``(variables, [out], [[total_steps, {"loss": loss}]])``. The JAX
        package returns a collage of the images; the port returns the NHWC
        images as a numpy array until image utilities are ported."""
        out = self.out.detach().cpu().numpy()
        return variables, [out], [[total_steps, {"loss": np.asarray(self.loss)}]]

    def optimize(self, *args, **kwargs):
        raise NotImplementedError
