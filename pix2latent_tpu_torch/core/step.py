"""The execution core: hooks -> model forward -> loss -> gradient -> Adam
(counterpart of ``pix2latent_tpu/core/step.py``).

Every variable carries a leading population axis. The gradient of a step is
the gradient of the MEAN of the per-sample losses over the population, as
in the JAX package. The variables that Adam updates are leaf tensors owned
by the population's optimizer (:meth:`ExecutionCore.init_opt_state`); hooks
write their result into them in place before each forward, which equals the
JAX package's "hook, then step from the hooked values".

Registered *input* variable names are the model's forward keywords; *output*
variable names are the loss's keywords.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from pix2latent_tpu_torch.models.base import as_model
from pix2latent_tpu_torch.variables import (VariableManager,
                                            VariableOptimizer, Variables)


class ExecutionCore:
    """Runs the inner steps and the tell evaluations of one problem."""

    def __init__(self, model, var_manager: VariableManager, loss_fn: Callable):
        self.model = as_model(model)
        self.var_manager = var_manager
        self.loss_fn = loss_fn

    # ------------------------------------------------------------------ #
    # forward / loss                                                     #
    # ------------------------------------------------------------------ #

    def _dedupe_outputs(self, variables: Variables) -> Variables:
        """Shrink constant output variables (a default, no gradient, no
        hook) to one shared row; the losses broadcast 1-row targets."""
        info = self.var_manager.variable_info
        outputs = variables.get("output")
        if not outputs:
            return variables
        out = {vt: dict(d) for vt, d in variables.items()}
        for name, data in outputs.items():
            spec = info[name]
            if (spec["default"] is not None and not spec["requires_grad"]
                    and spec["hook_fn"] is None and data.shape[0] != 1):
                out["output"][name] = data[:1]
        return out

    def _freeze(self, variables: Variables) -> Variables:
        """Detach every requires_grad=False variable, so autograd never
        builds the frozen branches (e.g. the LPIPS backbone on the target)."""
        info = self.var_manager.variable_info
        return {vt: {name: (a if info.get(name, {}).get("requires_grad", True)
                            else a.detach())
                     for name, a in d.items()}
                for vt, d in variables.items()}

    def _forward_loss(self, variables: Variables, ctx=None):
        """(mean over the population, per-sample losses [pop], images)."""
        variables = self._freeze(variables)
        out = self.model(**variables.get("input", {}))
        if ctx is not None:
            loss_map = self.loss_fn.from_ctx(out, ctx)
        else:
            loss_map = self.loss_fn(out, **variables.get("output", {}))
        per_sample = loss_map.reshape(out.shape[0], -1).mean(dim=1)
        return per_sample.mean(), per_sample, out

    def _can_precompute(self) -> bool:
        """The loss can precompute its target side and every output variable
        is constant through the inner loop (frozen, no hook)."""
        if not hasattr(self.loss_fn, "precompute"):
            return False
        outs = [s for s in self.var_manager.variable_info.values()
                if s["var_type"] == "output"]
        return bool(outs) and all(not s["requires_grad"] and s["hook_fn"] is None
                                  for s in outs)

    def make_ctx(self, variables: Variables):
        """The loss's target-side context (the LPIPS target pyramid),
        computed once without gradients; None when not applicable."""
        if not self._can_precompute() or not variables.get("output"):
            return None
        with torch.no_grad():
            return self.loss_fn.precompute(
                **{k: v.detach() for k, v in variables["output"].items()})

    # ------------------------------------------------------------------ #
    # steps                                                              #
    # ------------------------------------------------------------------ #

    def init_opt_state(self, variables: Variables):
        """Fresh optimizer state for a population: returns ``(variables,
        optimizer)`` where every trainable variable is now a leaf tensor the
        optimizer updates in place."""
        info = self.var_manager.variable_info
        variables = {vt: {name: (a.detach().clone().requires_grad_(True)
                                 if info[name]["requires_grad"] else a)
                          for name, a in d.items()}
                     for vt, d in variables.items()}
        return variables, self.var_manager.make_optimizer(variables)

    def _hook_in_place(self, generator, variables: Variables, step) -> Variables:
        hooked = self.var_manager.apply_hooks(generator, variables, step)
        out = {vt: dict(d) for vt, d in variables.items()}
        with torch.no_grad():
            for vt, d in hooked.items():
                for name, new in d.items():
                    old = variables[vt][name]
                    if new is old:
                        continue
                    if old.requires_grad:
                        old.copy_(new)          # keep the optimizer's leaf
                    else:
                        out[vt][name] = new
        return out

    def grad_steps(self, variables: Variables, optimizer: VariableOptimizer,
                   generator, n_steps: int, start_step: int = 0, ctx=None):
        """``n_steps`` hook / forward / backward / optimizer steps.

        ``variables`` and ``optimizer`` come from :meth:`init_opt_state`;
        ``ctx`` is a :meth:`make_ctx` result (computed here when None).
        Returns ``(variables, optimizer, out, {"loss": [n_steps, pop]})``
        with the per-sample losses each step's forward saw."""
        variables = self._dedupe_outputs(variables)
        if ctx is None:
            ctx = self.make_ctx(variables)
        losses, out = [], None
        for i in range(int(n_steps)):
            variables = self._hook_in_place(generator, variables,
                                            start_step + i)
            optimizer.zero_grad()
            loss, per_sample, out = self._forward_loss(variables, ctx)
            loss.backward()
            optimizer.step()
            losses.append(per_sample.detach())
        return variables, optimizer, out.detach(), {"loss": torch.stack(losses)}

    def eval(self, variables: Variables, generator, step=0):
        """Hooks + forward + per-sample loss, no updates: ``(out, loss)``."""
        with torch.no_grad():
            variables = self._dedupe_outputs(variables)
            variables = self.var_manager.apply_hooks(generator, variables, step)
            _, per_sample, out = self._forward_loss(variables)
        return out, per_sample

    def tell_loss(self, variables: Variables, generator, step=0,
                  inverted=True, ctx=None):
        """Fresh per-sample loss for the CMA tell: hooks applied to a copy,
        then a forward without gradients. ``inverted`` names the JAX
        package's un-warped frame, which differs only when a transform is
        registered; the port has no transforms yet, so both frames agree."""
        del inverted
        with torch.no_grad():
            variables = self._dedupe_outputs(variables)
            variables = self.var_manager.apply_hooks(generator, variables, step)
            _, per_sample, _ = self._forward_loss(variables, ctx)
        return per_sample
