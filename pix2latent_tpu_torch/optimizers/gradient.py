"""Pure gradient (Adam) inversion (counterpart of
``pix2latent_tpu/optimizers/gradient.py``): per-variable Adam descent on the
registered inputs of a freshly drawn population."""

from __future__ import annotations

from pix2latent_tpu_torch.optimizers.base import _BaseOptimizer


class GradientOptimizer(_BaseOptimizer):

    def optimize(self, num_samples, grad_steps):
        """Draw ``num_samples`` seeds and run ``grad_steps`` Adam updates.
        Returns ``(variables, [out], [[grad_steps, {"loss": ...}]])``."""
        self.losses, self.outs = [], []
        variables = self.var_manager.initialize(num_samples=num_samples,
                                                generator=self.generator)
        variables, optimizer = self.core.init_opt_state(variables)
        variables, _, _, _ = self._run_inner(variables, optimizer, grad_steps,
                                             start_step=0)
        return self._final_results(variables, grad_steps)
