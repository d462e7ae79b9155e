"""Pure gradient (Adam) inversion (counterpart of
``pix2latent_tpu/optimizers/gradient.py``): per-variable Adam descent on the
registered inputs of a freshly drawn population."""

from __future__ import annotations

from pix2latent_tpu_torch.optimizers.base import _BaseOptimizer
from pix2latent_tpu_torch.utils.misc import Timer


class GradientOptimizer(_BaseOptimizer):

    def optimize(self, num_samples, grad_steps, pbar=None,
                 checkpoint_path=None, checkpoint_every=1):
        """Draw ``num_samples`` seeds and run ``grad_steps`` Adam updates;
        long runs go by segments, and ``checkpoint_path`` makes the run
        resumable at segment granularity. On a mesh ``num_samples`` must
        split over its ranks.
        Returns ``(variables, outs, losses)`` (``_final_results``)."""
        self.losses, self.outs = [], []
        variables = self.var_manager.initialize(num_samples=num_samples,
                                                generator=self.generator)
        # on a mesh, this rank's rows of the drawn population
        variables = self.core.place(variables)
        # registered transforms act once, before the first step
        variables = self.core.apply_transforms(variables)
        variables, optimizer = self.core.init_opt_state(variables)
        variables, _, _, _ = self._run_inner(
            variables, optimizer, grad_steps, start_step=0, pbar=pbar,
            total_steps=grad_steps, timer=Timer(),
            checkpoint_path=checkpoint_path,
            checkpoint_every=checkpoint_every)
        return self._final_results(variables, grad_steps)
