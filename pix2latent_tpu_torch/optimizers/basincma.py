"""BasinCMA, the flagship hybrid method (counterpart of
``pix2latent_tpu/optimizers/basincma.py``).

For each of ``meta_steps`` generations: ask CMA for a population, refine it
with ``grad_steps`` inner Adam updates, and tell CMA the loss of the refined
samples keyed to the asked candidates. A final population then runs
``last_grad_steps`` Adam steps and skips the tell.
"""

from __future__ import annotations

import time

from pix2latent_tpu_torch.optimizers.base import _BaseOptimizer
from pix2latent_tpu_torch.optimizers.cma_base import _BaseCMAOptimizer
from pix2latent_tpu_torch.utils.misc import cprint


class BasinCMAOptimizer(_BaseOptimizer, _BaseCMAOptimizer):

    def __init__(self, *args, **kwargs):
        _BaseOptimizer.__init__(self, *args, **kwargs)
        _BaseCMAOptimizer.__init__(self)

    def optimize(self, meta_steps, grad_steps, last_grad_steps=300,
                 popsize=None, active=False, progress_every=0):
        """Run the search. The best tell loss of every generation lands in
        ``self.losses`` and its wall time in ``self.gen_seconds`` (reading
        the loss waits for the device); ``progress_every`` prints them every
        k generations.
        Returns ``(variables, [out], [[total_steps, {"loss": ...}]])``."""
        self.setup_cma(self.var_manager, popsize=popsize, active=active)
        self.losses, self.outs, self.gen_seconds = [], [], []
        total_steps = meta_steps * grad_steps + last_grad_steps
        for gi in range(meta_steps):
            t0 = time.perf_counter()
            loss, _ = self.generation(grad_steps, gi)
            self.losses.append(float(loss.min()))
            self.gen_seconds.append(time.perf_counter() - t0)
            if progress_every and (gi + 1) % progress_every == 0:
                cprint(f"(basin-cma) gen {gi + 1}/{meta_steps} min tell loss "
                       f"{self.losses[-1]:.4f} ({self.gen_seconds[-1]:.3f} "
                       "s/gen)", "c")

        # final population: Adam only, no tell
        variables = self.cma_init(self.var_manager)
        variables, optimizer = self.core.init_opt_state(variables)
        variables, _, _, _ = self._run_inner(
            variables, optimizer, last_grad_steps,
            start_step=meta_steps * grad_steps)
        return self._final_results(variables, total_steps)

    # PyTorch runs eagerly: there is no one-program generation to fuse, so
    # the JAX package's fused entry point is the same method here.
    optimize_fused = optimize
