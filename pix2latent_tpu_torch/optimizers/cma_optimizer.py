"""CMA-ES inversion with optional Adam finetuning (counterpart of
``pix2latent_tpu/optimizers/cma_optimizer.py``): ``meta_steps``
gradient-free ask -> evaluate -> tell generations, then one final ask whose
samples are finetuned with ``grad_steps`` Adam updates."""

from __future__ import annotations

from pix2latent_tpu_torch.optimizers.base import _BaseOptimizer
from pix2latent_tpu_torch.optimizers.cma_base import _BaseCMAOptimizer


class CMAOptimizer(_BaseOptimizer, _BaseCMAOptimizer):

    def __init__(self, *args, **kwargs):
        _BaseOptimizer.__init__(self, *args, **kwargs)
        _BaseCMAOptimizer.__init__(self)

    def optimize(self, meta_steps, grad_steps=0, num_samples=None,
                 popsize=None, active=False):
        """The JAX package's host loop: each generation asks CMA, evaluates
        the population (hooks applied), and tells CMA a fresh tell loss, as
        the reference does; the best tell loss of every generation lands in
        ``self.losses``. ``num_samples`` must be None: CMA's population size
        (``popsize``, default ``4 + floor(3 ln n)``) fixes it.
        Returns ``(variables, [out], [[total_steps, {"loss": ...}]])``."""
        if num_samples is not None:
            raise ValueError("the CMA optimizer has a fixed sample size; "
                             "set popsize instead")
        self.setup_cma(self.var_manager, popsize=popsize, active=active)
        self.losses, self.outs = [], []
        for i in range(meta_steps):
            variables = self.cma_init(self.var_manager)
            self.out, loss = self.core.eval(variables, self.generator, i)
            self.loss = loss.cpu().numpy()
            tell = self.cma_update(variables, step=i)
            self.losses.append(float(tell.min()))

        variables = self.cma_init(self.var_manager)
        variables, optimizer = self.core.init_opt_state(variables)
        variables, _, _, _ = self._run_inner(variables, optimizer, grad_steps,
                                             start_step=meta_steps)
        return self._final_results(variables, meta_steps + grad_steps)
