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

    def optimize_fused(self, meta_steps, grad_steps=0, popsize=None,
                       active=False, progress_every=25,
                       checkpoint_path=None, checkpoint_every=1):
        """Eval-only CMA generations, each one function that queues the
        ask, the population's evaluation, the tell and the CMA update
        without reading anything back (``_build_fused_generation``), then
        ``grad_steps`` Adam steps on a final ask.

        Each generation evaluates the population once and tells that loss;
        :meth:`optimize`, like the JAX package's host loop, evaluates twice
        with different hook noise (a logged evaluation and a fresh tell).
        Per-generation min tell losses land in ``self.losses`` one
        generation behind; ``checkpoint_path`` makes the meta loop and the
        finetune resumable. Returns ``(variables, outs, losses)``."""
        self.setup_cma(self.var_manager, popsize=popsize, active=active)
        return self._fused_run(meta_steps, 0, grad_steps, meta_steps,
                               "cma fused", checkpoint_path, checkpoint_every,
                               progress_every)

    def optimize(self, meta_steps, grad_steps=0, pbar=None, num_samples=None,
                 popsize=None, checkpoint_path=None, checkpoint_every=1,
                 active=False):
        """The JAX package's host loop: each generation asks CMA, evaluates
        the population (hooks applied), and tells CMA a fresh tell loss, as
        the reference does; the best tell loss of every generation lands in
        ``self.losses`` (without logging). ``num_samples`` must be None:
        CMA's population size (``popsize``, default ``4 + floor(3 ln n)``)
        fixes it. ``checkpoint_path`` makes the generation loop and the
        finetune resumable. Returns ``(variables, outs, losses)``."""
        if num_samples is not None:
            raise ValueError("the CMA optimizer has a fixed sample size; "
                             "set popsize instead")
        self.setup_cma(self.var_manager, popsize=popsize, active=active)
        return self._eval_loop(meta_steps, grad_steps, pbar, checkpoint_path,
                               checkpoint_every)
