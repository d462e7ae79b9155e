"""Gradient-free and hybrid drivers over the strategy registry (counterpart
of ``pix2latent_tpu/optimizers/ng_optimizer.py``; the reference's
``NevergradOptimizer``, ``pix2latent/optimizer/ng_optimizer.py:14-91``, and
``HybridNevergradOptimizer``, ``hybrid_ng_optimizer.py:12-81``): the same
``optimize`` signatures, a free population size, the strategy chosen by
name (``strategies/registry.py``, or ``Host:<name>``).

Each driver has the host loop (``optimize``) and the fused one
(``optimize_fused``: one function per generation that reads nothing back;
see ``optimizers/cma_base.py:_StrategyDriver._build_fused_generation``).
All four return ``(variables, outs, losses)``. ``checkpoint_path`` makes a
run resumable, the final Adam run from ``checkpoint_path + ".final"``,
which a run whose meta loop ran a generation starts afresh
(``utils/checkpoint.py:final_checkpoint``).
"""

from __future__ import annotations

from pix2latent_tpu_torch.optimizers.base import _BaseOptimizer
from pix2latent_tpu_torch.optimizers.ng_base import _BaseNGOptimizer


class NevergradOptimizer(_BaseOptimizer, _BaseNGOptimizer):
    """Gradient-free generations, then an Adam finetune of a final ask."""

    def __init__(self, method, *args, **kwargs):
        _BaseOptimizer.__init__(self, *args, **kwargs)
        _BaseNGOptimizer.__init__(self, method=method)

    def optimize(self, num_samples, meta_steps, grad_steps=0, pbar=None,
                 checkpoint_path=None, checkpoint_every=1):
        """The reference's loop (``ng_optimizer.py:22-91``): ``meta_steps``
        ask -> evaluate -> tell generations at population ``num_samples``,
        each evaluating twice (a logged evaluation, then a fresh tell
        loss), then ``grad_steps`` Adam steps on a final ask. Without
        logging, each generation's best tell loss lands in
        ``self.losses``."""
        self._setup(num_samples, meta_steps, checkpoint_path)
        return self._eval_loop(meta_steps, grad_steps, pbar, checkpoint_path,
                               checkpoint_every)

    def optimize_fused(self, num_samples, meta_steps, grad_steps=0,
                       progress_every=100, checkpoint_path=None,
                       checkpoint_every=1):
        """Eval-only generations, each one function that queues the ask,
        one evaluation of the population, and the tell with that loss, then
        ``grad_steps`` Adam steps on a final ask (an evaluation when 0).
        The host loop evaluates twice a generation; this once. Each
        generation's min tell loss lands in ``self.losses`` one generation
        behind, its host seconds in ``self.gen_seconds``."""
        self._setup(num_samples, meta_steps, checkpoint_path)
        return self._fused_run(meta_steps, 0, grad_steps, meta_steps,
                               f"fused eval-only {self.method}",
                               checkpoint_path, checkpoint_every,
                               progress_every)


class HybridNevergradOptimizer(_BaseOptimizer, _BaseNGOptimizer):
    """BasinCMA's loop with a registry strategy outside: each generation
    asks a population, refines it by ``grad_steps`` Adam steps and tells the
    refined loss keyed to the asked candidates; the last population runs
    ``last_grad_steps`` and skips the tell."""

    def __init__(self, method, *args, **kwargs):
        _BaseOptimizer.__init__(self, *args, **kwargs)
        _BaseNGOptimizer.__init__(self, method=method)

    def optimize(self, num_samples, meta_steps, grad_steps,
                 last_grad_steps=300, pbar=None, checkpoint_path=None,
                 checkpoint_every=1):
        """The reference's loop (``hybrid_ng_optimizer.py:23-75``) from the
        host. Without logging, each generation's best tell loss lands in
        ``self.losses`` and its wall time in ``self.gen_seconds``."""
        self._setup(num_samples, meta_steps, checkpoint_path)
        return self._hybrid_loop(meta_steps, grad_steps, last_grad_steps,
                                 pbar, checkpoint_path, checkpoint_every,
                                 0, f"hybrid-{self.method}")

    def optimize_fused(self, num_samples, meta_steps, grad_steps,
                       last_grad_steps=300, progress_every=5,
                       checkpoint_path=None, checkpoint_every=1):
        """The hybrid loop with one function per generation that queues the
        ask, the inner Adam loop and the tell and reads nothing back; only
        a full-covariance CMA tell's ``eigh`` syncs inside it. Each
        generation's min tell loss lands in ``self.losses`` one generation
        behind, its host seconds in ``self.gen_seconds``."""
        self._setup(num_samples, meta_steps, checkpoint_path)
        return self._fused_run(meta_steps, grad_steps, last_grad_steps,
                               meta_steps * grad_steps,
                               f"fused hybrid-{self.method}",
                               checkpoint_path, checkpoint_every,
                               progress_every)
