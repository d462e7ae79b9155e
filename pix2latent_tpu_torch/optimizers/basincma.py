"""BasinCMA, the flagship hybrid method (counterpart of
``pix2latent_tpu/optimizers/basincma.py``).

For each of ``meta_steps`` generations: ask CMA for a population, refine it
with ``grad_steps`` inner Adam updates, and tell CMA the loss of the refined
samples keyed to the asked candidates. A final population then runs
``last_grad_steps`` Adam steps and skips the tell.
"""

from __future__ import annotations

from pix2latent_tpu_torch.optimizers.base import _BaseOptimizer
from pix2latent_tpu_torch.optimizers.cma_base import _BaseCMAOptimizer


class BasinCMAOptimizer(_BaseOptimizer, _BaseCMAOptimizer):

    def __init__(self, *args, **kwargs):
        _BaseOptimizer.__init__(self, *args, **kwargs)
        _BaseCMAOptimizer.__init__(self)

    def optimize_fused(self, meta_steps, grad_steps, last_grad_steps=300,
                       popsize=None, progress_every=5, active=False,
                       checkpoint_path=None, checkpoint_every=1):
        """BasinCMA with one function per generation that queues the ask,
        the inner Adam loop, the tell and the CMA update and reads nothing
        back (``_build_fused_generation``). Each generation's min tell loss
        lands in ``self.losses`` one generation behind, as in the JAX
        package, and its host seconds in ``self.gen_seconds``. Eagerly run,
        this saves no wait: the tell's ``eigh`` makes the host wait for the
        whole generation, so the host syncs once a generation, there, and
        the loss read and the checkpoint save after it find their data
        ready (``PERF.md`` section 5). ``checkpoint_path`` makes the generation loop
        resumable, and the final run too, from its own checkpoint
        ``checkpoint_path + ".final"`` (``utils/checkpoint.py:
        final_checkpoint``); the generator's state replays from
        the finished loop's checkpoint, so a resumed final run sees the
        draws of the uninterrupted one. ``progress_every`` prints the tell
        loss every k generations. Returns ``(variables, outs, losses)``."""
        self.setup_cma(self.var_manager, popsize=popsize, active=active)
        return self._fused_run(meta_steps, grad_steps, last_grad_steps,
                               meta_steps * grad_steps, "basin-cma fused",
                               checkpoint_path, checkpoint_every,
                               progress_every)

    def optimize(self, meta_steps, grad_steps, last_grad_steps=300,
                 pbar=None, num_samples=None, popsize=None,
                 checkpoint_path=None, checkpoint_every=1, active=False,
                 progress_every=0):
        """Run the search from the host, generation by generation. Without
        logging, the best tell loss of every generation lands in
        ``self.losses``; its wall time lands in ``self.gen_seconds`` (reading
        the loss waits for the device). ``checkpoint_path`` saves the CMA
        state, the generator's state and the generation count every
        ``checkpoint_every`` generations and resumes from them; the final
        run resumes from ``checkpoint_path + ".final"``. ``progress_every``
        prints the tell loss every k generations.
        Returns ``(variables, outs, losses)``."""
        if num_samples is not None:
            raise ValueError("the CMA optimizer has a fixed sample size; "
                             "set popsize instead")
        self.setup_cma(self.var_manager, popsize=popsize, active=active)
        return self._hybrid_loop(meta_steps, grad_steps, last_grad_steps,
                                 pbar, checkpoint_path, checkpoint_every,
                                 progress_every, "basin-cma")
