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
from pix2latent_tpu_torch.utils.checkpoint import (LoopCheckpointer,
                                                   final_checkpoint)
from pix2latent_tpu_torch.utils.misc import Timer, cprint


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
        self.losses, self.outs, self.gen_seconds = [], [], []
        ran = self._fused_meta_loop(self._get_fused_gen(grad_steps),
                                    meta_steps, "basin-cma fused",
                                    checkpoint_path, checkpoint_every,
                                    progress_every)
        variables = self._fused_final(
            last_grad_steps, meta_steps * grad_steps,
            final_checkpoint(checkpoint_path, ran), checkpoint_every)
        return self._final_results(variables,
                                   meta_steps * grad_steps + last_grad_steps)

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
        self.losses, self.outs, self.gen_seconds = [], [], []
        total_steps = meta_steps * grad_steps + last_grad_steps
        timer = Timer()
        ckpt = LoopCheckpointer(checkpoint_path, self, "cma_state",
                                every=checkpoint_every)
        start = ckpt.resume()
        progress = dict(pbar=pbar, total_steps=total_steps, timer=timer)

        for gi in range(start, meta_steps):
            t0 = time.perf_counter()
            loss, _ = self.refine_and_tell(self.cma_init(self.var_manager),
                                           grad_steps, gi, progress)
            if not self.log:
                self.losses.append(float(loss.min()))
            self.gen_seconds.append(time.perf_counter() - t0)
            ckpt.save(gi + 1)
            if progress_every and (gi + 1) % progress_every == 0:
                cprint(f"(basin-cma) gen {gi + 1}/{meta_steps} min tell loss "
                       f"{float(loss.min()):.4f} ({self.gen_seconds[-1]:.3f} "
                       "s/gen)", "c")

        # final population: Adam only, no tell
        variables = self.cma_init(self.var_manager)
        variables = self.core.apply_transforms(variables)
        variables, optimizer = self.core.init_opt_state(variables)
        variables, _, _, _ = self._run_inner(
            variables, optimizer, last_grad_steps, meta_steps * grad_steps,
            checkpoint_path=final_checkpoint(checkpoint_path,
                                             start < meta_steps),
            checkpoint_every=checkpoint_every, **progress)
        return self._final_results(variables, total_steps)
