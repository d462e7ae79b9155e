"""CMA optimizer mixin: ask/tell bookkeeping between the VariableManager and
the on-device CMA-ES (counterpart of ``pix2latent_tpu/optimizers/cma_base.py``).
"""

from __future__ import annotations

import time
from typing import Optional

import numpy as np

from pix2latent_tpu_torch.strategies import cma
from pix2latent_tpu_torch.utils.checkpoint import FusedCheckpointer
from pix2latent_tpu_torch.utils.misc import cprint, to_numpy


class _BaseCMAOptimizer:
    """Mixin used with ``_BaseOptimizer``. One variable, flagged
    ``grad_free``, is searched by CMA."""

    def __init__(self):
        self.num_samples = -1
        self.cma_params = None
        self.cma_state = None
        self._gf_var = None          # (var_type, name, shape)
        self._sampled = None         # last asked candidates [pop, dim]

    def setup_cma(self, var_manager, popsize: Optional[int] = None,
                  active: bool = False):
        """Initialize CMA for the single ``grad_free`` variable; a
        ``(mu, sigma)`` tuple there seeds the search distribution."""
        gf = var_manager.grad_free_variables()
        if len(gf) != 1:
            raise ValueError("exactly one variable can be optimized via CMA "
                             f"but got: {[(vt, n) for vt, n, _ in gf]}")
        var_type, name, spec = gf[0]
        shape = spec["shape"]
        dim = int(np.prod(shape))

        sigma = 1.0
        mu = np.zeros(dim, np.float32)
        if isinstance(spec["grad_free"], tuple):
            m, s = spec["grad_free"]
            if m is not None:
                mu = np.asarray(m, np.float32).reshape(-1)
                if mu.size != dim:
                    raise ValueError(f"CMA mean has {mu.size} values, "
                                     f"expected {dim}")
            if s is not None:
                sigma = float(s)

        if popsize is None:
            popsize = cma.default_popsize(dim)
        self.cma_params, self.cma_state = cma.init(
            mu, sigma, popsize, active=active, device=var_manager.device)
        self.num_samples = popsize
        self._gf_var = (var_type, name, shape)
        cprint(f"(cma-es) number of samples: {self.num_samples}", "y")

    def cma_init(self, var_manager):
        """A fresh population with the grad-free variable from a CMA ask;
        the asked candidates are kept for the tell."""
        variables = var_manager.initialize(num_samples=self.num_samples,
                                           generator=self.generator)
        x = cma.ask(self.cma_params, self.cma_state, self.generator)
        var_type, name, shape = self._gf_var
        variables[var_type][name] = x.reshape(self.num_samples, *shape).clone()
        self._sampled = x
        return variables

    def cma_update(self, variables, loss=None, step=0):
        """Tell CMA the fitness of the population (a fresh tell loss when
        ``loss`` is None), keyed to the ASKED candidates."""
        if loss is None:
            loss = self.core.tell_loss(variables, self.generator, step)
        self.cma_state = cma.tell(self.cma_params, self.cma_state,
                                  self._sampled, loss)
        return loss

    def _refine_tell(self, variables, x, state, grad_steps: int,
                     gen_idx: int, inner_kwargs=None):
        """After the ask: fresh Adam state, ``grad_steps`` inner steps, the
        tell loss of the refined population with hooks applied, and the CMA
        tell of ``state`` keyed to the asked candidates ``x``. The target
        context is computed once for both. With ``inner_kwargs`` the inner
        steps go through the host loop's ``_run_inner`` (logging, tracking,
        progress; these arguments are passed on), else they are queued
        untracked and nothing is read back. Returns
        ``(new state, tell losses [pop], inner losses [grad_steps, pop])``."""
        core = self.core
        variables = core._dedupe_outputs(core.apply_transforms(variables))
        ctx = core.make_ctx(variables)
        inner = None
        if grad_steps:
            variables, optimizer = core.init_opt_state(variables)
            start = gen_idx * grad_steps
            if inner_kwargs is None:
                variables, _, _, ys = core.grad_steps(
                    variables, optimizer, self.generator, grad_steps,
                    start_step=start, ctx=ctx, track=False)
                inner = ys["loss"]
            else:
                variables, _, _, inner = self._run_inner(
                    variables, optimizer, grad_steps, start, ctx=ctx,
                    **inner_kwargs)
        loss = core.tell_loss(variables, self.generator,
                              step=gen_idx * grad_steps + grad_steps, ctx=ctx)
        return cma.tell(self.cma_params, state, x, loss), loss, inner

    def refine_and_tell(self, variables, grad_steps: int, gen_idx: int,
                        inner_kwargs=None):
        """The rest of one generation after the ask (``cma_init``), on
        ``self.cma_state`` and the candidates of the last ask (see
        :meth:`_refine_tell`). Returns ``(tell losses [pop], inner losses
        [grad_steps, pop])``."""
        self.cma_state, loss, inner = self._refine_tell(
            variables, self._sampled, self.cma_state, grad_steps, gen_idx,
            inner_kwargs)
        return loss, inner

    # -- the fused generation (shared by BasinCMA and CMA) --------------- #

    def _build_fused_generation(self, grad_steps: int):
        """One function per generation, ``(state, gen_idx) -> (state, min
        tell loss)``: a fresh population, the CMA ask, ``grad_steps`` inner
        Adam steps over the whole population (chunked by ``max_batch_size``;
        none for an eval-only generation), the tell loss and the CMA update.

        It queues the generation's work and reads nothing back: the min
        tell loss stays on the device, for the driver to read one
        generation later. The one host sync left in it is inside
        ``torch.linalg.eigh`` of the CMA tell, which checks the solver's
        status on the host and so waits for all of the generation's work
        queued before it (``PERF.md`` section 5)."""
        var_type, name, shape = self._gf_var
        n = self.num_samples

        def generation(state, gen_idx):
            variables = self.var_manager.initialize(num_samples=n,
                                                    generator=self.generator)
            x = cma.ask(self.cma_params, state, self.generator)
            variables[var_type][name] = x.reshape(n, *shape).clone()
            state, loss, _ = self._refine_tell(variables, x, state,
                                               grad_steps, gen_idx)
            return state, loss.min()

        return generation

    def _get_fused_gen(self, grad_steps: int):
        """The fused generation, memoised on what it is built from: the step
        count, the population, aCMA and the grad-free variable."""
        if not hasattr(self, "_fused_gens"):
            self._fused_gens = {}
        key = (grad_steps, self.cma_params.popsize, self.cma_params.active,
               self._gf_var)
        if key not in self._fused_gens:
            self._fused_gens[key] = self._build_fused_generation(grad_steps)
        return self._fused_gens[key]

    def _fused_meta_loop(self, gen_fn, meta_steps, label, checkpoint_path,
                         checkpoint_every, progress_every):
        """Run ``gen_fn`` for the generations left of ``meta_steps``: resume
        from ``checkpoint_path`` (CMA state and generator state), record
        each generation's min tell loss in ``self.losses`` one generation
        behind (reading the previous generation's loss after the next one is
        queued), its host seconds in ``self.gen_seconds``, and save the
        carry entering each generation once it has run. Returns whether a
        generation ran."""
        state = self.cma_state
        ckpt = FusedCheckpointer(checkpoint_path, label,
                                 every=checkpoint_every)
        start = ckpt.resume({"state": state,
                             "generator": self.generator.get_state()})
        if ckpt.loaded is not None:
            state = ckpt.loaded["state"]
            self.generator.set_state(ckpt.loaded["generator"])

        prev_min = None
        for gi in range(start, meta_steps):
            t0 = time.perf_counter()
            carry_in = {"state": state,
                        "generator": self.generator.get_state()}
            state, gen_min = gen_fn(state, gi)
            if prev_min is not None:
                self.losses.append(float(prev_min))
                if progress_every and gi % progress_every == 0:
                    cprint(f"({label}) gen {gi}/{meta_steps} min tell loss "
                           f"{self.losses[-1]:.4f}", "c")
            prev_min = gen_min
            ckpt.save(gi, carry_in)
            self.gen_seconds.append(time.perf_counter() - t0)
        if prev_min is not None:
            self.losses.append(float(prev_min))
        self.cma_state = state
        ckpt.finalize(meta_steps, {"state": state,
                                   "generator": self.generator.get_state()})
        return start < meta_steps

    def _fused_final(self, n_steps, start_step, checkpoint_path,
                     checkpoint_every):
        """The fused drivers' last run: a fresh ask, then ``n_steps`` Adam
        steps (an evaluation when 0), untracked and unlogged, resumable from
        ``checkpoint_path`` (see ``utils/checkpoint.py:final_checkpoint``).
        Returns the variables."""
        variables = self.cma_init(self.var_manager)
        variables = self.core.apply_transforms(variables)
        variables, optimizer = self.core.init_opt_state(variables)
        if n_steps == 0:
            self.out, loss = self.core.eval(variables, self.generator,
                                            start_step)
        else:
            variables, _, self.out, ys = self.core.grad_steps(
                variables, optimizer, self.generator, n_steps,
                start_step=start_step, track=False,
                checkpoint_path=checkpoint_path,
                checkpoint_every=checkpoint_every)
            loss = ys["loss"][-1]
        self.loss = to_numpy(loss)
        return variables
