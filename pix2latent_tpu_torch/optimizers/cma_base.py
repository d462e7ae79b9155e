"""The search drivers' shared loop, and the CMA optimizer mixin (counterpart
of ``pix2latent_tpu/optimizers/cma_base.py``).

:class:`_StrategyDriver` holds what a driver does between the variable
manager and an ask/tell strategy, whatever the strategy: the asked
population, the inner Adam run and tell of one generation, the fused
generation, the fused meta loop and final run, and the host loops of the
eval-only and hybrid drivers. A mixin says how to ask and tell
(:meth:`_ask`, :meth:`_tell`) and where the state lives (``_state_attr``):
:class:`_BaseCMAOptimizer` on ``strategies/cma.py``, ``_BaseNGOptimizer``
(``optimizers/ng_base.py``) on the strategy registry.

On a population mesh (``parallel/mesh.py``) every rank asks the full
population, from a search state and a generator replicated at the setup
(:meth:`_StrategyDriver._replicate_search`), and keeps its rows
(``ExecutionCore.place``); the tell losses come back gathered, and every
rank runs the same tell.
"""

from __future__ import annotations

import time
from typing import Optional

import numpy as np

from pix2latent_tpu_torch.parallel.mesh import pad_population
from pix2latent_tpu_torch.strategies import cma
from pix2latent_tpu_torch.utils.checkpoint import (FusedCheckpointer,
                                                   LoopCheckpointer,
                                                   final_checkpoint)
from pix2latent_tpu_torch.utils.misc import (Timer, cprint, progress_print,
                                             to_numpy)


class _StrategyDriver:
    """Mixin used with ``_BaseOptimizer``: one variable, flagged
    ``grad_free``, is searched by an ask/tell strategy whose state is the
    attribute ``_state_attr``."""

    _state_attr = "cma_state"

    def __init__(self):
        self.num_samples = -1
        self._gf_var = None          # (var_type, name, shape)
        self._sampled = None         # last asked candidates [pop, dim]
        self._ask_aux = None         # what the last ask passes to its tell

    # -- what a mixin provides ------------------------------------------ #

    def _ask(self, state):
        """``(candidates [pop, dim], aux)`` from ``state``."""
        raise NotImplementedError

    def _tell(self, state, x, loss, aux):
        """The state after telling ``loss`` of the candidates ``x``."""
        raise NotImplementedError

    def _fused_gen_key(self, grad_steps: int):
        """The key of the fused generation's memo; None builds it anew."""
        raise NotImplementedError

    # -- one generation ------------------------------------------------- #

    @property
    def _search_state(self):
        return getattr(self, self._state_attr)

    @_search_state.setter
    def _search_state(self, state):
        setattr(self, self._state_attr, state)

    def _replicate_search(self):
        """On a mesh, the search state and the generator's state as rank 0
        holds them, on every rank: one broadcast at the setup."""
        if self.mesh is None:
            return
        rep = self.core.place_replicated(
            {"state": self._search_state,
             "generator": self.generator.get_state()})
        self._search_state = rep["state"]
        self.generator.set_state(rep["generator"])

    def _sample(self, state, var_manager=None):
        """A fresh population of ``var_manager`` (default: the driver's)
        with the grad-free variable from an ask of ``state``:
        ``(variables, candidates, aux)``. On a mesh both draws are of the
        full population, and the variables hold this rank's rows; the
        candidates stay whole, for the tell."""
        var_manager = var_manager or self.var_manager
        variables = var_manager.initialize(num_samples=self.num_samples,
                                           generator=self.generator)
        x, aux = self._ask(state)
        var_type, name, shape = self._gf_var
        variables[var_type][name] = x.reshape(self.num_samples, *shape).clone()
        return self.core.place(variables), x, aux

    def _ask_population(self, var_manager=None):
        """A fresh population asked of the current state; the candidates
        and the ask's aux are kept for the tell."""
        variables, self._sampled, self._ask_aux = self._sample(
            self._search_state, var_manager)
        return variables

    def _update(self, variables, loss=None, step=0, inverted=True):
        """Tell the strategy the fitness of the last asked population (a
        fresh tell loss of ``variables`` when ``loss`` is None)."""
        if loss is None:
            loss = self.core.tell_loss(variables, self.generator, step,
                                       inverted=inverted)
        self._search_state = self._tell(self._search_state, self._sampled,
                                        loss, self._ask_aux)
        return loss

    def _refine_tell(self, variables, x, state, grad_steps: int,
                     gen_idx: int, inner_kwargs=None, aux=None):
        """After the ask: fresh Adam state, ``grad_steps`` inner steps, the
        tell loss of the refined population with hooks applied, and the tell
        of ``state`` keyed to the asked candidates ``x`` (with the ask's
        ``aux``). The target context is computed once for both. With
        ``inner_kwargs`` the inner steps go through the host loop's
        ``_run_inner`` (logging, tracking, progress; these arguments are
        passed on), else they are queued untracked and nothing is read back.
        Returns ``(new state, tell losses [pop], inner losses [grad_steps,
        pop])``."""
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
        return self._tell(state, x, loss, aux), loss, inner

    def refine_and_tell(self, variables, grad_steps: int, gen_idx: int,
                        inner_kwargs=None):
        """The rest of one generation after the ask, on the current state
        and the candidates of the last ask (see :meth:`_refine_tell`).
        Returns ``(tell losses [pop], inner losses [grad_steps, pop])``."""
        self._search_state, loss, inner = self._refine_tell(
            variables, self._sampled, self._search_state, grad_steps,
            gen_idx, inner_kwargs, aux=self._ask_aux)
        return loss, inner

    # -- the fused generation ------------------------------------------- #

    def _build_fused_generation(self, grad_steps: int):
        """One function per generation, ``(state, gen_idx) -> (state, min
        tell loss)``: a fresh population, the ask, ``grad_steps`` inner
        Adam steps over the whole population (chunked by
        ``max_batch_size``; none for an eval-only generation), the tell loss
        and the tell.

        It queues the generation's work and reads nothing back: the min
        tell loss stays on the device, for the driver to read one
        generation later. A strategy's tell may still sync: the full-
        covariance CMA tell's ``torch.linalg.eigh`` checks the solver's
        status on the host and so waits for all of the generation's work
        queued before it (``PERF.md`` section 5); the other registry
        strategies make no sync, the ``Host:`` ones two."""

        def generation(state, gen_idx):
            variables, x, aux = self._sample(state)
            state, loss, _ = self._refine_tell(variables, x, state,
                                               grad_steps, gen_idx, aux=aux)
            return state, loss.min()

        return generation

    def _get_fused_gen(self, grad_steps: int):
        """The fused generation, memoised on :meth:`_fused_gen_key`."""
        key = self._fused_gen_key(grad_steps)
        if key is None:
            return self._build_fused_generation(grad_steps)
        if not hasattr(self, "_fused_gens"):
            self._fused_gens = {}
        if key not in self._fused_gens:
            self._fused_gens[key] = self._build_fused_generation(grad_steps)
        return self._fused_gens[key]

    def _fused_meta_loop(self, gen_fn, meta_steps, label, checkpoint_path,
                         checkpoint_every, progress_every):
        """Run ``gen_fn`` for the generations left of ``meta_steps``: resume
        from ``checkpoint_path`` (strategy state and generator state),
        record each generation's min tell loss in ``self.losses`` one
        generation behind (reading the previous generation's loss after the
        next one is queued), its host seconds in ``self.gen_seconds``, and
        save the carry entering each generation once it has run. Returns
        whether a generation ran."""
        state = self._search_state
        ckpt = FusedCheckpointer(checkpoint_path, label,
                                 every=checkpoint_every, mesh=self.mesh)
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
        self._search_state = state
        ckpt.finalize(meta_steps, {"state": state,
                                   "generator": self.generator.get_state()})
        return start < meta_steps

    def _fused_final(self, n_steps, start_step, checkpoint_path,
                     checkpoint_every):
        """The fused drivers' last run: a fresh ask, then ``n_steps`` Adam
        steps (an evaluation when 0), untracked and unlogged, resumable from
        ``checkpoint_path`` (see ``utils/checkpoint.py:final_checkpoint``).
        Returns the variables."""
        variables = self._ask_population()
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

    def _fused_run(self, meta_steps, grad_steps, final_steps, final_start,
                   label, checkpoint_path, checkpoint_every, progress_every):
        """A fused driver after its setup: the meta loop of
        ``grad_steps``-step generations, then :meth:`_fused_final`.
        Returns ``(variables, outs, losses)``."""
        self.losses, self.outs, self.gen_seconds = [], [], []
        ran = self._fused_meta_loop(self._get_fused_gen(grad_steps),
                                    meta_steps, label, checkpoint_path,
                                    checkpoint_every, progress_every)
        variables = self._fused_final(final_steps, final_start,
                                      final_checkpoint(checkpoint_path, ran,
                                                       self.mesh),
                                      checkpoint_every)
        return self._final_results(variables, final_start + final_steps)

    # -- the host loops ------------------------------------------------- #

    def _eval_loop(self, meta_steps, grad_steps, pbar, checkpoint_path,
                   checkpoint_every):
        """The JAX package's eval-only host loop, after the setup: each
        generation asks, evaluates the population (hooks applied; logged),
        and tells a fresh tell loss, as the reference does; the best tell
        loss of every generation lands in ``self.losses`` (without
        logging). Then ``grad_steps`` Adam steps on a final ask. Returns
        ``(variables, outs, losses)``."""
        self.losses, self.outs = [], []
        total_steps = meta_steps + grad_steps
        timer = Timer()
        ckpt = LoopCheckpointer(checkpoint_path, self, self._state_attr,
                                every=checkpoint_every)
        start = ckpt.resume()
        for i in range(start, meta_steps):
            variables = self._ask_population()
            self.out, loss = self.core.eval(variables, self.generator, i)
            self.loss = to_numpy(loss)
            if self.log and (i + 1) % self.log_iter == 0:
                self.log_result(variables, i + 1)
            tell = self._update(variables, step=i)
            if not self.log:
                self.losses.append(float(tell.min()))
            ckpt.save(i + 1)
            if pbar is not None:
                pbar.progress((i + 1) / total_steps)
            elif (i + 1) % self.show_iter == 0:
                progress_print("optimize", i + 1, total_steps, "c",
                               timer.avg(self.show_iter))
                timer.reset()

        # Adam finetune of a final ask
        variables = self._ask_population()
        variables = self.core.apply_transforms(variables)
        variables, optimizer = self.core.init_opt_state(variables)
        variables, _, _, _ = self._run_inner(
            variables, optimizer, grad_steps, start_step=meta_steps,
            pbar=pbar, total_steps=total_steps, timer=timer,
            checkpoint_path=final_checkpoint(checkpoint_path,
                                             start < meta_steps, self.mesh),
            checkpoint_every=checkpoint_every)
        return self._final_results(variables, total_steps)

    def _hybrid_loop(self, meta_steps, grad_steps, last_grad_steps, pbar,
                     checkpoint_path, checkpoint_every, progress_every,
                     label):
        """The hybrid host loop, after the setup: each generation asks,
        refines the population by ``grad_steps`` Adam steps and tells the
        refined loss keyed to the asked candidates; a final population runs
        ``last_grad_steps`` and skips the tell. Without logging, the best
        tell loss of every generation lands in ``self.losses``; its wall
        time in ``self.gen_seconds`` (reading the loss waits for the
        device). Returns ``(variables, outs, losses)``."""
        self.losses, self.outs, self.gen_seconds = [], [], []
        total_steps = meta_steps * grad_steps + last_grad_steps
        timer = Timer()
        ckpt = LoopCheckpointer(checkpoint_path, self, self._state_attr,
                                every=checkpoint_every)
        start = ckpt.resume()
        progress = dict(pbar=pbar, total_steps=total_steps, timer=timer)

        for gi in range(start, meta_steps):
            t0 = time.perf_counter()
            loss, _ = self.refine_and_tell(self._ask_population(),
                                           grad_steps, gi, progress)
            if not self.log:
                self.losses.append(float(loss.min()))
            self.gen_seconds.append(time.perf_counter() - t0)
            ckpt.save(gi + 1)
            if progress_every and (gi + 1) % progress_every == 0:
                cprint(f"({label}) gen {gi + 1}/{meta_steps} min tell loss "
                       f"{float(loss.min()):.4f} ({self.gen_seconds[-1]:.3f} "
                       "s/gen)", "c")

        # final population: Adam only, no tell
        variables = self._ask_population()
        variables = self.core.apply_transforms(variables)
        variables, optimizer = self.core.init_opt_state(variables)
        variables, _, _, _ = self._run_inner(
            variables, optimizer, last_grad_steps, meta_steps * grad_steps,
            checkpoint_path=final_checkpoint(checkpoint_path,
                                             start < meta_steps, self.mesh),
            checkpoint_every=checkpoint_every, **progress)
        return self._final_results(variables, total_steps)


class _BaseCMAOptimizer(_StrategyDriver):
    """The search by CMA-ES (``strategies/cma.py``)."""

    def __init__(self):
        super().__init__()
        self.cma_params = None
        self.cma_state = None

    def setup_cma(self, var_manager, popsize: Optional[int] = None,
                  active: bool = False):
        """Initialize CMA for the single ``grad_free`` variable; a
        ``(mu, sigma)`` tuple there seeds the search distribution. On a mesh
        the population is padded to a multiple of its ranks."""
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
        popsize = pad_population(popsize, self.mesh)
        self.cma_params, self.cma_state = cma.init(
            mu, sigma, popsize, active=active, device=var_manager.device)
        self._replicate_search()
        self.num_samples = popsize
        self._gf_var = (var_type, name, shape)
        cprint(f"(cma-es) number of samples: {self.num_samples}", "y")

    def _ask(self, state):
        return cma.ask(self.cma_params, state, self.generator), None

    def _tell(self, state, x, loss, aux):
        return cma.tell(self.cma_params, state, x, loss)

    def _fused_gen_key(self, grad_steps: int):
        # the step count, the population, aCMA and the grad-free variable
        return (grad_steps, self.cma_params.popsize, self.cma_params.active,
                self._gf_var)

    def cma_init(self, var_manager):
        """A fresh population with the grad-free variable from a CMA ask;
        the asked candidates are kept for the tell."""
        return self._ask_population(var_manager)

    def cma_update(self, variables, loss=None, step=0):
        """Tell CMA the fitness of the population (a fresh tell loss when
        ``loss`` is None), keyed to the ASKED candidates."""
        return self._update(variables, loss, step)
