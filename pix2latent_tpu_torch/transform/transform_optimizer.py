"""Transform-search BasinCMA with variable propagation (counterpart of
``pix2latent_tpu/transform/transform_optimizer.py``).

CMA searches the transform parameter ``t`` while an inner Adam loop
re-optimizes the latent against the target warped by each candidate. The
CMA tell scores each candidate in the un-warped frame
(``ExecutionCore.tell_loss``). *Variable propagation* carries an EMA of
the best-loss latent across generations and resamples each new population
around it with annealed noise, renormalized per sample.
``optimize_fused_batched`` runs M such searches, each with its own CMA
state, propagation means, candidate and ``torch.Generator``, their
populations through the generator together.
"""

from __future__ import annotations

import math
import time

import numpy as np
import torch

from pix2latent_tpu_torch.optimizers.base import _BaseOptimizer
from pix2latent_tpu_torch.optimizers.cma_base import _BaseCMAOptimizer
from pix2latent_tpu_torch.strategies import cma
from pix2latent_tpu_torch.utils.checkpoint import (FusedCheckpointer,
                                                   LoopCheckpointer,
                                                   final_checkpoint)
from pix2latent_tpu_torch.utils.image import smart_resize, to_grid, to_image
from pix2latent_tpu_torch.utils.misc import Timer, to_numpy


def _best_index(loss):
    """``(loss with every non-finite value set to inf, index of its minimum
    as a one-element tensor)``, both on the loss's device: a non-finite
    candidate (a near-zero scale, whose inverse warp divides by about 0)
    loses."""
    loss = torch.where(torch.isfinite(loss), loss,
                       torch.full_like(loss, math.inf))
    return loss, loss.argmin().reshape(1)


def _ema(mean, data, best, ema_beta):
    """One EMA step of ``mean`` toward row ``best`` of ``data``; the row is
    taken by ``index_select``, which reads no index back to the host."""
    return (1.0 - ema_beta) * mean + ema_beta * data.index_select(0, best)[0]


class TransformBasinCMAOptimizer(_BaseOptimizer, _BaseCMAOptimizer):

    def __init__(self, *args, **kwargs):
        _BaseOptimizer.__init__(self, *args, **kwargs)
        _BaseCMAOptimizer.__init__(self)
        self.variables_to_propagate = []
        self.vp_means = {}
        # names whose vp_means hold a real statistic, not a zero placeholder
        # kept for the checkpoint's structure
        self._vp_seeded = set()
        self._best_loss, self._candidate = math.inf, None
        self.transform_outs, self.transform_tracked = [], []
        self.gen_seconds = []
        self.final_tell = None

    # -- variable propagation -------------------------------------------- #

    def set_variable_propagation(self, variable_name):
        """Mark an input variable whose best value seeds the next
        generation."""
        if variable_name in self.variables_to_propagate:
            print(f"variable {variable_name} already exists")
            return
        self.variables_to_propagate.append(variable_name)

    def del_variable_propagation(self, variable_name):
        if variable_name in self.variables_to_propagate:
            self.variables_to_propagate.remove(variable_name)

    def _check_propagated(self):
        info = self.var_manager.variable_info
        for name in self.variables_to_propagate:
            if info.get(name, {}).get("var_type") != "input":
                raise RuntimeError(
                    f"variable propagation is set for {name} but no such "
                    "variable was found")

    def update_propagation_variable_statistic(self, variables, loss,
                                              ema_beta=0.5):
        """EMA (``ema_beta``) of each propagated variable toward the
        best-loss sample's value; a non-finite loss loses. The first call
        starts from the population mean."""
        self._check_propagated()
        _, best = _best_index(torch.as_tensor(loss, device=self.device))
        for name in self.variables_to_propagate:
            data = variables["input"][name].detach()
            if name not in self._vp_seeded:
                self.vp_means[name] = data.mean(dim=0)
                self._vp_seeded.add(name)
            self.vp_means[name] = _ema(self.vp_means[name], data, best,
                                       ema_beta)

    def _resample(self, data, mean, curr_iter, total_iter, magnitude,
                  renormalize, generator=None):
        """``mean`` plus noise of scale ``magnitude * (1 - curr_iter /
        total_iter)`` drawn from ``generator`` (default: the optimizer's),
        each sample then renormalized to zero mean and unit std (ddof 1)."""
        z_sigma = magnitude * (1.0 - curr_iter / float(total_iter))
        noise = torch.randn(data.shape, generator=generator or self.generator,
                            device=data.device, dtype=data.dtype)
        new = mean[None] + z_sigma * noise
        if renormalize:
            dims = tuple(range(1, new.dim()))
            new = ((new - new.mean(dim=dims, keepdim=True))
                   / (new.std(dim=dims, keepdim=True, correction=1) + 1e-12))
        return new

    def propagate_variable(self, variables, curr_iter, total_iter,
                           magnitude=1.0, renormalize=True):
        """New variables with each propagated variable resampled around its
        EMA mean (see :meth:`_resample`)."""
        self._check_propagated()
        out = {vt: dict(d) for vt, d in variables.items()}
        for name in self.variables_to_propagate:
            data = out["input"][name]
            if name not in self._vp_seeded:
                self.vp_means[name] = data.mean(dim=0)
                self._vp_seeded.add(name)
            out["input"][name] = self._resample(
                data, self.vp_means[name], curr_iter, total_iter, magnitude,
                renormalize)
        return out

    # -- candidate tracking ---------------------------------------------- #

    def get_candidate(self):
        """The best transform parameter found (a numpy array), or None when
        no generation gave a finite loss: the checkpointed search keeps a
        zero placeholder until then, which is no result."""
        if self._candidate is not None and not math.isfinite(self._best_loss):
            return None
        return self._candidate

    def vis_transform(self, variables):
        """Append the collage of the warped target times the weight to
        ``self.transform_outs``."""
        target = to_numpy(variables["output"]["target"])
        weight = to_numpy(variables["output"]["weight"])
        im = to_image(to_grid(target * weight))
        if self.log_resize_factor is not None:
            h, w = im.shape[:2]
            im = smart_resize(im, (int(h * self.log_resize_factor),
                                   int(w * self.log_resize_factor)))
        self.transform_outs.append(im)

    # -- the fused driver ------------------------------------------------ #

    def _run_generation(self, carry, gen_idx, grad_steps, meta_steps,
                        with_tell, start_step, checkpoint_path=None,
                        checkpoint_every=1, inner_kwargs=None):
        """One generation of the search, shared by both drivers: a fresh
        population, the CMA ask of ``t``, variable propagation (from the
        second generation on), the warped targets, ``grad_steps`` inner Adam
        steps from step ``start_step``, the un-warped tell, the CMA update
        (``with_tell``), the EMA toward the best sample and the candidate
        tracking, with the host loop's defaults (EMA beta 0.5, noise
        magnitude 1, renormalized).

        ``carry`` is ``(cma_state, vp_means, best_loss, best_t)``, all on the
        device; without ``inner_kwargs`` nothing is read back, so the one
        host sync is the CMA tell's ``eigh``. ``checkpoint_path`` makes the
        inner Adam run resumable (its saves read the state back). With
        ``inner_kwargs`` the generation is the host loop's: the asked ``t``
        lands in ``self.transform_tracked``, the warped targets in
        ``self.transform_outs`` when logging, and the inner steps go through
        ``_run_inner`` (logging, tracking, progress; these arguments are
        passed on). Returns ``(carry, (variables, tell losses with
        non-finite values at inf, last inner step's warped-frame
        losses))``."""
        core = self.core
        gf_type, gf_name, gf_shape = self._gf_var
        n = self.num_samples
        cma_state, vp_means, best_loss, best_t = carry

        variables = self.var_manager.initialize(num_samples=n,
                                                generator=self.generator)
        t = cma.ask(self.cma_params, cma_state, self.generator)
        variables[gf_type][gf_name] = t.reshape(n, *gf_shape).clone()
        if gen_idx > 0:             # no statistic before the first generation
            for name in self.variables_to_propagate:
                variables["input"][name] = self._resample(
                    variables["input"][name], vp_means[name], gen_idx,
                    meta_steps, 1.0, True)

        variables = core._dedupe_outputs(core.apply_transforms(variables))
        ctx = core.make_ctx(variables)
        variables, optimizer = core.init_opt_state(variables)
        inner = None
        if inner_kwargs is not None:
            self.transform_tracked.append(
                to_numpy(variables[gf_type][gf_name]))
            if self.log:
                self.vis_transform(variables)
            variables, _, _, losses = self._run_inner(
                variables, optimizer, grad_steps, start_step, ctx=ctx,
                checkpoint_path=checkpoint_path,
                checkpoint_every=checkpoint_every, **inner_kwargs)
            inner = losses[-1]
        elif grad_steps:
            variables, _, _, ys = core.grad_steps(
                variables, optimizer, self.generator, grad_steps,
                start_step=start_step, ctx=ctx, track=False,
                checkpoint_path=checkpoint_path,
                checkpoint_every=checkpoint_every)
            inner = ys["loss"][-1]
        loss = core.tell_loss(variables, self.generator,
                              start_step + grad_steps, ctx=ctx)
        if with_tell:
            cma_state = cma.tell(self.cma_params, cma_state, t, loss)

        loss, best = _best_index(loss)
        vp_means = dict(vp_means)
        for name in self.variables_to_propagate:
            data = variables["input"][name].detach()
            base = vp_means[name] if gen_idx > 0 else data.mean(dim=0)
            vp_means[name] = _ema(base, data, best, 0.5)
        lmin = loss.min()
        best_t = torch.where(lmin < best_loss, t.index_select(0, best)[0],
                             best_t)
        best_loss = torch.minimum(lmin, best_loss)
        carry = (cma_state, vp_means, best_loss, best_t)
        return carry, (variables, loss, loss if inner is None else inner)

    def _fused_generation(self, grad_steps, meta_steps, with_tell):
        """:meth:`_run_generation` of a telling generation as ``(carry,
        gen_idx) -> (carry, outputs)``, in a frame named ``generation``, as
        BasinCMA's: ``chip_smoke.py`` tells the host syncs inside a fused
        generation by that name."""
        def generation(carry, gen_idx):
            return self._run_generation(carry, gen_idx, grad_steps,
                                        meta_steps, with_tell,
                                        gen_idx * grad_steps)
        return generation

    def optimize_fused(self, meta_steps, grad_steps, last_grad_steps=None,
                       popsize=None, active=False, checkpoint_path=None,
                       checkpoint_every=1):
        """The search with one function per generation that reads nothing
        back (:meth:`_run_generation`; its one host sync is the CMA tell's
        ``eigh``). Each generation's min tell loss lands in ``self.losses``,
        read one generation behind, and its host seconds in
        ``self.gen_seconds``. The last generation runs ``last_grad_steps``
        and tells nothing.

        ``checkpoint_path`` makes the search resumable: the carry
        ``(cma_state, vp_means, best_loss, best_t)`` and the generator's
        state entering a generation are saved after it ran, and the state
        entering the last generation before that one runs; the last
        generation's Adam run resumes from ``checkpoint_path + ".final"``
        (``utils/checkpoint.py:final_checkpoint``), so re-running a finished
        search runs no step: one evaluation, the tell and the re-rendering.

        Returns ``(variables, ([collage of the final population],
        [collage of its warped targets], the best sample's warped target),
        self.loss)``; ``self.loss`` is the last Adam step's warped-frame
        loss, as :meth:`optimize` leaves it, and ``self.final_tell`` the last
        generation's un-warped tell losses."""
        self.setup_cma(self.var_manager, popsize=popsize, active=active)
        self._check_propagated()
        if last_grad_steps is None:
            last_grad_steps = grad_steps
        self.losses, self.outs, self.transform_outs = [], [], []
        self.gen_seconds = []
        gf_type, gf_name, gf_shape = self._gf_var
        info, dev = self.var_manager.variable_info, self.device

        # every carry tensor is made on the device before the first
        # generation; generation 0 replaces the zero means
        vp0 = {name: torch.zeros(info[name]["shape"], device=dev)
               for name in self.variables_to_propagate}
        carry = (self.cma_state, vp0, torch.full((), math.inf, device=dev),
                 torch.zeros(int(np.prod(gf_shape)), device=dev))
        ckpt = FusedCheckpointer(checkpoint_path, "fused transform search",
                                 every=checkpoint_every)
        start = ckpt.resume({"carry": carry,
                             "generator": self.generator.get_state()})
        if ckpt.loaded is not None:
            carry = ckpt.loaded["carry"]
            self.generator.set_state(ckpt.loaded["generator"])

        gen_fn = self._fused_generation(grad_steps, meta_steps, True)
        prev_min = None
        for gi in range(start, meta_steps - 1):
            t0 = time.perf_counter()
            carry_in = {"carry": carry,
                        "generator": self.generator.get_state()}
            carry, (_, loss, _) = gen_fn(carry, gi)
            cur_min = loss.min()
            if prev_min is not None:
                self.losses.append(float(prev_min))
            prev_min = cur_min
            ckpt.save(gi, carry_in)
            self.gen_seconds.append(time.perf_counter() - t0)
        if prev_min is not None:
            self.losses.append(float(prev_min))

        # the state entering the last generation: a re-run starts there
        ckpt.finalize(meta_steps - 1, {
            "carry": carry, "generator": self.generator.get_state()})
        t0 = time.perf_counter()
        carry, (variables, loss, inner) = self._run_generation(
            carry, meta_steps - 1, last_grad_steps, meta_steps, False,
            (meta_steps - 1) * last_grad_steps,
            checkpoint_path=final_checkpoint(checkpoint_path,
                                             start < meta_steps - 1),
            checkpoint_every=checkpoint_every)
        self.losses.append(float(loss.min()))
        self.gen_seconds.append(time.perf_counter() - t0)

        self.cma_state, self.vp_means, best_loss, best_t = carry
        self._vp_seeded = set(self.variables_to_propagate)
        self._best_loss = float(best_loss)
        self._candidate = to_numpy(best_t).reshape(gf_shape)
        self.loss = to_numpy(inner)
        self.final_tell = to_numpy(loss)

        best = int(np.argmin(self.final_tell))
        targets = variables["output"]["target"]
        candidate_out = targets[best]
        # re-render the final population, so the bundle holds its images
        with torch.no_grad():
            self.out = self.model(**{k: v.detach() for k, v in
                                     variables.get("input", {}).items()})
        results = ([to_grid(self.out)], [to_grid(targets)], candidate_out)
        return variables, results, self.loss

    # -- M searches at once ---------------------------------------------- #

    def _run_generation_batched(self, carry, gens, defaults, gen_idx,
                                grad_steps, meta_steps, with_tell):
        """One generation of M searches, rows concatenated: search i draws
        its population (with its own ``defaults`` rows), its ask and its
        propagation noise from ``gens[i]`` as :meth:`_run_generation` does
        from the optimizer's generator, then the ``[M*pop]`` rows run the
        inner Adam steps (each search's gradient its own population mean),
        the un-warped tell against each search's own original target and
        weight, and one batched CMA tell. ``carry`` is ``(stacked CMA
        states, {name: [M, ...]} means, best losses [M], best t [M, d])``.
        Returns ``(carry, (variables, tell losses [M, pop] with non-finite
        values at inf, last inner step's warped-frame losses [M, pop]))``."""
        core = self.core
        gf_type, gf_name, gf_shape = self._gf_var
        n, m = self.num_samples, len(gens)
        states, vp_means, best_loss, best_t = carry

        parts, asks = [], []
        for i, g in enumerate(gens):
            v = self.var_manager.initialize(
                num_samples=n, generator=g,
                defaults={k: d[i] for k, d in defaults.items()})
            state_i = cma.CMAState(*(f[i] for f in states))
            t = cma.ask(self.cma_params, state_i, g)
            v[gf_type][gf_name] = t.reshape(n, *gf_shape).clone()
            if gen_idx > 0:
                for name in self.variables_to_propagate:
                    v["input"][name] = self._resample(
                        v["input"][name], vp_means[name][i], gen_idx,
                        meta_steps, 1.0, True, generator=g)
            parts.append(v)
            asks.append(t)
        variables = {vt: {name: torch.cat([p[vt][name] for p in parts])
                          for name in d} for vt, d in parts[0].items()}
        t = torch.stack(asks)                                # [M, pop, d]

        variables = core._dedupe_outputs(core.apply_transforms(variables))
        ctx = core.make_ctx(variables)
        variables, optimizer = core.init_opt_state(variables)
        start_step = gen_idx * grad_steps
        inner = None
        if grad_steps:
            variables, _, _, ys = core.grad_steps(
                variables, optimizer, list(gens), grad_steps,
                start_step=start_step, ctx=ctx, track=False)
            inner = ys["loss"][-1].reshape(m, n)
        info = self.var_manager.variable_info
        originals = {"target": defaults["target"]}
        if "weight" in info and "weight" in defaults:
            originals["weight"] = defaults["weight"]
        loss = core.tell_loss(variables, list(gens), start_step + grad_steps,
                              ctx=ctx, originals=originals).reshape(m, n)
        if with_tell:
            states = cma.tell(self.cma_params, states, t, loss)

        loss = torch.where(torch.isfinite(loss), loss,
                           torch.full_like(loss, math.inf))
        best = loss.argmin(dim=1)
        rows = torch.arange(m, device=loss.device) * n + best
        vp_means = dict(vp_means)
        for name in self.variables_to_propagate:
            data = variables["input"][name].detach()
            base = (vp_means[name] if gen_idx > 0 else
                    data.reshape(m, n, *data.shape[1:]).mean(dim=1))
            vp_means[name] = ((1.0 - 0.5) * base
                              + 0.5 * data.index_select(0, rows))
        lmin = loss.min(dim=1).values
        t_best = t.reshape(m * n, -1).index_select(0, rows)
        best_t = torch.where((lmin < best_loss)[:, None], t_best, best_t)
        best_loss = torch.minimum(lmin, best_loss)
        return ((states, vp_means, best_loss, best_t),
                (variables, loss, loss if inner is None else inner))

    def optimize_fused_batched(self, batch_defaults, meta_steps, grad_steps,
                               last_grad_steps=None, popsize=None,
                               active=False, seeds=None,
                               checkpoint_path=None, checkpoint_every=1):
        """M independent transform searches, their rows run together
        (:meth:`_run_generation_batched`), each with its own CMA state,
        propagation means, candidate and ``torch.Generator``. Search i
        draws exactly what a solo :meth:`optimize_fused` of an optimizer
        with ``seed=seeds[i]`` draws, so it follows that search's
        trajectory.

        Args:
            batch_defaults: ``{name: [M, ...]}`` per-search defaults (the
                ``target``, the ``weight``); every other registered default
                is shared.
            seeds: M seeds (default ``0 .. M-1``).
            checkpoint_path: the carry and the M generators' states entering
                a generation are saved after it ran, and the state entering
                the last generation before that one runs, so a re-run of a
                finished search runs only the last generation.

        Returns a dict: ``candidate [M, *t_shape]``, ``best_loss [M]``, the
        last generation's un-warped tell losses ``loss [M, pop]`` and
        warped-frame last-step losses ``inner_loss [M, pop]``,
        ``candidate_out [M, H, W, C]`` (the best sample's warped target),
        the last ``variables``, ``cma_states``, ``vp_means`` and
        ``loss_curves [generations run, M]`` (numpy, each generation's min
        tell losses)."""
        self.setup_cma(self.var_manager, popsize=popsize, active=active)
        self._check_propagated()
        if last_grad_steps is None:
            last_grad_steps = grad_steps
        gf_shape = self._gf_var[2]
        info, dev = self.var_manager.variable_info, self.device

        defaults = {k: torch.as_tensor(to_numpy(v) if not isinstance(
            v, torch.Tensor) else v, dtype=torch.float32).to(dev)
            for k, v in batch_defaults.items()}
        m = next(iter(defaults.values())).shape[0]
        unknown = sorted(k for k in defaults
                         if k not in info or info[k]["default"] is None)
        if unknown:
            raise ValueError(f"batch_defaults for unregistered or "
                             f"defaultless variables: {unknown}")
        for k, v in defaults.items():
            if v.shape[0] != m or tuple(v.shape[1:]) != info[k]["shape"]:
                raise ValueError(f"batch_defaults[{k!r}] has shape "
                                 f"{tuple(v.shape)}, expected [{m}, "
                                 f"{', '.join(map(str, info[k]['shape']))}]")
        if "target" not in defaults:
            defaults["target"] = info["target"]["default"].expand(
                m, *info["target"]["shape"])
        if "weight" in info and info["weight"]["default"] is not None \
                and "weight" not in defaults:
            defaults["weight"] = info["weight"]["default"].expand(
                m, *info["weight"]["shape"])

        seeds = np.arange(m) if seeds is None else np.asarray(seeds)
        if seeds.shape != (m,):
            raise ValueError(f"need {m} seeds, got {seeds.shape}")
        gens = []
        for seed in seeds:
            g = torch.Generator(device=dev)
            g.manual_seed(int(seed))
            gens.append(g)

        vp0 = {name: torch.zeros((m, *info[name]["shape"]), device=dev)
               for name in self.variables_to_propagate}
        carry = (cma.stack_states(self.cma_state, m), vp0,
                 torch.full((m,), math.inf, device=dev),
                 torch.zeros((m, int(np.prod(gf_shape))), device=dev))

        ckpt = FusedCheckpointer(checkpoint_path, "batched transform search",
                                 every=checkpoint_every)
        start = ckpt.resume({"carry": carry,
                             "generators": [g.get_state() for g in gens]})
        if ckpt.loaded is not None:
            carry = ckpt.loaded["carry"]
            for g, st in zip(gens, ckpt.loaded["generators"]):
                g.set_state(st)

        self.losses, self.gen_seconds = [], []
        self.core.per_group_outputs = set(defaults)
        try:
            return self._batched_loop(carry, gens, defaults, start,
                                      meta_steps, grad_steps,
                                      last_grad_steps, ckpt)
        finally:
            self.core.per_group_outputs = set()

    def _batched_loop(self, carry, gens, defaults, start, meta_steps,
                      grad_steps, last_grad_steps, ckpt):
        """The generations of :meth:`optimize_fused_batched` from ``start``
        and its result."""
        info = self.var_manager.variable_info
        gf_shape = self._gf_var[2]
        m = len(gens)

        def carry_of(carry):
            return {"carry": carry,
                    "generators": [g.get_state() for g in gens]}

        prev_min = None
        for gi in range(start, meta_steps - 1):
            t0 = time.perf_counter()
            carry_in = carry_of(carry)
            carry, (_, loss, _) = self._run_generation_batched(
                carry, gens, defaults, gi, grad_steps, meta_steps, True)
            cur_min = loss.min(dim=1).values
            if prev_min is not None:
                self.losses.append(to_numpy(prev_min))
            prev_min = cur_min
            ckpt.save(gi, carry_in)
            self.gen_seconds.append(time.perf_counter() - t0)
        if prev_min is not None:
            self.losses.append(to_numpy(prev_min))

        ckpt.finalize(meta_steps - 1, carry_of(carry))
        t0 = time.perf_counter()
        carry, (variables, loss, inner) = self._run_generation_batched(
            carry, gens, defaults, meta_steps - 1, last_grad_steps,
            meta_steps, False)
        loss_np = to_numpy(loss)
        self.losses.append(loss_np.min(axis=1))
        self.gen_seconds.append(time.perf_counter() - t0)

        states, vp_means, best_loss, best_t = carry
        best = loss_np.argmin(axis=1)
        targets = to_numpy(variables["output"]["target"]).reshape(
            m, self.num_samples, *info["target"]["shape"])
        return {
            "candidate": to_numpy(best_t).reshape(m, *gf_shape),
            "best_loss": to_numpy(best_loss),
            "loss": loss_np,
            "inner_loss": to_numpy(inner),
            "candidate_out": targets[np.arange(m), best],
            "variables": variables,
            "cma_states": states,
            "vp_means": vp_means,
            "loss_curves": (np.stack(self.losses) if self.losses
                            else np.zeros((0, m))),
        }

    # -- the host-loop driver -------------------------------------------- #

    def optimize(self, meta_steps, grad_steps, last_grad_steps=None,
                 pbar=None, popsize=None, checkpoint_path=None,
                 checkpoint_every=1, active=False):
        """``meta_steps`` CMA generations over the transform parameter, each
        re-optimizing the latent with ``grad_steps`` Adam updates
        (``last_grad_steps`` in the last, default ``grad_steps``), driven
        from the host. Every generation takes a fresh un-warped tell loss,
        the last one too; all but the last tell CMA. Without logging, each
        generation's min tell loss lands in ``self.losses``; the asked
        candidates of each generation in ``self.transform_tracked``.

        ``checkpoint_path`` saves the CMA state, the generator's state and
        the propagation means and candidate tracking every
        ``checkpoint_every`` generations and resumes from them.

        Returns ``(variables, ([collage], [collage of the warped targets],
        the best sample's warped target), self.loss)``; with logging,
        ``(variables, (self.outs, self.transform_outs, best warped target),
        self.losses)``."""
        self.setup_cma(self.var_manager, popsize=popsize, active=active)
        self._check_propagated()
        self.losses, self.outs, self.transform_outs = [], [], []
        self.gen_seconds, self.transform_tracked = [], []
        if last_grad_steps is None:
            last_grad_steps = grad_steps
        total_steps = (meta_steps - 1) * grad_steps + last_grad_steps
        gf_type, gf_name, gf_shape = self._gf_var
        info, dev = self.var_manager.variable_info, self.device

        # the carry's host copy, which the checkpoint saves; generation 0
        # replaces the zero means, and the zero candidate is no result while
        # the best loss is inf (get_candidate)
        self.vp_means = {name: torch.zeros(info[name]["shape"], device=dev)
                         for name in self.variables_to_propagate}
        self._vp_seeded = set()
        self._best_loss = math.inf
        self._candidate = np.zeros(gf_shape, np.float32)
        ckpt = LoopCheckpointer(
            checkpoint_path, self, "cma_state", every=checkpoint_every,
            extra_attrs=("vp_means", "_best_loss", "_candidate"))
        start = ckpt.resume()
        inner_kwargs = dict(pbar=pbar, total_steps=total_steps, timer=Timer())

        variables = loss = None
        for gi in range(start, meta_steps):
            t0 = time.perf_counter()
            is_last = gi + 1 == meta_steps
            carry = (self.cma_state, self.vp_means,
                     torch.tensor(self._best_loss, device=dev),
                     torch.as_tensor(self._candidate, device=dev).reshape(-1))
            carry, (variables, loss, _) = self._run_generation(
                carry, gi, last_grad_steps if is_last else grad_steps,
                meta_steps, not is_last, gi * grad_steps,
                inner_kwargs=inner_kwargs)
            self.cma_state, self.vp_means, best_loss, best_t = carry
            self._vp_seeded = set(self.variables_to_propagate)
            self._best_loss = float(best_loss)
            self._candidate = to_numpy(best_t).reshape(gf_shape)
            if not self.log:
                self.losses.append(float(loss.min()))
            if not is_last:
                ckpt.save(gi + 1)
            self.gen_seconds.append(time.perf_counter() - t0)

        best = int(loss.argmin())
        self.final_tell = to_numpy(loss)
        candidate_out = variables["output"]["target"][best]
        self._finalize_tracked()

        if self.log:
            return variables, (self.outs, self.transform_outs,
                               candidate_out), self.losses
        results = ([to_grid(self.out)],
                   [to_grid(variables["output"]["target"])], candidate_out)
        return variables, results, self.loss
