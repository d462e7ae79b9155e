"""The execution core: hooks -> model forward -> loss -> gradient -> Adam
(counterpart of ``pix2latent_tpu/core/step.py``).

Every variable carries a leading population axis. The gradient of a step is
the gradient of the MEAN of the per-sample losses over the population, as
in the JAX package. The variables that Adam updates are leaf tensors owned
by the population's optimizer (:meth:`ExecutionCore.init_opt_state`); hooks
write their result into them in place before each forward, which equals the
JAX package's "hook, then step from the hooked values".

Registered *input* variable names are the model's forward keywords; *output*
variable names are the loss's keywords.

``max_batch_size`` cuts the population into microbatches of that many rows
(:func:`chunk_spec`): each chunk runs its forward and backward in turn, so
peak activation memory is one chunk's, and each chunk's gradient is scaled
by ``chunk / pop`` so that the sum equals the whole population's.

A list of generators in place of one makes the rows that many populations
of equal size, one after another (the batched transform search): each
population's hooks draw from its own generator, and the gradient is that of
the sum of the populations' means, so each population steps as it would
alone.

``segment_steps`` cuts a gradient run longer than that into segments of that
many steps; with ``checkpoint_path`` every run is segmented and the state
entering a segment (variables, optimizer state, the generator's state,
steps done) is saved, so a crashed run resumes on its own trajectory. The
steps draw from the generator in order, so a segmented run is the
unsegmented run step for step.

With a ``mesh`` (``parallel/mesh.py``) of more than one rank, each rank
holds its own block of the population's rows (:meth:`ExecutionCore.place`
takes them from the full population): the hooks draw at the full
population size and keep the rank's rows, a chunk's gradient is scaled by
``chunk / (the whole population)``, and :meth:`ExecutionCore.tell_loss`
gathers the rows' losses into the full population's. A checkpoint holds
the full population, written by rank 0 and split again when loaded, so a
run resumes on any number of ranks.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Dict, Optional

import numpy as np

import torch

from pix2latent_tpu_torch.models.base import as_model
from pix2latent_tpu_torch.parallel.mesh import (gather_rows, max_rows,
                                                replicate, shard_variables)
from pix2latent_tpu_torch.utils.checkpoint import (checkpoint_exists,
                                                   load_checkpoint,
                                                   save_checkpoint)
from pix2latent_tpu_torch.utils.image import binarize
from pix2latent_tpu_torch.utils.misc import cprint, to_numpy
from pix2latent_tpu_torch.utils.profiling import span
from pix2latent_tpu_torch.variables import (VariableManager,
                                            VariableOptimizer, Variables)


def chunk_spec(pop: int, max_batch_size) -> tuple:
    """(n_chunks, chunk_size, pad_rows) for a population of ``pop`` rows.

    Chunks are exactly ``max_batch_size`` rows; when the population does not
    divide evenly the LAST chunk is padded by wrapping the first ``pad_rows``
    population rows, whose results are sliced away and which pass no
    gradient (as in the JAX package, ``core/step.py:chunk_spec``)."""
    if not max_batch_size or pop <= max_batch_size:
        return 1, pop, 0
    chunk = int(max_batch_size)
    n = -(-pop // chunk)
    return n, chunk, n * chunk - pop


def _map_tensors(fn, tree):
    """``fn`` on every tensor of a nested dict / list / tuple (None kept)."""
    if isinstance(tree, dict):
        return {k: _map_tensors(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_tensors(fn, v) for v in tree)
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    return tree


def _rows(pop: int, lo: int, hi: int, pad: int):
    """The rows [lo, hi) of every tensor with ``pop`` leading rows, plus the
    first ``pad`` rows wrapped on, detached; other tensors (1-row shared
    outputs and their contexts) are left whole."""
    def take(t):
        if t.dim() == 0 or t.shape[0] != pop:
            return t
        if not pad:
            return t[lo:hi]
        return torch.cat([t[lo:hi], t[:pad].detach()])
    return take


def row_chunks(total: int, max_batch_size, *trees):
    """The chunks of ``total`` rows (:func:`chunk_spec`): ``([(real rows,
    *each tree's rows of the chunk)], chunk size)``; the last chunk wraps
    the first rows on, detached (see :func:`_rows`)."""
    n, chunk, pad = chunk_spec(total, max_batch_size)
    if n == 1:
        return [(total, *trees)], total
    out = []
    for i in range(n):
        lo, hi = i * chunk, min((i + 1) * chunk, total)
        take = _rows(total, lo, hi, pad if i == n - 1 else 0)
        out.append((hi - lo, *(_map_tensors(take, t) for t in trees)))
    return out, chunk


def _cat(parts):
    return parts[0] if len(parts) == 1 else torch.cat(parts)


def _chunk_span(n_chunks: int, real: int, chunk: int):
    """A ``chunk`` span of ``real`` rows padded to ``chunk``, where the
    population runs in more than one chunk."""
    if n_chunks == 1:
        return contextlib.nullcontext()
    return span("chunk", rows=real, pad=chunk - real)


def _groups(generator) -> int:
    """How many populations the rows hold: one per generator of a list."""
    return len(generator) if isinstance(generator, (list, tuple)) else 1


class ExecutionCore:
    """Runs the inner steps and the tell evaluations of one problem."""

    def __init__(self, model, var_manager: VariableManager, loss_fn: Callable,
                 mesh=None, track_variables: bool = False,
                 max_batch_size: Optional[int] = None,
                 segment_steps: Optional[int] = 50):
        self.model = as_model(model)
        self.var_manager = var_manager
        self.loss_fn = loss_fn
        self.mesh = mesh
        self.max_batch_size = max_batch_size
        self.track_variables = track_variables
        self.segment_steps = segment_steps
        # transform registry: target variable name -> {fn, param name}
        self.transform_fns: Dict[str, dict] = {}
        # output variables whose default differs by population group (the
        # batched transform search): never shrunk to one row
        self.per_group_outputs = set()

    # ------------------------------------------------------------------ #
    # transforms                                                         #
    # ------------------------------------------------------------------ #

    def register_transform(self, transform_fn, transform_var_name: str,
                           target_var_name: str):
        """Warp ``target_var`` by the ``transform_var`` parameter before the
        inner loop: ``transform_fn(target, param)``."""
        self.transform_fns[target_var_name] = {
            "fn": transform_fn,
            "transform_param": transform_var_name,
            "target_var": target_var_name,
        }

    def apply_transforms(self, variables: Variables) -> Variables:
        """New variables with each registered target warped by its
        transform; ``variables`` itself when none is registered."""
        if not self.transform_fns:
            return variables
        info = self.var_manager.variable_info
        out = {vt: dict(d) for vt, d in variables.items()}
        for dst_name, td in self.transform_fns.items():
            src_type = info[td["transform_param"]]["var_type"]
            dst_type = info[dst_name]["var_type"]
            t = out[src_type][td["transform_param"]]
            out[dst_type][dst_name] = td["fn"](out[dst_type][dst_name], t)
        return out

    # ------------------------------------------------------------------ #
    # forward / loss                                                     #
    # ------------------------------------------------------------------ #

    def _dedupe_outputs(self, variables: Variables) -> Variables:
        """Shrink constant output variables (a default, no gradient, no
        hook) to one shared row; the losses broadcast 1-row targets."""
        info = self.var_manager.variable_info
        outputs = variables.get("output")
        if not outputs:
            return variables
        out = {vt: dict(d) for vt, d in variables.items()}
        for name, data in outputs.items():
            if self._shared_output(name) and data.shape[0] != 1:
                out["output"][name] = data[:1]
        return out

    def _shared_output(self, name) -> bool:
        """An output variable constant over the population: a default, no
        gradient, no hook, no transform, the same for every group."""
        spec = self.var_manager.variable_info[name]
        return (spec["var_type"] == "output" and spec["default"] is not None
                and not spec["requires_grad"] and spec["hook_fn"] is None
                and name not in self.transform_fns
                and name not in self.per_group_outputs)

    def _freeze(self, variables: Variables) -> Variables:
        """Detach every requires_grad=False variable, so autograd never
        builds the frozen branches (e.g. the LPIPS backbone on the target)."""
        info = self.var_manager.variable_info
        return {vt: {name: (a if info.get(name, {}).get("requires_grad", True)
                            else a.detach())
                     for name, a in d.items()}
                for vt, d in variables.items()}

    def _forward_loss(self, variables: Variables, ctx=None):
        """(mean over the population, per-sample losses [pop], images)."""
        variables = self._freeze(variables)
        with span("forward"):
            out = self.model(**variables.get("input", {}))
        with span("loss"):
            if ctx is not None:
                loss_map = self.loss_fn.from_ctx(out, ctx)
            else:
                loss_map = self.loss_fn(out, **variables.get("output", {}))
            per_sample = loss_map.reshape(out.shape[0], -1).mean(dim=1)
        return per_sample.mean(), per_sample, out

    def _can_precompute(self) -> bool:
        """The loss can precompute its target side and every output variable
        is constant through the inner loop (frozen, no hook)."""
        if not hasattr(self.loss_fn, "precompute"):
            return False
        outs = [s for s in self.var_manager.variable_info.values()
                if s["var_type"] == "output"]
        return bool(outs) and all(not s["requires_grad"] and s["hook_fn"] is None
                                  for s in outs)

    def _chunks(self, variables: Variables, ctx):
        """[(n_real_rows, variables, ctx)] of each population microbatch,
        the chunk size and the population (see :func:`row_chunks`)."""
        pop = max(a.shape[0] for d in variables.values() for a in d.values())
        chunks, chunk = row_chunks(pop, self.max_batch_size, variables, ctx)
        return chunks, chunk, pop

    def _forward_backward(self, variables: Variables, ctx=None, groups=1):
        """Forward, loss and backward of the population mean (of the sum of
        ``groups`` populations' means), chunk by chunk; the gradients
        accumulate into the variables' ``.grad``. Returns the detached
        ``(per-sample losses [pop], images)``."""
        chunks, chunk, pop = self._chunks(variables, ctx)
        # the gradient of the mean over the WHOLE population: on a mesh
        # each rank holds pop rows of it, and no gradient is reduced across
        # ranks, which is exact only while every row's loss depends on that
        # row alone (per-row variables, BigGAN's standing BatchNorm
        # statistics, per-sample losses); a cross-row statistic would need
        # an all-reduce here
        total = pop * (self.mesh.size if self.mesh is not None else 1)
        losses, outs = [], []
        for real, v, c in chunks:
            with _chunk_span(len(chunks), real, chunk):
                loss, per_sample, out = self._forward_loss(v, c)
                with span("backward"):
                    (loss * (chunk * groups / total)).backward()
            losses.append(per_sample[:real].detach())
            outs.append(out[:real].detach())
        return _cat(losses), _cat(outs)

    def _eval_chunked(self, variables: Variables, ctx=None):
        """``(per-sample losses [pop], images)`` without gradients, chunk
        by chunk."""
        losses, outs = [], []
        chunks, chunk, _ = self._chunks(variables, ctx)
        for real, v, c in chunks:
            with _chunk_span(len(chunks), real, chunk):
                _, per_sample, out = self._forward_loss(v, c)
            losses.append(per_sample[:real])
            outs.append(out[:real])
        return _cat(losses), _cat(outs)

    def make_ctx(self, variables: Variables):
        """The loss's target-side context (the LPIPS target pyramid),
        computed once without gradients; None when not applicable."""
        if not self._can_precompute() or not variables.get("output"):
            return None
        with torch.no_grad(), span("ctx"):
            return self.loss_fn.precompute(
                **{k: v.detach() for k, v in variables["output"].items()})

    # ------------------------------------------------------------------ #
    # steps                                                              #
    # ------------------------------------------------------------------ #

    def init_opt_state(self, variables: Variables):
        """Fresh optimizer state for a population: returns ``(variables,
        optimizer)`` where every trainable variable is now a leaf tensor the
        optimizer updates in place."""
        info = self.var_manager.variable_info
        variables = {vt: {name: (a.detach().clone().requires_grad_(True)
                                 if info[name]["requires_grad"] else a)
                          for name, a in d.items()}
                     for vt, d in variables.items()}
        return variables, self.var_manager.make_optimizer(variables)

    def _sharded(self) -> bool:
        return self.mesh is not None and self.mesh.size > 1

    def _apply_hooks(self, generator, variables: Variables, step) -> Variables:
        """The variables with the registered hooks applied; with a list of
        generators, each population's rows from its own generator. On a
        mesh of several ranks the hooks run on the full population, this
        rank's rows at their place and zeros elsewhere, so every rank draws
        what a run without a mesh draws, and keep this rank's rows."""
        if self._sharded():
            return self._apply_hooks_sharded(generator, variables, step)
        return self._apply_hooks_whole(generator, variables, step)

    def _apply_hooks_whole(self, generator, variables: Variables, step):
        if not isinstance(generator, (list, tuple)):
            return self.var_manager.apply_hooks(generator, variables, step)
        hooked = {n for n, spec in self.var_manager.variable_info.items()
                  if spec["hook_fn"] is not None}
        split = {vt: {name: t.chunk(len(generator))
                      for name, t in d.items() if name in hooked}
                 for vt, d in variables.items()}
        parts = [self.var_manager.apply_hooks(
            g, {vt: {name: p[i] for name, p in d.items()}
                for vt, d in split.items()}, step)
            for i, g in enumerate(generator)]
        out = {vt: dict(d) for vt, d in variables.items()}
        for vt, d in split.items():
            for name in d:
                out[vt][name] = torch.cat([p[vt][name] for p in parts])
        return out

    def _apply_hooks_sharded(self, generator, variables: Variables, step):
        mesh = self.mesh
        per = max_rows(variables)
        pop = per * mesh.size
        hooked = {n for n, spec in self.var_manager.variable_info.items()
                  if spec["hook_fn"] is not None}
        full = {vt: {name: (mesh.embed(t, pop) if name in hooked
                            and t.dim() and t.shape[0] == per else t)
                     for name, t in d.items()}
                for vt, d in variables.items()}
        full = self._apply_hooks_whole(generator, full, step)
        return {vt: {name: (mesh.local(full[vt][name], pop)
                            if name in hooked and t.dim()
                            and t.shape[0] == per else t)
                     for name, t in d.items()}
                for vt, d in variables.items()}

    def _hook_in_place(self, generator, variables: Variables, step) -> Variables:
        hooked = self._apply_hooks(generator, variables, step)
        out = {vt: dict(d) for vt, d in variables.items()}
        with torch.no_grad():
            for vt, d in hooked.items():
                for name, new in d.items():
                    old = variables[vt][name]
                    if new is old:
                        continue
                    if old.requires_grad:
                        old.copy_(new)          # keep the optimizer's leaf
                    else:
                        out[vt][name] = new
        return out

    def grad_steps(self, variables: Variables, optimizer: VariableOptimizer,
                   generator, n_steps: int, start_step: int = 0, ctx=None,
                   track: Optional[bool] = None, checkpoint_path=None,
                   checkpoint_every: int = 1):
        """``n_steps`` hook / forward / backward / optimizer steps.

        ``variables`` and ``optimizer`` come from :meth:`init_opt_state`;
        ``ctx`` is a :meth:`make_ctx` result (computed here when None).
        Runs longer than ``segment_steps``, and every run with a
        ``checkpoint_path``, go by segments (:meth:`_grad_steps_segmented`).
        Returns ``(variables, optimizer, out, ys)``: ``ys["loss"]`` holds the
        per-sample losses each step's forward saw, ``[n_steps, pop]`` (the
        steps after the resume point when resuming), and with ``track``
        (default ``track_variables``) ``ys["tracked"]`` the input variables
        after each step, ``{name: [n_steps, pop, ...]}``."""
        track = self.track_variables if track is None else bool(track)
        n_steps = int(n_steps)
        with span("inner", steps=n_steps, rows=max_rows(variables)):
            variables = self._dedupe_outputs(variables)
            if ctx is None:
                ctx = self.make_ctx(variables)
            seg = self.segment_steps
            if not checkpoint_path and (not seg or n_steps <= seg):
                return self._run_steps(variables, optimizer, generator,
                                       n_steps, start_step, ctx, track)
            return self._grad_steps_segmented(
                variables, optimizer, generator, n_steps, int(start_step),
                ctx, track, int(seg) if seg else n_steps, checkpoint_path,
                max(int(checkpoint_every), 1))

    def _run_steps(self, variables, optimizer, generator, n_steps, start_step,
                   ctx, track):
        losses, tracked, out = [], [], None
        for i in range(n_steps):
            with span("step"):
                with span("hook"):
                    variables = self._hook_in_place(generator, variables,
                                                    start_step + i)
                with span("adam"):
                    optimizer.zero_grad()
                per_sample, out = self._forward_backward(variables, ctx,
                                                         _groups(generator))
                with span("adam"):
                    optimizer.step()
            losses.append(per_sample)
            if track:
                tracked.append({name: t.detach().clone() for name, t in
                                variables.get("input", {}).items()})
        ys = {"loss": torch.stack(losses)}
        if track:
            ys["tracked"] = {name: torch.stack([t[name] for t in tracked])
                             for name in tracked[0]}
        return variables, optimizer, out, ys

    def _carry(self, variables, optimizer, generator, done, template=False):
        """What a segmented run saves: the state entering a segment."""
        return {"variables": variables,
                "optimizer": (optimizer.state_template() if template
                              else optimizer.state()),
                "generator": generator.get_state(),
                "done": (torch.zeros((), dtype=torch.int32) if template
                         else np.int32(done))}

    def _grad_steps_segmented(self, variables, optimizer, generator, n_steps,
                              start_step, ctx, track, seg, ckpt_path,
                              ckpt_every):
        """:meth:`grad_steps` by segments of ``seg`` steps.

        With ``ckpt_path``, the state entering every ``ckpt_every``-th
        segment is written before it runs (the file always holds the state
        entering the running segment or an earlier one, as the JAX package's
        one-behind write does), and the finished run's state after the last
        step. A checkpoint found at the start is resumed: its variables are
        copied into the optimizer's tensors and its optimizer and generator
        states loaded, so the rest of the run is the uninterrupted run's. A
        finished checkpoint runs no step: one evaluation gives ``out`` and
        the loss (its hook draw is one the uninterrupted run did not make).
        Tracked variables are read to the host after each segment."""
        done = 0
        found = checkpoint_exists(ckpt_path)
        if ckpt_path and self.mesh is not None:
            self.mesh.barrier()       # every rank looked before rank 0 writes
        if found:
            saved = load_checkpoint(ckpt_path, self._carry(
                variables, optimizer, generator, 0, template=True))
            done = int(saved["done"])
            pop = max_rows(saved["variables"])
            variables = self._restore(variables, self.place(
                saved["variables"], pop))
            optimizer.load_state(self.place(saved["optimizer"], pop))
            generator.set_state(saved["generator"])
            cprint(f"(checkpoint) resumed gradient run at step {done}"
                   f"/{n_steps}", "y")
        if done >= n_steps:
            out, loss = self.eval(variables, generator,
                                  step=start_step + n_steps - 1)
            return variables, optimizer, out, {"loss": loss[None]}

        losses, tracked, out = [], [], None
        for si, s0 in enumerate(range(done, n_steps, seg)):
            if ckpt_path and si % ckpt_every == 0:
                self._save_carry(ckpt_path, variables, optimizer, generator,
                                 s0)
            variables, optimizer, out, ys = self._run_steps(
                variables, optimizer, generator, min(seg, n_steps - s0),
                start_step + s0, ctx, track)
            losses.append(ys["loss"])
            if track:
                tracked.append({k: to_numpy(v)
                                for k, v in ys["tracked"].items()})
        if ckpt_path:
            self._save_carry(ckpt_path, variables, optimizer, generator,
                             n_steps)
        ys = {"loss": torch.cat(losses)}
        if track:
            ys["tracked"] = {k: np.concatenate([t[k] for t in tracked])
                             for k in tracked[0]}
        return variables, optimizer, out, ys

    def _save_carry(self, path, variables, optimizer, generator, done):
        """Write the carry of the full population: on a mesh, the rows of
        every rank gathered, written by rank 0."""
        carry = self._carry(variables, optimizer, generator, done)
        if self.mesh is not None:
            rows = max_rows(variables)
            carry["variables"] = self.gather_variables(variables)
            carry["optimizer"] = gather_rows(carry["optimizer"], self.mesh,
                                             rows)
        if self.mesh is None or self.mesh.is_writer:
            save_checkpoint(path, carry)

    def _restore(self, variables: Variables, saved: Variables) -> Variables:
        """``variables`` with the saved values: copied into the optimizer's
        leaf tensors, replacing the frozen ones."""
        out = {vt: dict(d) for vt, d in variables.items()}
        with torch.no_grad():
            for vt, d in saved.items():
                for name, value in d.items():
                    old = variables[vt][name]
                    if old.requires_grad:
                        old.copy_(value)
                    else:
                        out[vt][name] = value
        return out

    def eval(self, variables: Variables, generator, step=0):
        """Hooks + forward + per-sample loss, no updates: ``(out, loss)``."""
        with torch.no_grad(), span("eval"):
            variables = self._dedupe_outputs(variables)
            with span("hook"):
                variables = self._apply_hooks(generator, variables, step)
            per_sample, out = self._eval_chunked(variables)
        return out, per_sample

    def tell_loss(self, variables: Variables, generator, step=0,
                  inverted=True, ctx=None, originals=None):
        """Fresh per-sample loss for the CMA tell: hooks applied to a copy,
        then a forward without gradients; on a mesh, every rank's rows
        gathered into the whole population's. With ``inverted`` and a registered
        transform of the target (its parameter a ``transform`` variable),
        the loss is taken in the un-warped frame (:meth:`_unwarped_loss`,
        where ``originals`` are the populations' own un-warped targets),
        where ``ctx``, the context of the warped targets, does not apply."""
        with torch.no_grad(), span("tell_loss"):
            variables = self._dedupe_outputs(variables)
            with span("hook"):
                variables = self._apply_hooks(generator, variables, step)
            if not (inverted and self.transform_fns
                    and "transform" in variables):
                per_sample, _ = self._eval_chunked(variables, ctx)
                return self.gather(per_sample)
            with span("forward"):
                outs = [self.model(**self._freeze(v).get("input", {}))[:real]
                        for real, v, _ in self._chunks(variables, None)[0]]
            with span("loss"):
                loss = self._unwarped_loss(variables, _cat(outs), originals)
            return self.gather(loss)

    def _unwarped_loss(self, variables: Variables, out, originals=None):
        """Per-sample loss of the images ``out`` taken back to the original
        frame by the inverse of the target's transform, against the
        registered (un-warped) target and, when a weight is registered, its
        binarized default. ``originals``, ``{"target": [G, H, W, C],
        "weight": optional [G, H, W, C]}``, gives G populations of equal
        size their own un-warped target and weight in place of the
        registered defaults. On a mesh ``out`` holds this rank's rows of
        the populations, each row scored against its own population's."""
        info = self.var_manager.variable_info
        td = self.transform_fns["target"]
        param = td["transform_param"]
        t = variables[info[param]["var_type"]][param]
        out_inv = td["fn"](out, t, invert=True)
        if originals is None:
            originals = {"target": info["target"]["default"][None]}
            if "weight" in info and info["weight"]["default"] is not None:
                originals["weight"] = info["weight"]["default"][None]
        groups = originals["target"].shape[0]
        total = out.shape[0] * (self.mesh.size if self.mesh is not None
                                else 1)
        mine = self.mesh.rows(total) if self.mesh is not None else range(total)
        rows = total // groups
        losses = []
        for i in range(groups):
            # the rows of population i that this rank holds
            lo = max(i * rows, mine.start) - mine.start
            hi = min((i + 1) * rows, mine.stop) - mine.start
            if lo >= hi:
                continue
            kwargs = {}
            if originals.get("weight") is not None:
                kwargs["weight"] = binarize(originals["weight"][i:i + 1])
            loss_map = self.loss_fn(out_inv[lo:hi],
                                    target=originals["target"][i:i + 1],
                                    **kwargs)
            losses.append(loss_map.reshape(hi - lo, -1).mean(dim=1))
        return _cat(losses)

    # ------------------------------------------------------------------ #
    # sharding                                                           #
    # ------------------------------------------------------------------ #

    def place(self, variables, pop: Optional[int] = None):
        """This rank's rows of a full population (of ``pop`` rows, default
        the most any tensor has); the tree itself without a mesh."""
        if self.mesh is None:
            return variables
        return shard_variables(variables, self.mesh, pop=pop)

    # a population made during a generation is placed the same way
    place_in_graph = place

    def place_replicated(self, tree):
        """``tree`` as rank 0 holds it, on every rank (set-up only)."""
        if self.mesh is None:
            return tree
        return replicate(tree, self.mesh)

    def gather(self, t):
        """Every rank's rows of ``t``; ``t`` itself without a mesh."""
        return t if self.mesh is None else self.mesh.gather(t)

    def gather_variables(self, variables: Variables) -> Variables:
        """Every rank's rows of ``variables`` gathered into the whole
        population's (the end of a run, a checkpoint); a shared output of
        one row stays as it is. The tree itself without a mesh."""
        if self.mesh is None:
            return variables
        rows = max_rows(variables)
        return {vt: {name: (self.mesh.gather(t) if t.dim()
                            and t.shape[0] == rows
                            and not (t.shape[0] == 1
                                     and self._shared_output(name))
                            else t)
                     for name, t in d.items()}
                for vt, d in variables.items()}
