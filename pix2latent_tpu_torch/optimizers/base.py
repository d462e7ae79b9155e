"""Shared optimizer plumbing (counterpart of
``pix2latent_tpu/optimizers/base.py``): model / variables / loss wiring, the
random stream, transform registration, tracked variables, the inner
gradient run, logging of loss curves and collage frames, and the result
convention. The compute runs in :class:`ExecutionCore`; this layer moves
results to the host between runs.

On a population mesh (``parallel/mesh.py``) a rank computes its own rows;
the results (the final variables, images and losses, the tracked
variables, a logged frame) are gathered, so every rank returns what a run
without a mesh returns.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from pix2latent_tpu_torch.core.step import ExecutionCore
from pix2latent_tpu_torch.utils.device import resolve_device, same_device
from pix2latent_tpu_torch.utils.image import smart_resize, to_grid, to_image
from pix2latent_tpu_torch.utils.misc import progress_print, to_numpy
from pix2latent_tpu_torch.variables import VariableManager


class _BaseOptimizer:
    """Base of the optimizers.

    Args:
        model: an ``nn.Module`` following the model protocol
            (``models/base.py``) or a bare callable.
        var_manager: the VariableManager with the registered variables.
        loss_fn: ``loss_fn(out, **output_vars)``.
        max_batch_size: population microbatch size; None runs the
            population whole (see ``core/step.py``).
        log: collect a loss entry and a collage frame every ``log_iter``
            steps (``self.losses``, ``self.outs``).
        track_variables: keep the input variables after every step of the
            host-loop drivers' inner runs (``self.tracked``).
        mesh: a ``parallel.mesh.Mesh`` to split the population over, one
            rank per card; the drivers pad their populations to a multiple
            of its ranks.
        seed: seed of this optimizer's ``torch.Generator`` (the JAX
            package's key stream).
        segment_steps: gradient runs longer than this go by segments of
            this many steps (``core/step.py``); None disables.
        device: must be the variable manager's device (and the mesh's);
            None takes the mesh's, or ``"cuda"`` without one.
    """

    def __init__(self, model, var_manager: VariableManager, loss_fn,
                 max_batch_size: Optional[int] = None, log: bool = False,
                 track_variables: bool = True, mesh=None, seed: int = 0,
                 segment_steps: Optional[int] = 50, *, device=None):
        if device is None:
            device = mesh.device if mesh is not None else "cuda"
        self.device = resolve_device(device)
        if mesh is not None and not same_device(mesh.device, self.device):
            raise ValueError(f"the mesh's device is {mesh.device}, not "
                             f"{self.device}")
        if not same_device(var_manager.device, self.device):
            raise ValueError(f"the variable manager lives on "
                             f"{var_manager.device}, not {self.device}")
        self.max_batch_size = max_batch_size
        self.var_manager = var_manager
        self.loss_fn = loss_fn
        self.mesh = mesh
        self.core = ExecutionCore(model, var_manager, loss_fn, mesh=mesh,
                                  track_variables=track_variables,
                                  max_batch_size=max_batch_size,
                                  segment_steps=segment_steps)
        self.model = self.core.model
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(seed)

        self.log = log
        self.log_iter = 5
        self.show_iter = 50
        self.log_resize_factor = None
        self.track_variables = track_variables
        self.tracked = {}

        self.losses = []
        self.outs = []
        self.out = None
        self.loss = None

    # -- registration ---------------------------------------------------- #

    def register_benchmark(self, benchmark):
        """An object whose ``evaluate(out, target, weight)`` gives the
        logged result in place of the loss."""
        self.bm = benchmark

    def register_transform(self, transform_fn, transform_var_name,
                           target_var_name):
        self.core.register_transform(transform_fn, transform_var_name,
                                     target_var_name)

    # -- inner runs ------------------------------------------------------ #

    def _run_inner(self, variables, optimizer, n_steps, start_step,
                   pbar=None, total_steps=None, timer=None,
                   checkpoint_path=None, checkpoint_every=1, ctx=None):
        """``n_steps`` gradient steps (an evaluation when 0), cut into runs
        of ``log_iter`` steps when logging, each logged. ``checkpoint_path``
        makes the run resumable at segment granularity (not when logging,
        whose runs are short). ``pbar`` (``progress(fraction)``) or, with a
        ``timer``, a progress line every ``show_iter`` steps reports the
        share of ``total_steps`` done. ``ctx`` is the loss's target context
        (``core.make_ctx``; computed by every run when None).
        Returns ``(variables, optimizer, out, losses [n, pop])``."""
        if n_steps == 0:
            out, loss = self.core.eval(variables, self.generator, start_step)
            self.out, self.loss = out, to_numpy(loss)
            return variables, optimizer, out, loss[None]

        chunk = self.log_iter if self.log else n_steps
        losses, out, done = [], None, 0
        while done < n_steps:
            n = min(chunk, n_steps - done)
            variables, optimizer, out, ys = self.core.grad_steps(
                variables, optimizer, self.generator, n,
                start_step=start_step + done, ctx=ctx,
                checkpoint_path=None if self.log else checkpoint_path,
                checkpoint_every=checkpoint_every)
            losses.append(ys["loss"])
            if self.track_variables and "tracked" in ys:
                self._accumulate_tracked(ys["tracked"])
            done += n
            if self.log:
                self.out = out
                self.loss = to_numpy(ys["loss"][-1])
                self.log_result(variables, start_step + done)
            if pbar is not None and total_steps:
                pbar.progress((start_step + done) / total_steps)
            elif total_steps and timer is not None and \
                    (start_step + done) % self.show_iter == 0:
                progress_print("optimize", start_step + done, total_steps,
                               "c", timer.avg(self.show_iter))
                timer.reset()
        all_losses = torch.cat(losses)
        self.out = out
        self.loss = to_numpy(all_losses[-1])
        return variables, optimizer, out, all_losses

    def _accumulate_tracked(self, tracked):
        # tracked: {name: [steps, pop, ...]}, on the device or the host
        for name, arr in tracked.items():
            self.tracked.setdefault(name, []).append(to_numpy(arr))

    def step(self, variables, optimize=True, transform=False):
        """One step, for debugging: a gradient step of ``variables`` with an
        optimizer kept across calls (pass back the variables it returns), or
        an evaluation. Returns ``(variables, out, loss)``."""
        if transform:
            variables = self.core.apply_transforms(variables)
        if optimize:
            if getattr(self, "_dbg_optimizer", None) is None:
                variables, self._dbg_optimizer = self.core.init_opt_state(
                    variables)
            variables, _, out, ys = self.core.grad_steps(
                variables, self._dbg_optimizer, self.generator, 1)
            loss = ys["loss"][-1]
        else:
            out, loss = self.core.eval(variables, self.generator)
        self.out, self.loss = out, to_numpy(loss)
        return variables, out, self.loss

    # -- logging --------------------------------------------------------- #

    def benchmark(self, variables, out):
        return self.bm.evaluate(out, variables["output"]["target"][:1],
                                variables["output"]["weight"][:1])

    def log_result(self, variables, step_iter):
        """Append ``[step, result]`` to ``self.losses`` and the output to
        ``self.outs``: for images a uint8 collage, scaled by
        ``log_resize_factor`` when set. A non-image output is kept as it is
        and logs the loss, never the registered benchmark, which scores
        images. On a mesh, the frame and the loss of every rank's rows."""
        out_t, loss = self.out, self.loss
        if self.mesh is not None:
            out_t, loss = self._gathered(out_t, loss)
        out = to_numpy(out_t)
        if out.ndim != 4:
            self.losses.append([int(step_iter), {"loss": np.asarray(loss)}])
            self.outs.append(out)
            return
        if hasattr(self, "bm"):
            res = self.benchmark(variables, out_t)
        else:
            res = {"loss": np.asarray(loss)}
        self.losses.append([int(step_iter), res])
        collage = to_image(to_grid(out))
        if self.log_resize_factor is not None:
            h, w = collage.shape[:2]
            collage = smart_resize(
                collage, (int(h * self.log_resize_factor),
                          int(w * self.log_resize_factor)))
        self.outs.append(collage)

    def _final_results(self, variables, total_steps):
        """``(variables, outs, losses)``: with logging, the logged frames and
        entries; else ``[collage]`` (``to_grid`` of the images, or the raw
        output when it is not an image batch) and
        ``[[total_steps, {"loss": loss}]]``. On a mesh, the variables, the
        images and the losses of every rank's rows."""
        self._finalize_tracked()
        if self.mesh is not None:
            variables = self.core.gather_variables(variables)
            self.out, self.loss = self._gathered(self.out, self.loss)
        if self.log:
            return variables, self.outs, self.losses
        out = to_numpy(self.out)
        collage = to_grid(out) if out.ndim == 4 else out
        return variables, [collage], [[total_steps,
                                       {"loss": np.asarray(self.loss)}]]

    def _gathered(self, out, loss):
        """``(images, losses as numpy)`` of every rank's rows."""
        loss = torch.as_tensor(np.asarray(loss), device=self.mesh.device)
        return self.mesh.gather(out), to_numpy(self.mesh.gather(loss))

    def _finalize_tracked(self):
        if self.track_variables and self.tracked:
            self.tracked = {name: np.concatenate(chunks, axis=0)
                            for name, chunks in self.tracked.items()
                            if isinstance(chunks, list)}
            if self.mesh is not None:
                # [steps, rows, ...]: every rank's rows, in rank order
                self.tracked = {
                    name: to_numpy(self.mesh.gather(torch.as_tensor(
                        np.ascontiguousarray(np.swapaxes(arr, 0, 1)),
                        device=self.mesh.device))).swapaxes(0, 1)
                    for name, arr in self.tracked.items()}

    def optimize(self, *args, **kwargs):
        raise NotImplementedError
