"""BasinCMA over a batch of images (counterpart of
``pix2latent_tpu/optimizers/batched.py``).

M independent CMA-ES states are stacked on a leading images axis
(``strategies/cma.py:stack_states``). A generation asks all M (``[M, pop,
d]``), refines the concatenated ``[M*pop]`` rows with one shared inner Adam
run through one generator batch, and tells all M at once: one batched
``eigh``, so one host sync a generation for the M images. Image i owns rows
``[i*pop, (i+1)*pop)`` and its loss depends on its own target only, so the
searches stay independent.

``max_batch_size`` runs the rows in wrap-padded chunks of that many
(``core/step.py:chunk_spec``), each chunk's gradient scaled by ``chunk /
(M*pop)``, so a step equals the unchunked step. ``checkpoint_path`` makes
the generation loop resumable with the one-behind protocol of the other
fused drivers (``utils/checkpoint.py:FusedCheckpointer``) and the final Adam
run resumable by segments from ``checkpoint_path + ".final"``.
"""

from __future__ import annotations

import time
from typing import Dict, Optional

import numpy as np
import torch

from pix2latent_tpu_torch.core.step import _map_tensors, row_chunks
from pix2latent_tpu_torch.models.base import as_model
from pix2latent_tpu_torch.strategies import cma
from pix2latent_tpu_torch.utils.checkpoint import (FusedCheckpointer,
                                                   checkpoint_exists,
                                                   final_checkpoint,
                                                   load_checkpoint,
                                                   save_checkpoint)
from pix2latent_tpu_torch.utils.device import resolve_device
from pix2latent_tpu_torch.utils.image import binarize
from pix2latent_tpu_torch.utils.misc import cprint, to_numpy
from pix2latent_tpu_torch.variables import VariableOptimizer


def _repeat_rows(tree, pop, m):
    """Every tensor of ``tree`` with ``m`` leading rows repeated to ``m *
    pop`` rows, image i's row on rows ``[i*pop, (i+1)*pop)``."""
    def rep(t):
        if t.dim() > 0 and t.shape[0] == m:
            return t.repeat_interleave(pop, dim=0)
        return t
    return _map_tensors(rep, tree)


class BatchedBasinCMAOptimizer:
    """BasinCMA over M images at once.

    Args:
        model: the generator, called as ``model(z=..., **inputs)``.
        loss_fn: ``loss_fn(out, target=..., weight=...)`` (per-pixel or
            per-sample); with ``precompute`` / ``from_ctx`` the target side
            is computed once on the M unique targets.
        z_dim: dimension of the latent CMA searches.
        learning_rate: Adam's learning rate for z in the inner runs.
        learnable_inputs: ``{name: lr}`` of further per-image inputs that
            Adam refines too (BigGAN's class embedding c at 0.01), their
            per-image starting values given to :meth:`optimize`.
        popsize: population per image (default ``4 + floor(3 ln d)``).
        sigma: initial CMA step size.
        hook_fn: ``(generator, z, step) -> z`` applied to z before each step.
        seed: seed of the optimizer's ``torch.Generator``.
        mesh: population sharding is not ported; must be None.
        max_batch_size: rows a forward and backward takes at once.
        device: the device of the model and the tensors.
    """

    def __init__(self, model, loss_fn, z_dim: int = 128,
                 learning_rate: float = 0.05,
                 learnable_inputs: Optional[Dict[str, float]] = None,
                 popsize: Optional[int] = None, sigma: float = 1.0,
                 hook_fn=None, seed: int = 0, mesh=None,
                 max_batch_size: Optional[int] = None, device="cuda"):
        if mesh is not None:
            raise NotImplementedError("population sharding over a mesh is "
                                      "not ported: pass mesh=None")
        self.device = resolve_device(device)
        self.model = as_model(model)
        self.loss_fn = loss_fn
        self.z_dim = int(z_dim)
        self.lr = float(learning_rate)
        self.learnable_inputs = dict(learnable_inputs or {})
        self.popsize = int(popsize or cma.default_popsize(self.z_dim))
        self.sigma = float(sigma)
        self.hook_fn = hook_fn
        self.max_batch_size = max_batch_size
        self.cma_params = cma.make_params(self.z_dim, self.popsize,
                                          device=self.device)
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(seed)
        # per generation: the M min tell losses, and the host seconds
        self.losses = []
        self.gen_seconds = []
        # the frozen per-image transform of tell_inverted
        self._tell_fn = None

    # -- the per-row loss -------------------------------------------------- #

    def _forward_loss(self, learn, aux):
        """(mean over the rows, per-row losses) of the inner objective."""
        out = self.model(**learn, **aux["fixed"])
        if "ctx" in aux:
            loss_map = self.loss_fn.from_ctx(out, aux["ctx"])
        else:
            kwargs = {"weight": aux["weight"]} if "weight" in aux else {}
            loss_map = self.loss_fn(out, target=aux["target"], **kwargs)
        per_sample = loss_map.reshape(out.shape[0], -1).mean(dim=1)
        return per_sample.mean(), per_sample

    def _eval_loss(self, learn, aux):
        """Per-row loss for the tells and the winners: with
        ``tell_inverted``, the image taken back to the original frame by the
        inverse of its image's transform, against the original target (and
        the binarized original weight); else the inner objective."""
        if "tell_t" not in aux:
            return self._forward_loss(learn, aux)[1]
        out = self.model(**learn, **aux["fixed"])
        out_inv = self._tell_fn(out, aux["tell_t"], invert=True)
        if "tell_ctx" in aux:
            loss_map = self.loss_fn.from_ctx(out_inv, aux["tell_ctx"])
        else:
            kwargs = ({"weight": aux["tell_weight"]} if "tell_weight" in aux
                      else {})
            loss_map = self.loss_fn(out_inv, target=aux["tell_target"],
                                    **kwargs)
        return loss_map.reshape(out.shape[0], -1).mean(dim=1)

    def _chunks(self, learn, aux):
        """[(real rows, learn, aux)] of each chunk, and the scale of a
        chunk's mean loss that makes the chunks' gradients sum to the
        gradient of the mean over all rows."""
        total = learn["z"].shape[0]
        chunks, chunk = row_chunks(total, self.max_batch_size, learn, aux)
        return chunks, chunk / total

    def _forward_backward(self, learn, aux):
        """Forward and backward of the mean loss over all rows, chunk by
        chunk; returns the detached per-row losses."""
        chunks, scale = self._chunks(learn, aux)
        losses = []
        for real, lc, ac in chunks:
            loss, per_sample = self._forward_loss(lc, ac)
            (loss * scale).backward()
            losses.append(per_sample[:real].detach())
        return torch.cat(losses)

    def _eval_chunked(self, learn, aux):
        with torch.no_grad():
            chunks, _ = self._chunks(learn, aux)
            return torch.cat([self._eval_loss(lc, ac)[:real]
                              for real, lc, ac in chunks])

    # -- generations ------------------------------------------------------- #

    def _make_aux(self, data, m):
        """The per-row loss context from the per-image ``data``."""
        pop = self.popsize
        aux = {"fixed": {name: v.repeat_interleave(pop, dim=0)
                         for name, v in data["fixed"].items()
                         if name not in self.learnable_inputs}}
        if "ctx" in data:
            aux["ctx"] = _repeat_rows(data["ctx"], pop, m)
        else:
            aux["target"] = data["targets"].repeat_interleave(pop, dim=0)
            if data.get("weights") is not None:
                aux["weight"] = data["weights"].repeat_interleave(pop, dim=0)
        if "tell_t" in data:
            aux["tell_t"] = data["tell_t"].repeat_interleave(pop, dim=0)
            if "tell_ctx" in data:
                aux["tell_ctx"] = _repeat_rows(data["tell_ctx"], pop, m)
            else:
                aux["tell_target"] = data["tell_target"].repeat_interleave(
                    pop, dim=0)
                if data.get("tell_weight") is not None:
                    aux["tell_weight"] = data["tell_weight"].repeat_interleave(
                        pop, dim=0)
        return aux

    def _init_learn(self, x, data):
        """The rows Adam refines, from the asked ``x [M, pop, d]`` and the
        per-image starting values of the learnable inputs, and their Adam
        (one parameter group, with its learning rate, a variable)."""
        learn = {"z": x.reshape(-1, self.z_dim).detach().clone()}
        lrs = {"z": self.lr}
        for name, lr in self.learnable_inputs.items():
            if name in data["fixed"]:
                learn[name] = data["fixed"][name].repeat_interleave(
                    self.popsize, dim=0).detach().clone()
                lrs[name] = lr
        for t in learn.values():
            t.requires_grad_(True)
        adam = torch.optim.Adam(
            [{"params": [learn[k]], "lr": lrs[k]} for k in sorted(learn)],
            betas=(0.9, 0.999), eps=1e-8)
        return learn, VariableOptimizer([adam])

    def _steps(self, learn, optimizer, aux, n_steps, start_step):
        """``n_steps`` hook / forward / backward / Adam steps."""
        for i in range(n_steps):
            if self.hook_fn is not None:
                with torch.no_grad():
                    learn["z"].copy_(self.hook_fn(self.generator, learn["z"],
                                                  start_step + i))
            optimizer.zero_grad()
            self._forward_backward(learn, aux)
            optimizer.step()

    def generation(self, states, data, aux, grad_steps, gen_idx, x=None):
        """One generation: the M asks (or the candidates ``x [M, pop, d]``
        given), ``grad_steps`` inner Adam steps over the ``[M*pop]`` rows,
        the per-row tell losses of the refined rows and the M tells.
        Nothing is read back: the one host sync is the batched ``eigh`` of
        the tells. Returns ``(states, learn, tell losses [M, pop], their
        per-image minimum [M])``."""
        m = states.mean.shape[0]
        if x is None:
            x = cma.ask(self.cma_params, states, self.generator)
        learn, optimizer = self._init_learn(x, data)
        self._steps(learn, optimizer, aux, grad_steps, gen_idx * grad_steps)
        loss = self._eval_chunked(learn, aux).reshape(m, self.popsize)
        states = cma.tell(self.cma_params, states, x, loss)
        return states, learn, loss, loss.min(dim=1).values

    def _run_final(self, states, data, aux, meta_steps, last_grad_steps,
                   final_segment_steps, checkpoint_path):
        """The last run: one more ask, ``last_grad_steps`` Adam steps by
        segments of ``final_segment_steps``, the per-row losses; no tell.
        With ``checkpoint_path`` the state entering each segment is saved
        there and a saved run resumes from it. Returns ``(learn, losses [M,
        pop])``."""
        m = states.mean.shape[0]
        x = cma.ask(self.cma_params, states, self.generator)
        learn, optimizer = self._init_learn(x, data)
        seg = final_segment_steps or last_grad_steps
        start = meta_steps * last_grad_steps

        def carry(done, template=False):
            return {"learn": learn,
                    "optimizer": (optimizer.state_template() if template
                                  else optimizer.state()),
                    "generator": self.generator.get_state(),
                    "done": (torch.zeros((), dtype=torch.int32) if template
                             else np.int32(done))}

        done = 0
        if checkpoint_exists(checkpoint_path):
            saved = load_checkpoint(checkpoint_path, carry(0, template=True))
            with torch.no_grad():
                for k, v in saved["learn"].items():
                    learn[k].copy_(v)
            optimizer.load_state(saved["optimizer"])
            self.generator.set_state(saved["generator"])
            done = int(saved["done"])
            cprint(f"(batched basin-cma) resumed the final run at step "
                   f"{done}/{last_grad_steps}", "y")
        for s0 in range(done, last_grad_steps, seg):
            if checkpoint_path:
                save_checkpoint(checkpoint_path, carry(s0))
            self._steps(learn, optimizer, aux,
                        min(seg, last_grad_steps - s0), start + s0)
        if checkpoint_path:
            save_checkpoint(checkpoint_path, carry(last_grad_steps))
        loss = self._eval_chunked(learn, aux).reshape(m, self.popsize)
        return learn, loss

    # -- the driver -------------------------------------------------------- #

    def _as_tensor(self, v):
        return torch.as_tensor(to_numpy(v) if not isinstance(
            v, torch.Tensor) else v, dtype=torch.float32).to(self.device)

    def optimize(self, targets, weights=None, fixed_inputs=None,
                 meta_steps=30, grad_steps=30, last_grad_steps=300,
                 final_segment_steps=50, checkpoint_path=None,
                 checkpoint_every=1, progress_every=0, tell_inverted=None):
        """Invert ``targets [M, H, W, 3]`` at once.

        ``fixed_inputs``: ``{name: [M, ...]}`` per-image model inputs (class
        embeddings); those in ``learnable_inputs`` are refined by Adam too.
        ``checkpoint_path`` makes the generation loop resumable (the state
        entering a generation is saved once it has run; a finished loop
        runs no generation again) and the final run too, from
        ``checkpoint_path + ".final"``. ``final_segment_steps``: the final
        run's steps between its checkpoint saves. ``tell_inverted``: the
        frozen-transform semantics of the two-phase workflow, ``targets``
        being the warped targets: ``{"transform_fn": fn, "t": [M, t_dim],
        "targets": [M, H, W, 3] original frames, "weights": optional
        originals}``; the tells, loss curves and winners then score the
        image taken back to the original frame (``fn(out, t,
        invert=True)``) against the original target, with the binarized
        original weight; the inner Adam objective stays the warped one.

        Returns a dict: per image the winner's ``z [M, d]``, ``loss [M]``,
        each learnable input, the re-rendered ``out [M, H, W, 3]``; and
        ``all_losses [M, pop]`` (numpy, non-finite as inf), ``cma_states``
        and ``loss_curves [generations run, M]`` (numpy, each generation's
        min tell losses, read one generation behind)."""
        targets = self._as_tensor(targets)
        m = targets.shape[0]
        fixed = {k: self._as_tensor(v)
                 for k, v in (fixed_inputs or {}).items()}
        for k, v in fixed.items():
            if v.shape[0] != m:
                raise ValueError(f"fixed input {k!r} has {v.shape[0]} rows "
                                 f"for {m} images")
        cprint(f"(batched basin-cma) {m} images x pop {self.popsize} = "
               f"{m * self.popsize} samples/generation"
               + (f", max_batch_size {self.max_batch_size}"
                  if self.max_batch_size else ""), "y")

        _, state0 = cma.init(np.zeros(self.z_dim), self.sigma, self.popsize,
                             device=self.device)
        states = cma.stack_states(state0, m)

        data = {"targets": targets, "fixed": fixed}
        if weights is not None:
            data["weights"] = self._as_tensor(weights)
        if tell_inverted is not None:
            self._tell_fn = tell_inverted["transform_fn"]
            data["tell_t"] = self._as_tensor(tell_inverted["t"])
            data["tell_target"] = self._as_tensor(tell_inverted["targets"])
            tw = tell_inverted.get("weights")
            if tw is not None:
                data["tell_weight"] = binarize(self._as_tensor(tw))
        if hasattr(self.loss_fn, "precompute"):
            # the target side once, on the M unique targets
            with torch.no_grad():
                data["ctx"] = self.loss_fn.precompute(
                    data["targets"], data.get("weights"))
                if "tell_t" in data:
                    data["tell_ctx"] = self.loss_fn.precompute(
                        data.pop("tell_target"), data.pop("tell_weight", None))
        aux = self._make_aux(data, m)

        ckpt = FusedCheckpointer(checkpoint_path, "batched basin-cma",
                                 every=checkpoint_every)
        start = ckpt.resume({"states": states,
                             "generator": self.generator.get_state()})
        if ckpt.loaded is not None:
            states = ckpt.loaded["states"]
            self.generator.set_state(ckpt.loaded["generator"])

        self.losses, self.gen_seconds = [], []
        prev_min = None
        for gi in range(start, meta_steps):
            t0 = time.perf_counter()
            carry_in = {"states": states,
                        "generator": self.generator.get_state()}
            states, _, _, gen_min = self.generation(states, data, aux,
                                                    grad_steps, gi)
            if prev_min is not None:
                self.losses.append(to_numpy(prev_min))
                if progress_every and gi % progress_every == 0:
                    cprint(f"(batched basin-cma) gen {gi}/{meta_steps} min "
                           f"tell losses {np.round(self.losses[-1], 4)}", "c")
            prev_min = gen_min
            ckpt.save(gi, carry_in)
            self.gen_seconds.append(time.perf_counter() - t0)
        if prev_min is not None:
            self.losses.append(to_numpy(prev_min))
        ckpt.finalize(meta_steps, {"states": states,
                                   "generator": self.generator.get_state()})

        learn, final_loss = self._run_final(
            states, data, aux, meta_steps, last_grad_steps,
            final_segment_steps,
            final_checkpoint(checkpoint_path, start < meta_steps))

        loss = to_numpy(final_loss)
        loss = np.where(np.isfinite(loss), loss, np.inf)   # NaN samples lose
        best = torch.as_tensor(loss.argmin(axis=1), device=self.device)
        rows = torch.arange(m, device=self.device) * self.popsize + best
        result = {
            "z": learn["z"].detach().index_select(0, rows),
            "loss": torch.as_tensor(loss[np.arange(m), loss.argmin(axis=1)],
                                    device=self.device),
            "all_losses": loss,
            "cma_states": states,
            "loss_curves": (np.stack(self.losses) if self.losses
                            else np.zeros((0, m))),
        }
        for name in self.learnable_inputs:
            if name in learn:
                result[name] = learn[name].detach().index_select(0, rows)
        inputs = {"z": result["z"]}
        for name, v in fixed.items():
            inputs[name] = result[name] if name in result else v
        with torch.no_grad():
            result["out"] = self.model(**inputs)
        return result
