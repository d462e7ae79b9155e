"""Checkpoint and resume for long inversion runs (counterpart of
``pix2latent_tpu/utils/checkpoint.py``).

A checkpoint is one ``.npz`` written atomically (a temporary file in the same
directory, then ``os.replace``), holding the tensors of a nested dict, list,
tuple or NamedTuple as ``leaf_0 .. leaf_{n-1}`` in a fixed order: dict keys
sorted, sequences in order, ``None`` holding no leaf. Loading needs a
template of the same structure (``like``) and puts each leaf on the device
and in the dtype of the template's leaf.

What a run carries: the CMA state, the state of the optimizer's
``torch.Generator`` (the counterpart of the JAX package's PRNG key, a uint8
tensor on the CPU), the meta-iteration counter, and for a segmented gradient
run the variables and the per-variable optimizers' state
(``VariableOptimizer.state``); for the transform search also the
propagation means, the best loss and the best candidate.

On a population mesh (``parallel/mesh.py``) the file holds what a run
without a mesh holds: the search state and the generator's state are the
same on every rank, a gradient run's carry is gathered from every rank, and
rank 0 alone writes (``mesh=`` here, the optimizer's ``mesh`` for
:class:`LoopCheckpointer`). Every rank loads the file and keeps its rows.
"""

from __future__ import annotations

import os
import tempfile

import numpy as np
import torch

from pix2latent_tpu_torch.utils.misc import cprint


def _leaves(tree):
    """The tensors of ``tree`` in checkpoint order."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [leaf for v in tree for leaf in _leaves(v)]
    return [tree]


def _rebuild(like, leaves):
    """``like``'s structure with its leaves taken in order from the iterator
    ``leaves`` (each a numpy array), placed as ``like``'s leaf."""
    if like is None:
        return None
    if isinstance(like, dict):
        return {k: _rebuild(like[k], leaves) for k in sorted(like)}
    if isinstance(like, tuple) and hasattr(like, "_fields"):      # NamedTuple
        return type(like)(*(_rebuild(v, leaves) for v in like))
    if isinstance(like, (list, tuple)):
        return type(like)(_rebuild(v, leaves) for v in like)
    arr = next(leaves)
    if isinstance(like, torch.Tensor):
        return torch.as_tensor(arr).to(device=like.device, dtype=like.dtype)
    return type(like)(arr.item()) if np.ndim(arr) == 0 else arr


def _to_numpy(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def save_checkpoint(path, tree):
    """Atomically write the tensors of ``tree`` to ``path`` (.npz)."""
    payload = {f"leaf_{i}": _to_numpy(x) for i, x in enumerate(_leaves(tree))}
    d = os.path.dirname(os.path.abspath(path)) or "."
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp")
    os.close(fd)
    try:
        with open(tmp, "wb") as f:
            np.savez(f, **payload)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return path


def load_checkpoint(path, like):
    """Restore a tree saved by :func:`save_checkpoint` into ``like``'s
    structure, each leaf on the device and in the dtype of ``like``'s."""
    with np.load(path, allow_pickle=False) as z:
        n = len([k for k in z.files if k.startswith("leaf_")])
        flat = [np.asarray(z[f"leaf_{i}"]) for i in range(n)]
    want = len(_leaves(like))
    if want != n:
        raise ValueError(f"checkpoint {path} has {n} leaves; the template "
                         f"has {want}")
    return _rebuild(like, iter(flat))


def checkpoint_exists(path):
    return bool(path) and os.path.exists(path)


def _writes(mesh) -> bool:
    return mesh is None or mesh.is_writer


def final_checkpoint(path, meta_loop_ran: bool, mesh=None):
    """The path of a driver's final-run checkpoint, ``path + ".final"``
    (None without ``path``). When the meta loop ran a generation in this
    call, a final-run checkpoint on disk belongs to an earlier, shorter run
    and is removed (by rank 0 of a ``mesh``, which every rank then waits
    for): only a run whose meta loop was already finished resumes its final
    run."""
    if not path:
        return None
    final = path + ".final"
    if meta_loop_ran and _writes(mesh) and os.path.exists(final):
        os.remove(final)
    if mesh is not None:
        mesh.barrier()
    return final


class FusedCheckpointer:
    """Crash-safe resume for the fused meta loops (``optimize_fused``).

    - The carry is a dict the driver threads itself: the CMA state and the
      generator state.
    - ``save(gi, carry)`` is called with the carry ENTERING generation
      ``gi``, after that generation has run: the previous generation's
      output, which the one-behind loss fetch has already read. A crash
      costs at most two generations.
    - ``finalize(meta_steps, carry)`` writes the carry after the loop, so
      re-running a finished run skips the whole loop.
    """

    def __init__(self, path, label: str, every: int = 1, mesh=None):
        self.path = path
        self.label = label
        self.every = max(int(every), 1)
        self.loaded = None
        self.writes = _writes(mesh)

    def resume(self, template: dict) -> int:
        """Load ``{**template, meta_iter}`` if a checkpoint exists; the
        restored carry lands in ``self.loaded``. Returns the start
        generation (0 on a fresh run)."""
        if not checkpoint_exists(self.path):
            return 0
        saved = load_checkpoint(
            self.path, {**template, "meta_iter": torch.zeros((), dtype=torch.int32)})
        start = int(saved.pop("meta_iter"))
        self.loaded = saved
        cprint(f"(checkpoint) resumed {self.label} at generation {start}", "y")
        return start

    def save(self, meta_iter: int, carry: dict):
        """Write ``carry`` as the state entering generation ``meta_iter``."""
        if self.path and self.writes and meta_iter % self.every == 0:
            save_checkpoint(self.path, {**carry, "meta_iter": np.int32(meta_iter)})

    def finalize(self, meta_steps: int, carry: dict):
        if self.path and self.writes:
            save_checkpoint(self.path, {**carry, "meta_iter": np.int32(meta_steps)})


class LoopCheckpointer:
    """Crash-safe resume for a host ask-eval-tell meta loop: one optimizer
    attribute holding the strategy state (``cma_state``), the optimizer's
    generator state, the meta-iteration counter, and ``extra_attrs``, more
    optimizer attributes whose structure stays the same through the loop
    (the transform search's propagation means and best candidate).

    Usage::

        ckpt = LoopCheckpointer(path, opt, "cma_state", every=k)
        start = ckpt.resume()            # 0 if no checkpoint on disk
        for i in range(start, n):
            ...
            ckpt.save(i + 1)             # no-op unless (i + 1) % every == 0
    """

    def __init__(self, path, optimizer, state_attr: str, every: int = 1,
                 extra_attrs: tuple = ()):
        self.path = path
        self.opt = optimizer
        self.state_attr = state_attr
        self.every = max(int(every), 1)
        self.extra_attrs = tuple(extra_attrs)

    def _carry(self, meta_iter: int):
        return {"state": getattr(self.opt, self.state_attr),
                "generator": self.opt.generator.get_state(),
                "meta_iter": np.int32(meta_iter),
                "extra": {a: getattr(self.opt, a) for a in self.extra_attrs}}

    def resume(self) -> int:
        if not checkpoint_exists(self.path):
            return 0
        like = self._carry(0)
        like["meta_iter"] = torch.zeros((), dtype=torch.int32)
        carry = load_checkpoint(self.path, like)
        setattr(self.opt, self.state_attr, carry["state"])
        self.opt.generator.set_state(carry["generator"])
        for a in self.extra_attrs:
            setattr(self.opt, a, carry["extra"][a])
        start = int(carry["meta_iter"])
        cprint(f"(checkpoint) resumed at generation {start}", "y")
        return start

    def save(self, meta_iter: int):
        if (self.path and meta_iter % self.every == 0
                and _writes(getattr(self.opt, "mesh", None))):
            save_checkpoint(self.path, self._carry(meta_iter))
