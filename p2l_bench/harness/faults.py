"""Faults planted in the timed path underneath a run, for the tests and
the calibration that show the comparison catches them. The benchmark's
own runs never plant one.

- ``unchanged``: an optimizer step that returns its state unchanged;
- ``half_batch``: the step's loss the mean over the first half of the
  population's rows only;
- ``no_exchange``: the exchange between ranks left out (a gather that
  returns this rank's rows as if they were every rank's);
- ``answer``: an answer altered where it is produced (the first row's tell
  loss 1 % high).

With ``late`` a fault acts only once the first generation's tell loss has
been computed: a program that goes wrong only after its first call.
"""

from __future__ import annotations

import contextlib
from unittest import mock

import torch

FAULTS = ("unchanged", "half_batch", "no_exchange", "answer")


@contextlib.contextmanager
def planted(name, late: bool = False):
    """Plant fault ``name`` in the port's classes (None: none)."""
    if name is None:
        yield
        return
    if name not in FAULTS:
        raise ValueError(f"unknown fault {name!r}; known: {FAULTS}")
    from pix2latent_tpu_torch.core.step import ExecutionCore
    from pix2latent_tpu_torch.parallel.mesh import Mesh
    from pix2latent_tpu_torch.variables import VariableOptimizer

    tell_loss, step = ExecutionCore.tell_loss, VariableOptimizer.step
    forward_loss, gather = ExecutionCore._forward_loss, Mesh.gather
    tells = []

    def on():
        return not late or bool(tells)

    def told(self, *args, **kwargs):
        loss = tell_loss(self, *args, **kwargs)
        if name == "answer" and on():
            loss = loss.clone()
            loss[0] = loss[0] * 1.01
        tells.append(1)
        return loss

    def kept(self):
        if not on():
            step(self)

    def half(self, variables, ctx=None):
        mean, per_sample, out = forward_loss(self, variables, ctx)
        if on():
            mean = per_sample[:max(per_sample.shape[0] // 2, 1)].mean()
        return mean, per_sample, out

    def local(self, t):
        if not on():
            return gather(self, t)
        return torch.cat([t.detach().contiguous()] * self.size)

    patches = [mock.patch.object(ExecutionCore, "tell_loss", told)]
    if name == "unchanged":
        patches.append(mock.patch.object(VariableOptimizer, "step", kept))
    elif name == "half_batch":
        patches.append(mock.patch.object(ExecutionCore, "_forward_loss",
                                         half))
    elif name == "no_exchange":
        patches.append(mock.patch.object(Mesh, "gather", local))
    with contextlib.ExitStack() as stack:
        for patch in patches:
            stack.enter_context(patch)
        yield
