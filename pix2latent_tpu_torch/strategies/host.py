"""The host escape hatch: any host-side ask/tell optimizer behind the
registry's interface (counterpart of ``pix2latent_tpu/strategies/host.py``).

The reference accepts every name of ``ng.optimizers.registry``; the
registry (``strategies/registry.py``) covers the core algorithms on the
device, and :class:`HostStrategy` recovers the rest. It adapts any stateful
host optimizer with

    xs = host.ask()            # [num_samples, dim] float
    host.tell(xs, losses)      # losses [num_samples]

to the registry's ask/tell. PyTorch runs eagerly, so there is no callback
and no ordering token: ``ask`` and ``tell`` call the host object directly,
with one numpy round trip each (a host sync on the card). The state is only
a version counter, so a ``HostStrategy`` run cannot be checkpointed: the
drivers refuse a ``checkpoint_path`` with it.

Usage::

    resolve("Host:OnePlusOne")(dim, n, mu, sigma)      # needs nevergrad
    register_host_backend("MyOpt", factory)           # any custom backend
    NevergradOptimizer("Host:MyOpt", ...)
"""

from __future__ import annotations

from typing import Callable, Dict, NamedTuple

import numpy as np
import torch

from pix2latent_tpu_torch.utils.device import resolve_device


class HostStrategy:
    """The registry's interface around a stateful host optimizer; the real
    state lives in the wrapped Python object."""

    def __init__(self, dim, num_samples, host, name="host", device="cuda"):
        self.device = resolve_device(device)
        self.dim = int(dim)
        self.num_samples = int(num_samples)
        self.sigma0 = 1.0           # the host owns its sigma
        self.mu0 = torch.zeros(self.dim, dtype=torch.float32,
                               device=self.device)
        self._host = host
        self.name = name

    class State(NamedTuple):
        version: torch.Tensor      # [] int32, the tells so far

    def cache_token(self):
        """Per instance, unlike the registry strategies' tokens: two host
        strategies of the same configuration wrap different host objects."""
        return (type(self).__name__, self.name, self.dim, self.num_samples,
                id(self))

    def init(self, generator):
        return self.State(torch.zeros((), dtype=torch.int32,
                                      device=self.device))

    def ask(self, state, generator):
        """``generator`` is unused: the host backend owns its random
        stream, as the reference's nevergrad bridge's does."""
        x = np.asarray(self._host.ask(), np.float32)
        if x.shape != (self.num_samples, self.dim):
            raise ValueError(f"host backend returned {x.shape}, expected "
                             f"{(self.num_samples, self.dim)}")
        return torch.as_tensor(x, device=self.device)

    def ask_with_aux(self, state, generator):
        return self.ask(state, generator), None

    def tell(self, state, x, loss, aux=None):
        self._host.tell(x.detach().cpu().numpy().astype(np.float32),
                        loss.detach().cpu().numpy().astype(np.float32))
        return self.State(state.version + 1)

    def mean(self, state):
        """The host's best known point: its ``mean()`` method or ``mean``
        attribute, zeros without either."""
        m = getattr(self._host, "mean", None)
        if callable(m):
            m = m()
        if m is None:
            return torch.zeros_like(self.mu0)
        return torch.as_tensor(np.asarray(m, np.float32), device=self.device)


_HOST_BACKENDS: Dict[str, Callable] = {}


def register_host_backend(name: str, factory: Callable):
    """Register ``factory(dim, num_samples, mu, sigma) -> host object``,
    found by ``resolve("Host:<name>")``."""
    _HOST_BACKENDS[name] = factory


class _NevergradBackend:
    """A nevergrad optimizer behind the host contract. It asks one
    candidate at a time (num_samples sequential asks a generation), the
    reference's ``no_parallelization`` behaviour, and keeps the candidates
    for the tell."""

    def __init__(self, ng_name, dim, num_samples, mu, sigma):
        import nevergrad as ng

        init = (np.zeros(dim, np.float64) if mu is None
                else np.asarray(mu, np.float64).reshape(-1))
        param = ng.p.Array(init=init)
        if sigma is not None and float(sigma) != 1.0:
            # the grad_free (mu, sigma) seed reaches the host optimizer as
            # the parametrization's mutation sigma
            param.set_mutation(sigma=float(sigma))
        self._opt = ng.optimizers.registry[ng_name](
            parametrization=param, budget=None, num_workers=1)
        self._pending = []
        self.num_samples = num_samples

    def ask(self):
        self._pending = [self._opt.ask() for _ in range(self.num_samples)]
        return np.stack([c.value for c in self._pending])

    def tell(self, x, loss):
        for cand, f in zip(self._pending, loss):
            self._opt.tell(cand, float(f))
        self._pending = []

    def mean(self):
        return np.asarray(self._opt.provide_recommendation().value)


def make_host_strategy(name: str):
    """The factory of ``resolve("Host:<name>")``: a registered backend, else
    the name in nevergrad's registry; without either it raises."""
    backend_name = name.split(":", 1)[1]

    def build(dim, num_samples, mu=None, sigma=1.0, device="cuda"):
        if backend_name in _HOST_BACKENDS:
            host = _HOST_BACKENDS[backend_name](dim, num_samples, mu, sigma)
            return HostStrategy(dim, num_samples, host, name=name,
                                device=device)
        try:
            import nevergrad  # noqa: F401
        except ImportError as e:
            raise RuntimeError(
                f"'{name}' needs either a backend registered via "
                f"register_host_backend({backend_name!r}, factory) or an "
                "importable nevergrad package; neither is present. The "
                "registry (pix2latent_tpu_torch.strategies.registry) covers "
                "the core algorithms on the device.") from e
        host = _NevergradBackend(backend_name, dim, num_samples, mu, sigma)
        return HostStrategy(dim, num_samples, host, name=name, device=device)

    return build
