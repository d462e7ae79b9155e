"""Pluggable gradient-free strategies on the device (counterpart of
``pix2latent_tpu/strategies/registry.py``, the replacement of the
reference's nevergrad bridge).

Every strategy has the same interface, at any population size::

    strategy = registry["CMA"](dim, num_samples, mu, sigma, device="cuda")
    state    = strategy.init(generator)
    x, aux   = strategy.ask_with_aux(state, generator)   # x [num_samples, dim]
    state    = strategy.tell(state, x, loss, aux)        # loss [num_samples]
    best     = strategy.mean(state)

A state is a NamedTuple of tensors on the strategy's device
(``utils/checkpoint.py`` saves and rebuilds it); ``aux`` carries
per-candidate sampling data from ask to tell (TBPSA's sigmas, LM-MA-ES's
normals). The draws come from the ``torch.Generator`` passed in.

``init``, ``ask``, ``ask_with_aux`` and ``tell`` read nothing back to the
host, with one exception: the ``eigh`` of the full-covariance tells
(``CMA``, ``ActiveCMA`` and ``NGOpt`` where it routes to aCMA) checks its
solver's status on the host. So a fused generation driven by any other
strategy makes no host sync at all.

========================  ====================================================
Name                      Algorithm
========================  ====================================================
``CMA``                   full CMA-ES (rank-1 + rank-mu, CSA)
``ActiveCMA``             CMA-ES with aCMA negative-weight covariance updates
``DiagonalCMA``           sep-CMA-ES (diagonal covariance, O(d) updates)
``NGOpt``                 nevergrad's continuous portfolio selector
                          (:func:`NGOptSelector`)
``MetaRecentering``       one-shot budget-scaled Latin-hypercube sampling
``TBPSA``                 test-based population size adaptation ES
``OnePlusOne``            (1+lambda)-ES with the 1/5th success rule
``DE``                    differential evolution DE/rand/1/bin
``TwoPointsDE``           DE with the two-points (circular segment) crossover
``PSO``                   global-best particle swarm
``RandomSearch``          i.i.d. Gaussian sampling, keep the best
``LMMAES``                LM-MA-ES (``strategies/lmmaes.py``), no eigh
``LMCMA``                 alias of ``LMMAES``
========================  ====================================================

``Host:<name>`` names wrap a host-side optimizer (``strategies/host.py``).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from pix2latent_tpu_torch.strategies import cma as cma_mod
from pix2latent_tpu_torch.strategies import lmmaes
from pix2latent_tpu_torch.utils.device import resolve_device


def _argmin_row(loss, x):
    """(min loss, the row of ``x`` at the first minimum), without a host
    sync (``x[i]`` with a 0-d index tensor would read it back)."""
    i = torch.argmin(loss).reshape(1)
    return loss.index_select(0, i)[0], x.index_select(0, i)[0]


class _Base:
    def __init__(self, dim, num_samples, mu=None, sigma=1.0, device="cuda"):
        self.device = resolve_device(device)
        self.dim = int(dim)
        self.num_samples = int(num_samples)
        self.mu0 = (torch.zeros(self.dim, dtype=torch.float32,
                                device=self.device) if mu is None
                    else torch.as_tensor(np.asarray(mu, np.float32)
                                         if not isinstance(mu, torch.Tensor)
                                         else mu, dtype=torch.float32,
                                         device=self.device).reshape(-1))
        self.sigma0 = float(sigma)
        if not self.sigma0 > 0.0:
            raise ValueError(
                f"search sigma must be positive, got {sigma}: a zero sigma "
                "NaNs every (x - mean) / sigma update")

    def cache_token(self):
        """A hashable token of everything that parametrizes the strategy:
        two strategies with equal tokens behave the same, so a driver may
        share a generation built for either. Walks ``__dict__`` so that a
        subclass's hyperparameters (``MetaRecenteringStrategy.scale``,
        which depends on the budget) are in it; derived tensors
        (``CMAStrategy.params``) are functions of those. Reads tensors back
        to the host: call it outside a generation."""
        items = [type(self).__name__]
        for k in sorted(self.__dict__):
            v = self.__dict__[k]
            if isinstance(v, (int, float, str, bool, type(None))):
                items.append((k, v))
            elif isinstance(v, (np.ndarray, torch.Tensor)):
                a = (v.detach().cpu().numpy() if isinstance(v, torch.Tensor)
                     else v)
                items.append((k, a.shape, str(a.dtype), a.tobytes()))
        return tuple(items)

    def _randn(self, generator, *shape):
        return torch.randn(shape, generator=generator, device=self.device)

    def _rand(self, generator, *shape):
        return torch.rand(shape, generator=generator, device=self.device)

    def _scalar(self, value, dtype=torch.float32):
        return torch.full((), value, dtype=dtype, device=self.device)

    def init(self, generator):
        raise NotImplementedError

    def ask(self, state, generator):
        raise NotImplementedError

    def ask_with_aux(self, state, generator):
        """(x, aux): the default for strategies whose tell needs no aux."""
        return self.ask(state, generator), None

    def tell(self, state, x, loss, aux=None):
        raise NotImplementedError

    def mean(self, state):
        raise NotImplementedError


class CMAStrategy(_Base):
    """Full CMA-ES at a chosen population size (``strategies/cma.py``)."""

    active = False

    def __init__(self, dim, num_samples, mu=None, sigma=1.0, device="cuda"):
        super().__init__(dim, num_samples, mu, sigma, device)
        self.params, self._state0 = cma_mod.init(
            self.mu0, self.sigma0, popsize=max(self.num_samples, 2),
            active=self.active, device=self.device)

    def init(self, generator):
        return self._state0

    def ask(self, state, generator):
        return cma_mod.ask(self.params, state, generator)

    def tell(self, state, x, loss, aux=None):
        return cma_mod.tell(self.params, state, x, loss)

    def mean(self, state):
        return state.mean


class ActiveCMAStrategy(CMAStrategy):
    """CMA-ES with aCMA negative-weight covariance updates, the default of
    pycma and so of nevergrad's ``CMA``."""

    active = True


class DiagonalCMAStrategy(_Base):
    """sep-CMA-ES (Ros & Hansen 2008): CMA-ES with a diagonal covariance,
    O(d) ask and tell and no eigh; nevergrad's ``DiagonalCMA``. The same
    step-size control and rank-1 / rank-mu structure as ``strategies/cma.py``
    with the sep-CMA rate boost ``(d + 2) / 3``."""

    class State(NamedTuple):
        mean: torch.Tensor     # [d]
        sigma: torch.Tensor    # []
        diag_c: torch.Tensor   # [d] diagonal of C
        p_sigma: torch.Tensor  # [d]
        p_c: torch.Tensor      # [d]
        gen: torch.Tensor      # [] int32

    def __init__(self, dim, num_samples, mu=None, sigma=1.0, device="cuda"):
        super().__init__(dim, num_samples, mu, sigma, device)
        d = float(self.dim)
        # the weights from a population >= 2 (1 would give w = [0] / 0)
        lam = max(self.num_samples, 2)
        k = max(lam // 2, 1)
        w = np.log(lam / 2.0 + 0.5) - np.log(np.arange(1, k + 1))
        w = w / w.sum()
        self._w = torch.as_tensor(w, dtype=torch.float32, device=self.device)
        self._k = k
        mueff = 1.0 / float((w ** 2).sum())
        self._mueff = mueff
        self._c_sigma = (mueff + 2.0) / (d + mueff + 5.0)
        self._d_sigma = (1.0 + 2.0 * max(0.0, math.sqrt((mueff - 1.0)
                                                        / (d + 1.0)) - 1.0)
                         + self._c_sigma)
        self._c_c = (4.0 + mueff / d) / (d + 4.0 + 2.0 * mueff / d)
        c1 = 2.0 / ((d + 1.3) ** 2 + mueff)
        cmu = min(1.0 - c1, 2.0 * (mueff - 2.0 + 1.0 / mueff)
                  / ((d + 2.0) ** 2 + mueff))
        boost = (d + 2.0) / 3.0
        self._c1 = min(1.0, c1 * boost)
        self._cmu = min(1.0 - self._c1, cmu * boost)
        self._chi_d = math.sqrt(d) * (1.0 - 1.0 / (4.0 * d)
                                      + 1.0 / (21.0 * d * d))

    def init(self, generator):
        zeros = torch.zeros(self.dim, dtype=torch.float32, device=self.device)
        return self.State(self.mu0, self._scalar(self.sigma0),
                          torch.ones_like(zeros), zeros, zeros.clone(),
                          self._scalar(0, torch.int32))

    def ask(self, state, generator):
        eps = self._randn(generator, self.num_samples, self.dim)
        return (state.mean[None]
                + state.sigma * torch.sqrt(state.diag_c)[None] * eps)

    def tell(self, state, x, loss, aux=None):
        dt = state.mean.dtype
        idx = torch.argsort(loss, stable=True)[:self._k]
        y = (x.index_select(0, idx) - state.mean[None]) / state.sigma
        w = self._w.to(dt)
        y_w = w @ y
        mean = state.mean + state.sigma * y_w

        # the step-size path: C^{-1/2} is elementwise for a diagonal C
        p_sigma = ((1.0 - self._c_sigma) * state.p_sigma
                   + math.sqrt(self._c_sigma * (2.0 - self._c_sigma)
                               * self._mueff)
                   * y_w / torch.sqrt(state.diag_c))
        gen = state.gen + 1
        norm = torch.linalg.norm(p_sigma)
        denom = torch.sqrt(1.0 - torch.pow(
            torch.full((), 1.0 - self._c_sigma, dtype=dt, device=gen.device),
            2.0 * gen.to(dt)))
        h_sig = (norm / denom / self._chi_d
                 < 1.4 + 2.0 / (self.dim + 1.0)).to(dt)
        p_c = ((1.0 - self._c_c) * state.p_c
               + h_sig * math.sqrt(self._c_c * (2.0 - self._c_c)
                                   * self._mueff) * y_w)
        delta_h = (1.0 - h_sig) * self._c_c * (2.0 - self._c_c)
        diag_c = ((1.0 - self._c1 - self._cmu + self._c1 * delta_h)
                  * state.diag_c
                  + self._c1 * p_c ** 2
                  + self._cmu * (w @ y ** 2))
        sigma = state.sigma * torch.exp(
            (self._c_sigma / self._d_sigma) * (norm / self._chi_d - 1.0))
        return self.State(mean, torch.clamp(sigma, 1e-12, 1e12),
                          torch.clamp(diag_c, 1e-12, 1e12), p_sigma, p_c, gen)

    def mean(self, state):
        return state.mean


class _KeepBest(_Base):
    """A sampler that recommends the best point it has seen."""

    class State(NamedTuple):
        best_x: torch.Tensor
        best_f: torch.Tensor

    def init(self, generator):
        return self.State(self.mu0, self._scalar(math.inf))

    def tell(self, state, x, loss, aux=None):
        f, row = _argmin_row(loss, x)
        best_x = torch.where(f < state.best_f, row, state.best_x)
        return self.State(best_x, torch.minimum(f, state.best_f))

    def mean(self, state):
        return state.best_x


class MetaRecenteringStrategy(_KeepBest):
    """One-shot "meta-recentering" sampling (Meunier, Teytaud et al. 2020;
    nevergrad's ``MetaRecentering`` / ``MetaTuneRecentering``): the budget
    is sampled from ``N(mu, (scale sigma)^2 I)`` with the scale set by the
    budget b and the dimension d, and the best point seen is recommended.

    - ``autotune=True``: ``scale = sqrt(log(b) / d)``;
    - ``autotune=False``: ``scale = (1 + log(b)) / (4 log(d))``.

    The samples are a Latin hypercube (one per stratum per dimension), as in
    the JAX package, where nevergrad uses scrambled Hammersley. The
    independent per-column permutation of the strata is
    ``rand(n, d).argsort(dim=0)``, which has the same law as the JAX
    package's ``permutation(independent=True)``."""

    def __init__(self, dim, num_samples, mu=None, sigma=1.0, budget=None,
                 autotune=True, device="cuda"):
        super().__init__(dim, num_samples, mu, sigma, device)
        b = max(float(budget if budget is not None else num_samples), 2.0)
        d = float(max(self.dim, 2))
        if autotune:
            self.scale = float(np.sqrt(np.log(b) / d))
        else:
            self.scale = float((1.0 + np.log(b)) / (4.0 * np.log(d)))

    def ask(self, state, generator):
        n = self.num_samples
        perms = self._rand(generator, n, self.dim).argsort(dim=0)
        u = (perms + self._rand(generator, n, self.dim)) / n
        # the Gaussian quantile, away from 0 and 1 (ndtri(0) = -inf)
        eps = torch.special.ndtri(torch.clamp(u, 1e-7, 1.0 - 1e-7))
        return self.mu0[None] + self.scale * self.sigma0 * eps


def NGOptSelector(dim, num_samples, mu=None, sigma=1.0, budget=None,
                  noisy=False, device="cuda"):
    """Nevergrad's ``NGOpt`` portfolio selector for a continuous vector
    with ``num_samples`` parallel workers, each leaf mapped to its
    on-device counterpart as in the JAX package:

    ===========================================  ==========================
    nevergrad leaf                               on-device strategy
    ===========================================  ==========================
    TBPSA (noisy)                                ``TBPSAStrategy``
    MetaTuneRecentering (workers > budget/2,     ``MetaRecenteringStrategy``
      or budget < dim, in the parallel branch)     (autotune)
    NaiveTBPSA (workers > budget/5)              ``TBPSAStrategy``
    chainCMAPowell (1 worker, budget > 6000,     ``ActiveCMAStrategy``
      d > 7)
    Cobyla / OnePlusOne (1 worker,               ``OnePlusOneStrategy``
      budget < 30 d)
    DE (d > 2000)                                ``DEStrategy``
    CMA (default)                                ``ActiveCMAStrategy``
    ===========================================  ==========================

    Without a budget, routing is by dimension alone: ``DiagonalCMA`` for
    d >= 130, else aCMA. The drivers pass ``budget = meta_steps x
    num_samples`` (``optimizers/ng_base.py:setup_ng``)."""
    args = (dim, num_samples, mu, sigma)
    if noisy:
        return TBPSAStrategy(*args, device=device)
    if budget is None:
        cls = DiagonalCMAStrategy if dim >= 130 else ActiveCMAStrategy
        return cls(*args, device=device)
    budget = float(budget)
    workers = num_samples
    if workers > budget / 5.0:
        if workers > budget / 2.0 or budget < dim:
            return MetaRecenteringStrategy(*args, budget=budget,
                                           autotune=True, device=device)
        return TBPSAStrategy(*args, device=device)
    if workers == 1 and budget > 6000.0 and dim > 7:
        return ActiveCMAStrategy(*args, device=device)
    if workers == 1 and budget < 30.0 * dim:
        return OnePlusOneStrategy(*args, device=device)
    if dim > 2000:
        return DEStrategy(*args, device=device)
    return ActiveCMAStrategy(*args, device=device)


class TBPSAStrategy(_Base):
    """Test-based population size adaptation ES, nevergrad's ``_TBPSA``
    update: each candidate scales the step size by ``exp(N(0, 1) /
    sqrt(d))`` and samples ``x_i = center + sigma_i N(0, I)``; the tell takes
    the top ``max(popsize // 4, 1)``, whose mean is the new center and the
    geometric mean of whose sigmas is the new sigma. The sigmas travel from
    ask to tell as ``aux``."""

    class State(NamedTuple):
        mean: torch.Tensor
        sigma: torch.Tensor    # []

    def init(self, generator):
        return self.State(self.mu0, self._scalar(self.sigma0))

    def ask(self, state, generator):
        return self.ask_with_aux(state, generator)[0]

    def ask_with_aux(self, state, generator):
        logj = self._randn(generator, self.num_samples, 1) / math.sqrt(self.dim)
        sigmas = state.sigma * torch.exp(logj)                  # [n, 1]
        eps = self._randn(generator, self.num_samples, self.dim)
        return state.mean[None] + sigmas * eps, sigmas

    def tell(self, state, x, loss, aux=None):
        k = max(self.num_samples // 4, 1)
        idx = torch.argsort(loss, stable=True)[:k]
        top = x.index_select(0, idx)
        new_mean = top.mean(dim=0)
        if aux is not None:
            sel = aux.reshape(-1).index_select(0, idx)
        else:
            # without aux: sigma_i ~ |x_i - mean| / sqrt(d)
            sel = (torch.linalg.norm(top - state.mean[None], dim=1)
                   / math.sqrt(self.dim))
        new_sigma = torch.exp(torch.mean(torch.log(
            torch.clamp(sel, 1e-12, 1e12))))
        return self.State(new_mean, torch.clamp(new_sigma, 1e-8, 1e8))

    def mean(self, state):
        return state.mean


class OnePlusOneStrategy(_Base):
    """(1 + lambda)-ES with the 1/5th success rule; lambda = num_samples
    mutations of the incumbent a generation."""

    class State(NamedTuple):
        best_x: torch.Tensor
        best_f: torch.Tensor
        sigma: torch.Tensor

    def init(self, generator):
        return self.State(self.mu0, self._scalar(math.inf),
                          self._scalar(self.sigma0))

    def ask(self, state, generator):
        eps = self._randn(generator, self.num_samples, self.dim)
        return state.best_x[None] + state.sigma * eps

    def tell(self, state, x, loss, aux=None):
        f, row = _argmin_row(loss, x)
        improved = f < state.best_f
        best_x = torch.where(improved, row, state.best_x)
        # the 1/5th rule, adjusted for lambda parallel trials
        factor = torch.where(improved, math.exp(1.0 / 3.0),
                             math.exp(-1.0 / 12.0)).to(state.sigma.dtype)
        sigma = torch.clamp(state.sigma * factor, 1e-9, 1e9)
        return self.State(best_x, torch.minimum(f, state.best_f), sigma)

    def mean(self, state):
        return state.best_x


class DEStrategy(_Base):
    """Differential evolution, DE/rand/1 with binomial crossover (F = 0.8,
    CR = 0.9)."""
    F = 0.8
    CR = 0.9

    class State(NamedTuple):
        pop: torch.Tensor      # [n, d]
        fit: torch.Tensor      # [n]

    def init(self, generator):
        pop = self.mu0[None] + self.sigma0 * self._randn(
            generator, self.num_samples, self.dim)
        return self.State(pop, torch.full((self.num_samples,), math.inf,
                                          device=self.device))

    def _randint(self, generator, low, high, *shape):
        return torch.randint(low, high, shape, generator=generator,
                             device=self.device)

    def _crossover(self, generator, mutant, pop):
        cross = self._rand(generator, *pop.shape) < self.CR
        return torch.where(cross, mutant, pop)

    def ask(self, state, generator):
        n = self.num_samples
        a, b, c = (self._randint(generator, 0, n, n) for _ in range(3))
        pop = state.pop
        mutant = pop.index_select(0, a) + self.F * (
            pop.index_select(0, b) - pop.index_select(0, c))
        return self._crossover(generator, mutant, pop)

    def tell(self, state, x, loss, aux=None):
        better = loss < state.fit
        return self.State(torch.where(better[:, None], x, state.pop),
                          torch.where(better, loss, state.fit))

    def mean(self, state):
        return _argmin_row(state.fit, state.pop)[1]


class TwoPointsDEStrategy(DEStrategy):
    """DE with nevergrad's two-points crossover: the mutant replaces a
    random circular segment of the parent (start and length uniform, at
    least one gene), in place of the binomial crossover."""

    def _crossover(self, generator, mutant, pop):
        n, d = pop.shape
        start = self._randint(generator, 0, d, n, 1)
        length = self._randint(generator, 1, max(d, 2), n, 1)
        pos = torch.arange(d, device=self.device)[None, :]
        cross = torch.remainder(pos - start, d) < length
        return torch.where(cross, mutant, pop)


class PSOStrategy(_Base):
    """Global-best particle swarm (w = 0.72, c1 = c2 = 1.49)."""
    W = 0.72
    C1 = 1.49
    C2 = 1.49

    class State(NamedTuple):
        pos: torch.Tensor
        vel: torch.Tensor
        pbest: torch.Tensor
        pbest_f: torch.Tensor
        gbest: torch.Tensor
        gbest_f: torch.Tensor

    def init(self, generator):
        n = self.num_samples
        pos = self.mu0[None] + self.sigma0 * self._randn(generator, n,
                                                         self.dim)
        vel = 0.1 * self.sigma0 * self._randn(generator, n, self.dim)
        inf = torch.full((n,), math.inf, device=self.device)
        return self.State(pos, vel, pos, inf, self.mu0,
                          self._scalar(math.inf))

    def ask(self, state, generator):
        r1 = self._rand(generator, *state.pos.shape)
        r2 = self._rand(generator, *state.pos.shape)
        vel = (self.W * state.vel
               + self.C1 * r1 * (state.pbest - state.pos)
               + self.C2 * r2 * (state.gbest[None] - state.pos))
        return state.pos + vel

    def tell(self, state, x, loss, aux=None):
        vel = x - state.pos     # the velocity the ask took
        better = loss < state.pbest_f
        pbest = torch.where(better[:, None], x, state.pbest)
        pbest_f = torch.where(better, loss, state.pbest_f)
        f, row = _argmin_row(pbest_f, pbest)
        gbest = torch.where(f < state.gbest_f, row, state.gbest)
        return self.State(x, vel, pbest, pbest_f, gbest,
                          torch.minimum(f, state.gbest_f))

    def mean(self, state):
        return state.gbest


class LMMAESStrategy(_Base):
    """LM-MA-ES (``strategies/lmmaes.py``): limited-memory matrix
    adaptation, O(m d) ask and tell with ``m = 4 + 3 ln d`` rank-1 factors
    and no eigendecomposition; it learns cross-coordinate structure that
    ``DiagonalCMA`` cannot."""

    def __init__(self, dim, num_samples, mu=None, sigma=1.0, memory=None,
                 device="cuda"):
        super().__init__(dim, num_samples, mu, sigma, device)
        self.params, self._state0 = lmmaes.init(
            self.mu0, self.sigma0, popsize=max(self.num_samples, 2),
            memory=memory, device=self.device)
        # the resolved memory, so that cache_token() sees it
        self.memory = int(self.params.memory)

    def init(self, generator):
        return self._state0

    def ask(self, state, generator):
        return lmmaes.ask(self.params, state, generator)

    def ask_with_aux(self, state, generator):
        return lmmaes.ask_with_aux(self.params, state, generator)

    def tell(self, state, x, loss, aux=None):
        return lmmaes.tell(self.params, state, x, loss, aux=aux)

    def mean(self, state):
        return state.mean


class RandomSearchStrategy(_KeepBest):
    """i.i.d. Gaussian samples around the initial mean; keeps the best."""

    def ask(self, state, generator):
        return self.mu0[None] + self.sigma0 * self._randn(
            generator, self.num_samples, self.dim)


registry = {
    "CMA": CMAStrategy,
    "ActiveCMA": ActiveCMAStrategy,
    "DiagonalCMA": DiagonalCMAStrategy,
    "NGOpt": NGOptSelector,
    "MetaRecentering": MetaRecenteringStrategy,
    "TBPSA": TBPSAStrategy,
    "OnePlusOne": OnePlusOneStrategy,
    "DE": DEStrategy,
    "TwoPointsDE": TwoPointsDEStrategy,
    "PSO": PSOStrategy,
    "RandomSearch": RandomSearchStrategy,
    "LMMAES": LMMAESStrategy,
    # the limited-memory family under its other name
    "LMCMA": LMMAESStrategy,
}


def is_valid_method(name: str) -> bool:
    """True for registry names and for ``Host:<name>`` names (resolved
    lazily: the host backend may be registered later)."""
    return name in registry or name.startswith("Host:")


def resolve(name: str):
    """The strategy factory of ``name``: the registry's, or for
    ``Host:<name>`` the host escape hatch (``strategies/host.py``)."""
    if name in registry:
        return registry[name]
    if name.startswith("Host:"):
        from pix2latent_tpu_torch.strategies.host import make_host_strategy
        return make_host_strategy(name)
    raise KeyError(f"unknown strategy: {name}; available: {sorted(registry)} "
                   "plus 'Host:<backend>' names")
