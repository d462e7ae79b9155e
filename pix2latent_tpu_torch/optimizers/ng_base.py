"""The strategy-registry mixin of the gradient-free drivers (counterpart of
``pix2latent_tpu/optimizers/ng_base.py``, the replacement of the
reference's ``_BaseNevergradOptimizer``,
``pix2latent/optimizer/base_ng_optimizer.py:10-171``).

The same setup / init / update flow as the reference, on the registry
(``strategies/registry.py``): the population size is free and the whole
ask / evaluate / tell loop stays on the device. The fused generation, the
meta loops and the final run are the CMA drivers' own
(``optimizers/cma_base.py:_StrategyDriver``), over the registry strategy.

As in the JAX package, methods that nevergrad flags ``no_parallelization``
are not asked one candidate at a time: the on-device strategies evaluate
the whole population a generation (``OnePlusOne`` as lambda parallel
mutations). ``Host:<name>`` strategies keep the reference's one-at-a-time
asks in their nevergrad backend.
"""

from __future__ import annotations

import inspect

import numpy as np

from pix2latent_tpu_torch.optimizers.cma_base import _StrategyDriver
from pix2latent_tpu_torch.parallel.mesh import pad_population
from pix2latent_tpu_torch.strategies.cma import sanitize_fitness
from pix2latent_tpu_torch.strategies.host import HostStrategy
from pix2latent_tpu_torch.strategies.registry import (is_valid_method,
                                                      registry, resolve)
from pix2latent_tpu_torch.utils.misc import cprint


class _BaseNGOptimizer(_StrategyDriver):
    """Mixin used with ``_BaseOptimizer``. One variable, flagged
    ``grad_free``, is searched (the reference asserts the same,
    ``base_ng_optimizer.py:86-88``)."""

    _state_attr = "ng_state"

    def __init__(self, method: str):
        super().__init__()
        self.method = method
        self.valid_methods = sorted(registry) + ["Host:<backend>"]
        if not is_valid_method(method):
            raise ValueError(f"unknown strategy: {method}; available: "
                             f"{self.valid_methods}")
        self.ng_strategy = None
        self.ng_state = None

    def setup_ng(self, var_manager, num_samples: int, budget=None):
        """Build the strategy for the grad-free variable (reference
        ``base_ng_optimizer.py:51-89``); a ``(mu, sigma)`` tuple there seeds
        it. ``budget`` is the total number of evaluations (nevergrad's
        definition, generations x population): it goes to factories that
        route or scale on it (``NGOpt``, ``MetaRecentering``). On a mesh the
        population is padded to a multiple of its ranks and ``budget``
        rescaled by the same factor: callers count it as generations x the
        requested population, and the routing compares workers against it,
        so mixed units would change branches on meshed runs only."""
        gf = var_manager.grad_free_variables()
        if len(gf) != 1:
            raise ValueError(
                "currently only a single variable can be optimized "
                f"gradient-free but got: {[(vt, n) for vt, n, _ in gf]}")
        var_type, name, spec = gf[0]
        shape = spec["shape"]
        dim = int(np.prod(shape))

        mu, sigma = None, 1.0
        if isinstance(spec["grad_free"], tuple):
            m, s = spec["grad_free"]
            if m is not None:
                mu = np.asarray(m, np.float32).reshape(-1)
            if s is not None:
                sigma = float(s)

        requested = int(num_samples)
        num_samples = pad_population(requested, self.mesh)
        if budget is not None and num_samples != requested:
            budget = budget * num_samples / max(requested, 1)
        factory = resolve(self.method)
        kwargs = {}
        if budget is not None and "budget" in inspect.signature(
                factory).parameters:
            kwargs["budget"] = budget
        self.ng_strategy = factory(dim, num_samples, mu, sigma,
                                   device=var_manager.device, **kwargs)
        if isinstance(self.ng_strategy, HostStrategy) and self.mesh is not \
                None and self.mesh.size > 1:
            raise ValueError(f"'{self.method}' keeps its state in a host "
                             "object, which cannot be replicated over a "
                             "mesh of more than one rank; use an on-device "
                             "strategy")
        self.ng_state = self.ng_strategy.init(self.generator)
        self._replicate_search()
        self.num_samples = num_samples
        self._gf_var = (var_type, name, shape)
        cprint(f"({self.method}) number of samples: {num_samples}", "y")

    def reject_host_checkpoint(self, checkpoint_path):
        """``Host:`` strategies cannot checkpoint: their state lives in the
        wrapped host object, so a resumed run would restart the search while
        it says it resumed. Refuse instead."""
        if checkpoint_path and isinstance(self.ng_strategy, HostStrategy):
            raise ValueError(
                f"checkpoint_path is unsupported with '{self.method}': "
                "Host:<backend> strategies keep their state in the wrapped "
                "host optimizer object, which cannot be serialized, so a "
                "resume would restart the search. Drop checkpoint_path or "
                "use an on-device strategy.")

    def _ask(self, state):
        return self.ng_strategy.ask_with_aux(state, self.generator)

    def _tell(self, state, x, loss, aux):
        return self.ng_strategy.tell(state, x, sanitize_fitness(loss),
                                     aux=aux)

    def _fused_gen_key(self, grad_steps: int):
        """The step count, the strategy's ``cache_token()`` (budget-derived
        hyperparameters, NGOpt's leaf) and the grad-free variable. A
        ``Host:`` strategy is a new object every setup, so it is never
        memoised."""
        if isinstance(self.ng_strategy, HostStrategy):
            return None
        return (grad_steps, self.ng_strategy.cache_token(), self._gf_var)

    def ng_init(self, var_manager):
        """A fresh population with the grad-free variable from an ask
        (reference ``base_ng_optimizer.py:92-117``); the candidates and the
        ask's aux are kept for the tell."""
        return self._ask_population(var_manager)

    def ng_update(self, variables, loss=None, inverted_loss=False, step=0):
        """Tell the strategy the population's fitness (reference
        ``base_ng_optimizer.py:120-171``): ``loss``, or a fresh tell loss
        of ``variables`` (in the un-warped frame with ``inverted_loss``)."""
        return self._update(variables, loss, step, inverted=inverted_loss)

    def _setup(self, num_samples, meta_steps, checkpoint_path):
        self.setup_ng(self.var_manager, num_samples,
                      budget=meta_steps * num_samples)
        self.reject_host_checkpoint(checkpoint_path)
