"""CMA optimizer mixin: ask/tell bookkeeping between the VariableManager and
the on-device CMA-ES (counterpart of ``pix2latent_tpu/optimizers/cma_base.py``).
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from pix2latent_tpu_torch.strategies import cma
from pix2latent_tpu_torch.utils.misc import cprint


class _BaseCMAOptimizer:
    """Mixin used with ``_BaseOptimizer``. One variable, flagged
    ``grad_free``, is searched by CMA."""

    def __init__(self):
        self.num_samples = -1
        self.cma_params = None
        self.cma_state = None
        self._gf_var = None          # (var_type, name, shape)
        self._sampled = None         # last asked candidates [pop, dim]

    def setup_cma(self, var_manager, popsize: Optional[int] = None,
                  active: bool = False):
        """Initialize CMA for the single ``grad_free`` variable; a
        ``(mu, sigma)`` tuple there seeds the search distribution."""
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
        self.cma_params, self.cma_state = cma.init(
            mu, sigma, popsize, active=active, device=var_manager.device)
        self.num_samples = popsize
        self._gf_var = (var_type, name, shape)
        cprint(f"(cma-es) number of samples: {self.num_samples}", "y")

    def cma_init(self, var_manager):
        """A fresh population with the grad-free variable from a CMA ask;
        the asked candidates are kept for the tell."""
        variables = var_manager.initialize(num_samples=self.num_samples,
                                           generator=self.generator)
        x = cma.ask(self.cma_params, self.cma_state, self.generator)
        var_type, name, shape = self._gf_var
        variables[var_type][name] = x.reshape(self.num_samples, *shape).clone()
        self._sampled = x
        return variables

    def cma_update(self, variables, loss=None, step=0):
        """Tell CMA the fitness of the population (a fresh tell loss when
        ``loss`` is None), keyed to the ASKED candidates."""
        if loss is None:
            loss = self.core.tell_loss(variables, self.generator, step)
        self.cma_state = cma.tell(self.cma_params, self.cma_state,
                                  self._sampled, loss)
        return loss

    def refine_and_tell(self, variables, grad_steps: int, gen_idx: int):
        """The rest of one generation after the ask (``cma_init``): fresh
        Adam state, ``grad_steps`` inner steps, a tell loss of the refined
        population with hooks applied, and the CMA tell with the asked
        candidates. The target context is computed once for both.
        Returns ``(tell losses [pop], inner losses [grad_steps, pop])``."""
        core = self.core
        variables = core._dedupe_outputs(variables)
        ctx = core.make_ctx(variables)
        variables, optimizer = core.init_opt_state(variables)
        variables, _, _, ys = core.grad_steps(
            variables, optimizer, self.generator, grad_steps,
            start_step=gen_idx * grad_steps, ctx=ctx)
        loss = core.tell_loss(variables, self.generator,
                              step=gen_idx * grad_steps + grad_steps, ctx=ctx)
        self.cma_update(variables, loss=loss)
        return loss, ys["loss"]

    def generation(self, grad_steps: int, gen_idx: int):
        """One BasinCMA generation: ask, refine, tell (see
        :meth:`refine_and_tell`)."""
        return self.refine_and_tell(self.cma_init(self.var_manager),
                                    grad_steps, gen_idx)
