"""On-device CMA-ES (counterpart of ``pix2latent_tpu/strategies/cma.py``).

The (mu/mu_w, lambda)-CMA-ES with cumulative step-size adaptation and
rank-1 + rank-mu covariance updates (Hansen, "The CMA Evolution Strategy: A
Tutorial"), with optional active (negative-weight) covariance updates. The
whole strategy stays on the state's device and in the state's dtype: float32
in production, float64 in the numerical cross-checks.

Eigenvectors from ``torch.linalg.eigh`` may differ in sign from
``jnp.linalg.eigh``; ``C``, ``mean``, ``sigma`` and the paths do not.

:func:`ask` and :func:`tell` also take M independent states stacked on a
leading axis (:func:`stack_states`; candidates ``[M, popsize, n]``, fitness
``[M, popsize]``): the M tells then share one batched ``eigh``, and so one
host sync.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import numpy as np
import torch


def default_popsize(n: int) -> int:
    """PyCMA's default population size: ``4 + floor(3 ln n)``."""
    return 4 + int(math.floor(3.0 * math.log(max(n, 2))))


class CMAParams(NamedTuple):
    """Strategy constants for dimension n and population lambda."""
    n: int
    popsize: int
    mu: int
    weights: torch.Tensor   # [popsize]; zero (plain) or negative (active)
    #                         beyond mu
    mueff: float
    cc: float
    cs: float
    c1: float
    cmu: float
    damps: float
    chi_n: float
    active: bool = False


class CMAState(NamedTuple):
    mean: torch.Tensor      # [n]
    sigma: torch.Tensor     # [] overall step size
    C: torch.Tensor         # [n, n] covariance
    B: torch.Tensor         # [n, n] eigenbasis of C
    D: torch.Tensor         # [n] sqrt-eigenvalues of C
    p_sigma: torch.Tensor   # [n] step-size evolution path
    p_c: torch.Tensor       # [n] covariance evolution path
    gen: torch.Tensor       # [] int32 generation counter


def make_params(n: int, popsize: Optional[int] = None, active: bool = False,
                device=None) -> CMAParams:
    """Strategy coefficients; ``active=True`` enables aCMA (tutorial eq. 53)."""
    if popsize is None:
        popsize = default_popsize(n)
    popsize = int(popsize)
    if popsize < 2:
        raise ValueError("CMA-ES needs popsize >= 2")
    mu = popsize // 2

    w_raw = np.log((popsize + 1) / 2.0) - np.log(np.arange(1, popsize + 1))
    w = w_raw[:mu] / w_raw[:mu].sum()
    mueff = float(1.0 / np.sum(w ** 2))
    weights = np.zeros(popsize, dtype=np.float32)
    weights[:mu] = w

    nf = float(max(n, 1))
    cc = (4.0 + mueff / nf) / (nf + 4.0 + 2.0 * mueff / nf)
    cs = (mueff + 2.0) / (nf + mueff + 5.0)
    c1 = 2.0 / ((nf + 1.3) ** 2 + mueff)
    cmu = min(1.0 - c1, 2.0 * (mueff - 2.0 + 1.0 / mueff) /
              ((nf + 2.0) ** 2 + mueff))
    damps = 1.0 + 2.0 * max(0.0, math.sqrt((mueff - 1.0) / (nf + 1.0)) - 1.0) + cs
    chi_n = math.sqrt(nf) * (1.0 - 1.0 / (4.0 * nf) + 1.0 / (21.0 * nf ** 2))

    if active:
        w_neg = w_raw[mu:]
        mueff_neg = float(w_neg.sum() ** 2 / np.sum(w_neg ** 2))
        # with cmu = 0 (popsize 2) the negative weights never enter the
        # rank-mu update: the cmu-normalized guards are vacuous
        a_mu = 1.0 + c1 / cmu if cmu > 0.0 else np.inf
        a_mueff = 1.0 + 2.0 * mueff_neg / (mueff + 2.0)
        a_posdef = ((1.0 - c1 - cmu) / (nf * cmu) if cmu > 0.0 else np.inf)
        scale = min(a_mu, a_mueff, a_posdef) / abs(w_neg.sum())
        weights[mu:] = (w_neg * scale).astype(np.float32)

    return CMAParams(n=int(n), popsize=popsize, mu=mu,
                     weights=torch.as_tensor(weights, device=device),
                     mueff=mueff, cc=cc, cs=cs, c1=c1, cmu=cmu,
                     damps=damps, chi_n=chi_n, active=bool(active))


def init(mean, sigma: float = 1.0, popsize: Optional[int] = None,
         active: bool = False, device=None, dtype=torch.float32):
    """(params, state) for a search centered at ``mean`` with step ``sigma``."""
    if not float(sigma) > 0.0:
        raise ValueError(f"CMA sigma must be positive, got {sigma}")
    mean = torch.as_tensor(np.asarray(mean) if not isinstance(
        mean, torch.Tensor) else mean, dtype=dtype, device=device).reshape(-1)
    n = mean.shape[0]
    device = mean.device
    params = make_params(n, popsize, active=active, device=device)
    eye = torch.eye(n, dtype=dtype, device=device)
    state = CMAState(
        mean=mean,
        sigma=torch.tensor(float(sigma), dtype=dtype, device=device),
        C=eye.clone(), B=eye.clone(),
        D=torch.ones(n, dtype=dtype, device=device),
        p_sigma=torch.zeros(n, dtype=dtype, device=device),
        p_c=torch.zeros(n, dtype=dtype, device=device),
        gen=torch.zeros((), dtype=torch.int32, device=device))
    return params, state


def stack_states(state: CMAState, m: int) -> CMAState:
    """``m`` copies of ``state`` stacked on a leading axis."""
    return CMAState(*(t.expand(m, *t.shape).clone() for t in state))


def ask(params: CMAParams, state: CMAState, generator) -> torch.Tensor:
    """Sample lambda candidates ~ N(mean, sigma^2 C): ``[popsize, n]``, or
    ``[M, popsize, n]`` for stacked states."""
    x, _ = ask_with_y(params, state, generator)
    return x


def ask_with_y(params: CMAParams, state: CMAState, generator):
    """Like :func:`ask`, also returning ``y`` with ``x = mean + sigma * y``."""
    batch = tuple(state.mean.shape[:-1])
    z = torch.randn((*batch, params.popsize, params.n), generator=generator,
                    device=state.mean.device, dtype=state.mean.dtype)
    y = (z * state.D[..., None, :]) @ state.B.transpose(-1, -2)
    return state.mean[..., None, :] + state.sigma[..., None, None] * y, y


def sanitize_fitness(fitness: torch.Tensor) -> torch.Tensor:
    """Replace non-finite fitness with a worse-than-worst penalty (per row
    of the last axis); an all-non-finite generation maps to one penalty
    (stable ranking)."""
    finite = torch.isfinite(fitness)
    neg_inf = torch.full_like(fitness, -math.inf)
    worst = torch.amax(torch.where(finite, fitness, neg_inf), dim=-1,
                       keepdim=True)
    worst = torch.where(finite.any(dim=-1, keepdim=True), worst,
                        torch.zeros_like(worst))
    penalty = worst + 1e3 * (1.0 + worst.abs())
    return torch.where(finite, fitness, penalty)


def tell(params: CMAParams, state: CMAState, x: torch.Tensor,
         fitness: torch.Tensor, y: Optional[torch.Tensor] = None,
         refresh_eigen: bool = True) -> CMAState:
    """Rank candidates by fitness (lower is better) and update the strategy;
    stacked states take ``x [M, popsize, n]`` and ``fitness [M, popsize]``
    and update each state from its own row.

    Pass ``y`` from :func:`ask_with_y` to avoid the cancellation in
    ``(x - mean) / sigma`` when ``sigma`` is tiny. Arithmetic runs in the
    state's dtype."""
    dt = state.mean.dtype
    fitness = sanitize_fitness(fitness.to(dt))
    order = torch.argsort(fitness, dim=-1, stable=True)
    w = params.weights.to(dt)[torch.argsort(order, dim=-1, stable=True)]
    sigma0 = state.sigma[..., None]                   # [..., 1]
    if y is None:
        y = (x.to(dt) - state.mean[..., None, :]) / sigma0[..., None]

    def vec(v, m):               # (v [..., k]) @ (m [..., k, n]) -> [..., n]
        return (v[..., None, :] @ m)[..., 0, :]

    def mat_vec(m, v):           # (m [..., n, k]) @ (v [..., k]) -> [..., n]
        return (m @ v[..., :, None])[..., 0]

    # mean and paths use the positive weights only (aCMA's negative weights
    # act on the covariance alone)
    w_pos = torch.clamp(w, min=0.0)
    y_w = vec(w_pos, y)
    new_mean = state.mean + sigma0 * y_w

    inv_d = 1.0 / torch.clamp(state.D, min=1e-20)
    c_inv_sqrt_yw = mat_vec(state.B,
                            inv_d * mat_vec(state.B.transpose(-1, -2), y_w))

    cs, cc, c1, cmu = params.cs, params.cc, params.c1, params.cmu
    mueff, chi_n = params.mueff, params.chi_n

    p_sigma = ((1.0 - cs) * state.p_sigma +
               math.sqrt(cs * (2.0 - cs) * mueff) * c_inv_sqrt_yw)

    gen1 = state.gen.to(dt) + 1.0
    ps_norm = torch.linalg.norm(p_sigma, dim=-1)
    # a fill, not torch.tensor(..., device=...): a host-to-device copy
    # waits for the device
    denom = torch.sqrt(1.0 - torch.pow(
        torch.full((), 1.0 - cs, dtype=dt, device=gen1.device), 2.0 * gen1))
    h_sigma = (ps_norm / denom / chi_n <
               1.4 + 2.0 / (params.n + 1.0)).to(dt)

    p_c = ((1.0 - cc) * state.p_c +
           h_sigma[..., None] * math.sqrt(cc * (2.0 - cc) * mueff) * y_w)

    if params.active:
        # negative weights rescaled by n / ||C^{-1/2} y_i||^2 (tutorial eq. 53)
        y_eig = (y @ state.B) * inv_d[..., None, :]
        norm2 = (y_eig ** 2).sum(dim=-1)
        w_o = torch.where(w >= 0.0, w,
                          w * params.n / torch.clamp(norm2, min=1e-20))
    else:
        w_o = w
    rank_mu = (y * w_o[..., None]).transpose(-1, -2) @ y
    delta_h = ((1.0 - h_sigma) * cc * (2.0 - cc))[..., None, None]
    w_sum = w.sum(dim=-1)[..., None, None] if params.active else 1.0
    C = ((1.0 - c1 - cmu * w_sum) * state.C +
         c1 * (p_c[..., :, None] * p_c[..., None, :] + delta_h * state.C) +
         cmu * rank_mu)
    C = 0.5 * (C + C.transpose(-1, -2))

    sigma = state.sigma * torch.exp((cs / params.damps) * (ps_norm / chi_n - 1.0))
    sigma = torch.clamp(sigma, 1e-12, 1e12)

    if refresh_eigen:
        eigvals, B = torch.linalg.eigh(C)
        D = torch.sqrt(torch.clamp(eigvals, min=1e-20))
    else:
        B, D = state.B, state.D

    return CMAState(mean=new_mean, sigma=sigma, C=C, B=B, D=D,
                    p_sigma=p_sigma, p_c=p_c, gen=state.gen + 1)


def refresh_eigen(state: CMAState) -> CMAState:
    """Recompute the cached eigendecomposition of C."""
    eigvals, B = torch.linalg.eigh(state.C)
    return state._replace(B=B, D=torch.sqrt(torch.clamp(eigvals, min=1e-20)))


class CMA:
    """Stateful wrapper with the reference's ``CMA`` interface
    (``batch_size`` / ``ask`` / ``tell`` / ``mean``; counterpart of the JAX
    package's ``strategies.cma.CMA``). The state stays on ``device`` between
    calls; the draws come from a ``torch.Generator`` seeded with ``seed``
    (0 when None)."""

    def __init__(self, mu=None, sigma: float = 1.0, seed: Optional[int] = None,
                 popsize: Optional[int] = None, active: bool = False,
                 device="cuda"):
        from pix2latent_tpu_torch.utils.device import resolve_device
        device = resolve_device(device)
        if mu is None:
            mu = np.zeros(128, dtype=np.float32)
        self.params, self.state = init(mu, sigma, popsize, active=active,
                                       device=device)
        self._generator = torch.Generator(device=device)
        self._generator.manual_seed(0 if seed is None else int(seed))
        self._device = device

    def batch_size(self) -> int:
        return self.params.popsize

    def ask(self, batch_size=None) -> torch.Tensor:
        if batch_size is not None and batch_size != self.params.popsize:
            raise ValueError("popsize is fixed at init; pass popsize= to the "
                             "constructor")
        self._x = ask(self.params, self.state, self._generator)
        return self._x

    def tell(self, x, y):
        def f32(a):
            return torch.as_tensor(a if isinstance(a, torch.Tensor)
                                   else np.asarray(a), dtype=torch.float32,
                                   device=self._device)
        self.state = tell(self.params, self.state, f32(x), f32(y))

    def mean(self):
        return self.state.mean
