"""LM-MA-ES, limited-memory matrix adaptation for high-dimensional search
(counterpart of ``pix2latent_tpu/strategies/lmmaes.py``).

LM-MA-ES (Loshchilov, Glasmachers & Beyer, IEEE TEC 2019;
arXiv:1705.06693) models the transformation matrix as an implicit product
of ``m`` rank-1 factors built from evolution paths ``M_j`` at geometrically
spaced timescales:

    d = (prod_j [(1 - c_d,j) I + c_d,j M_j M_j^T]) z,   x = mean + sigma d

so ask and tell are O(m d), with no d x d matrix and no eigendecomposition:
nothing in this module reads back to the host. The paths and the step-size
path live in the isotropic z-space.

Constants follow the paper: ``m = 4 + floor(3 ln d)``,
``c_d,j = 1 / (1.5^j d)``, ``c_c,j = lambda / (4^j d)`` (j = 0..m-1),
``c_sigma = 2 lambda / d``, each clipped for small d as the JAX package
does. Factor j applies once it has had j updates (``gen > j``). The JAX
package's ``lax.scan`` over the m factors is a Python loop of m small
tensor operations here (m = 18 at d = 128).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch


def default_memory(dim: int) -> int:
    """Paper default: ``4 + floor(3 ln d)`` stored paths."""
    return 4 + int(math.floor(3.0 * math.log(max(dim, 2))))


class LMMAESParams(NamedTuple):
    """Constants for dimension d and population lambda."""
    dim: int
    popsize: int
    memory: int
    weights: torch.Tensor  # [mu] positive recombination weights
    mueff: float
    c_sigma: float
    d_sigma: float
    c_d: torch.Tensor      # [m] per-factor application rates
    c_c: torch.Tensor      # [m] per-factor path learning rates
    chi_d: float


class LMMAESState(NamedTuple):
    mean: torch.Tensor     # [d]
    sigma: torch.Tensor    # []
    p_sigma: torch.Tensor  # [d] step-size path (z-space)
    paths: torch.Tensor    # [m, d] rank-1 factor paths (z-space)
    gen: torch.Tensor      # [] int32


def make_params(dim: int, popsize=None, memory=None,
                device=None) -> LMMAESParams:
    """Paper constants with the small-d clips (no-ops for d >> lambda)."""
    if popsize is None:
        popsize = default_memory(dim)
    popsize = int(popsize)
    if popsize < 2:
        raise ValueError("LM-MA-ES needs popsize >= 2")
    memory = default_memory(dim) if memory is None else int(memory)
    mu = popsize // 2

    w_raw = np.log((popsize + 1) / 2.0) - np.log(np.arange(1, mu + 1))
    w = w_raw / w_raw.sum()
    mueff = float(1.0 / np.sum(w ** 2))

    d = float(max(dim, 1))
    # c_sigma = 2 lambda / d, clipped: at small d it would extrapolate
    c_sigma = min(2.0 * popsize / d, 0.5)
    d_sigma = (1.0 + 2.0 * max(0.0, math.sqrt((mueff - 1.0) / (d + 1.0))
                               - 1.0) + c_sigma)
    j = np.arange(memory, dtype=np.float64)
    c_d = np.minimum(1.0 / (1.5 ** j * d), 0.5)
    c_c = np.minimum(popsize / (4.0 ** j * d), 0.5)
    chi_d = math.sqrt(d) * (1.0 - 1.0 / (4.0 * d) + 1.0 / (21.0 * d * d))

    def f32(a):
        return torch.as_tensor(a, dtype=torch.float32, device=device)

    return LMMAESParams(dim=int(dim), popsize=popsize, memory=memory,
                        weights=f32(w), mueff=mueff, c_sigma=c_sigma,
                        d_sigma=d_sigma, c_d=f32(c_d), c_c=f32(c_c),
                        chi_d=chi_d)


def init(mean, sigma: float = 1.0, popsize=None, memory=None, device=None,
         dtype=torch.float32):
    """(params, state) centered at ``mean`` with step ``sigma``."""
    if not float(sigma) > 0.0:
        raise ValueError(f"LM-MA-ES sigma must be positive, got {sigma}")
    mean = torch.as_tensor(np.asarray(mean) if not isinstance(
        mean, torch.Tensor) else mean, dtype=dtype, device=device).reshape(-1)
    dim = mean.shape[0]
    params = make_params(dim, popsize, memory, device=mean.device)
    state = LMMAESState(
        mean=mean,
        sigma=torch.tensor(float(sigma), dtype=dtype, device=mean.device),
        p_sigma=torch.zeros(dim, dtype=dtype, device=mean.device),
        paths=torch.zeros(params.memory, dim, dtype=dtype, device=mean.device),
        gen=torch.zeros((), dtype=torch.int32, device=mean.device))
    return params, state


def _transform(params: LMMAESParams, state: LMMAESState,
               z: torch.Tensor) -> torch.Tensor:
    """d = prod_j [(1 - c_d,j) I + c_d,j M_j M_j^T] z, factor 0 (the
    fastest timescale) first; factor j is inert until ``gen > j``."""
    c_d = params.c_d.to(z.dtype)
    paths = state.paths.to(z.dtype)
    d_vecs = z
    for j in range(params.memory):
        path, cd = paths[j], c_d[j]
        dot = d_vecs @ path                                   # [lambda]
        new = (1.0 - cd) * d_vecs + cd * dot[:, None] * path[None, :]
        d_vecs = torch.where(state.gen > j, new, d_vecs)
    return d_vecs


def _inverse_transform(params: LMMAESParams, state: LMMAESState,
                       d_vecs: torch.Tensor) -> torch.Tensor:
    """Exact inverse of :func:`_transform` (Sherman-Morrison per factor, in
    reverse order), for a tell given candidates without the ask's aux."""
    c_d = params.c_d.to(d_vecs.dtype)
    paths = state.paths.to(d_vecs.dtype)
    z = d_vecs
    for j in reversed(range(params.memory)):
        path, cd = paths[j], c_d[j]
        # ((1-c) I + c p p^T)^{-1} u = (u - c p (p^T u)/((1-c)+c|p|^2))/(1-c)
        denom = (1.0 - cd) + cd * torch.sum(path * path)
        dot = z @ path                                        # [lambda]
        new = (z - (cd / denom) * dot[:, None] * path[None, :]) / (1.0 - cd)
        z = torch.where(state.gen > j, new, z)
    return z


def ask_with_aux(params: LMMAESParams, state: LMMAESState, generator):
    """lambda candidates and ``{"z", "d"}`` for a tell without inversion.
    Returns (x [lambda, d], aux)."""
    z = torch.randn((params.popsize, params.dim), generator=generator,
                    device=state.mean.device, dtype=state.mean.dtype)
    d_vecs = _transform(params, state, z)
    x = state.mean[None, :] + state.sigma * d_vecs
    return x, {"z": z, "d": d_vecs}


def ask(params: LMMAESParams, state: LMMAESState, generator) -> torch.Tensor:
    return ask_with_aux(params, state, generator)[0]


def tell(params: LMMAESParams, state: LMMAESState, x: torch.Tensor,
         fitness: torch.Tensor, aux=None) -> LMMAESState:
    """Rank by fitness (lower is better) and update mean, paths and sigma:
    the paths accumulate the weighted top-mu raw normals z, the mean moves
    along the transformed directions d."""
    dt = state.mean.dtype
    if aux is None:
        d_vecs = (x.to(dt) - state.mean[None, :]) / state.sigma
        z = _inverse_transform(params, state, d_vecs)
    else:
        z, d_vecs = aux["z"], aux["d"]

    mu = params.weights.shape[0]
    order = torch.argsort(fitness, stable=True)[:mu]
    w = params.weights.to(dt)
    zw = w @ z.index_select(0, order)                         # [d]
    dw = w @ d_vecs.index_select(0, order)                    # [d]

    mean = state.mean + state.sigma * dw
    cs, mueff = params.c_sigma, params.mueff
    p_sigma = (1.0 - cs) * state.p_sigma + math.sqrt(cs * (2.0 - cs) * mueff) * zw
    cc = params.c_c.to(dt)[:, None]                           # [m, 1]
    paths = ((1.0 - cc) * state.paths
             + torch.sqrt(cc * (2.0 - cc) * mueff) * zw[None, :])
    sigma = state.sigma * torch.exp(
        (cs / params.d_sigma)
        * (torch.linalg.norm(p_sigma) / params.chi_d - 1.0))
    sigma = torch.clamp(sigma, 1e-12, 1e12)
    return LMMAESState(mean=mean, sigma=sigma, p_sigma=p_sigma, paths=paths,
                       gen=state.gen + 1)
