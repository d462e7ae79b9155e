"""Adam and the CMA-ES update, written out from their papers.

Adam (Kingma and Ba, arXiv:1412.6980) with bias correction, as PyTorch
states it: ``p -= lr / (1 - b1^t) * m / (sqrt(v) / sqrt(1 - b2^t) + eps)``.

CMA-ES: the (mu/mu_w, lambda) strategy of Hansen's tutorial
(arXiv:1604.00772) with cumulative step-size adaptation and rank-1 plus
rank-mu covariance updates, in the dtype and on the device of its state
(the reference: float64 on the host): weights ``ln((lambda+1)/2) -
ln(i)`` over the best half, ``h_sigma`` against ``1.4 + 2 / (n + 1)``.
"""

from __future__ import annotations

import math

import numpy as np
import torch


class Adam:
    """Adam over a dict of tensors, one learning rate per name."""

    def __init__(self, lrs: dict, betas=(0.9, 0.999), eps=1e-8):
        self.lrs = dict(lrs)
        self.b1, self.b2 = betas
        self.eps = eps
        self.t = 0
        self.m, self.v = {}, {}

    def step(self, params: dict, grads: dict) -> dict:
        """The parameters after one step (new tensors)."""
        self.t += 1
        bc1 = 1.0 - self.b1 ** self.t
        bc2 = 1.0 - self.b2 ** self.t
        out = {}
        for name, p in params.items():
            g = grads[name]
            m = self.m.get(name, torch.zeros_like(g)) * self.b1 \
                + (1.0 - self.b1) * g
            v = self.v.get(name, torch.zeros_like(g)) * self.b2 \
                + (1.0 - self.b2) * g * g
            self.m[name], self.v[name] = m, v
            denom = v.sqrt() / math.sqrt(bc2) + self.eps
            out[name] = p - (self.lrs[name] / bc1) * m / denom
        return out


def cma_params(n: int, popsize: int) -> dict:
    """The strategy's constants for dimension ``n`` and population
    ``popsize``."""
    mu = popsize // 2
    raw = math.log((popsize + 1) / 2.0) - np.log(np.arange(1, mu + 1))
    w = raw / raw.sum()
    mueff = 1.0 / float(np.sum(w ** 2))
    nf = float(n)
    cs = (mueff + 2.0) / (nf + mueff + 5.0)
    c1 = 2.0 / ((nf + 1.3) ** 2 + mueff)
    return {
        "n": n, "popsize": popsize, "mu": mu, "weights": w, "mueff": mueff,
        "cc": (4.0 + mueff / nf) / (nf + 4.0 + 2.0 * mueff / nf),
        "cs": cs, "c1": c1,
        "cmu": min(1.0 - c1, 2.0 * (mueff - 2.0 + 1.0 / mueff)
                   / ((nf + 2.0) ** 2 + mueff)),
        "damps": 1.0 + 2.0 * max(0.0, math.sqrt((mueff - 1.0) / (nf + 1.0))
                                 - 1.0) + cs,
        "chi_n": math.sqrt(nf) * (1.0 - 1.0 / (4.0 * nf)
                                  + 1.0 / (21.0 * nf ** 2)),
    }


def cma_init(n: int, mean=0.0, sigma=1.0, dtype=torch.float64,
             device="cpu") -> dict:
    kw = {"dtype": dtype, "device": device}
    return {"mean": torch.full((n,), float(mean), **kw),
            "sigma": torch.tensor(float(sigma), **kw),
            "C": torch.eye(n, **kw), "p_sigma": torch.zeros(n, **kw),
            "p_c": torch.zeros(n, **kw), "gen": 0}


def cma_tell(cp: dict, state: dict, x, fitness) -> dict:
    """The state after ranking candidates ``x [popsize, n]`` by
    ``fitness`` (lower is better), in the state's dtype and device."""
    mean, sigma, C = state["mean"], state["sigma"], state["C"]
    x = torch.as_tensor(x).to(mean)
    order = torch.argsort(torch.as_tensor(fitness, dtype=torch.float64),
                          stable=True)[:cp["mu"]].to(mean.device)
    weights = torch.as_tensor(cp["weights"]).to(mean)
    y = (x[order] - mean) / sigma
    y_w = weights @ y
    new_mean = mean + sigma * y_w
    eigvals, B = torch.linalg.eigh(C)
    inv_sqrt = (B * (1.0 / torch.sqrt(eigvals.clamp_min(1e-20)))) @ B.T
    cs, cc, c1, cmu = cp["cs"], cp["cc"], cp["c1"], cp["cmu"]
    mueff, chi_n, n = cp["mueff"], cp["chi_n"], cp["n"]
    p_sigma = (1.0 - cs) * state["p_sigma"] \
        + math.sqrt(cs * (2.0 - cs) * mueff) * (inv_sqrt @ y_w)
    gen1 = state["gen"] + 1
    ps_norm = float(torch.linalg.vector_norm(p_sigma))
    h_sigma = float(ps_norm / math.sqrt(1.0 - (1.0 - cs) ** (2 * gen1))
                    / chi_n < 1.4 + 2.0 / (n + 1.0))
    p_c = (1.0 - cc) * state["p_c"] \
        + h_sigma * math.sqrt(cc * (2.0 - cc) * mueff) * y_w
    rank_mu = (y * weights[:, None]).T @ y
    delta_h = (1.0 - h_sigma) * cc * (2.0 - cc)
    C = (1.0 - c1 - cmu) * C + c1 * (torch.outer(p_c, p_c) + delta_h * C) \
        + cmu * rank_mu
    C = 0.5 * (C + C.T)
    sigma = sigma * math.exp((cs / cp["damps"]) * (ps_norm / chi_n - 1.0))
    return {"mean": new_mean, "sigma": sigma, "C": C, "p_sigma": p_sigma,
            "p_c": p_c, "gen": gen1}
