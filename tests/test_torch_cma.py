"""The port's CMA-ES against the JAX package's and against the independent
float64 numpy transcription of tests/test_cma_parity.py.

Both sides are fed the same candidates and fitness. Eigenvector signs from
``torch.linalg.eigh`` and ``jnp.linalg.eigh`` may differ, so ``B`` is never
compared; ``C``, ``mean``, ``sigma``, ``p_sigma`` and ``p_c`` are.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pix2latent_tpu.strategies import cma as jax_cma
from pix2latent_tpu_torch.strategies import cma
from test_cma_parity import NumpyCMA

FIELDS = ("mean", "sigma", "C", "p_sigma", "p_c")


def _fitness(rng, dim):
    a = rng.randn(dim, dim) / math.sqrt(dim)
    h = a.T @ a + 0.1 * np.eye(dim)
    x_star = rng.randn(dim)
    return lambda x: np.einsum("ij,jk,ik->i", x - x_star, h, x - x_star)


@pytest.mark.parametrize("active", [False, True], ids=["plain", "active"])
def test_tell_matches_jax(active):
    dim, gens = 128, 6
    rng = np.random.RandomState(0)
    fitness = _fitness(rng, dim)
    jp, js = jax_cma.init(np.zeros(dim, np.float32), 1.0, active=active)
    tp, ts = cma.init(np.zeros(dim, np.float32), 1.0, active=active,
                      device="cpu")
    assert tp.popsize == jp.popsize == 18
    np.testing.assert_array_equal(tp.weights.numpy(), np.asarray(jp.weights))
    for gen in range(gens):
        # candidates from the JAX state's distribution, fed to both
        mean, sigma = np.asarray(js.mean), float(js.sigma)
        b, d = np.asarray(js.B), np.asarray(js.D)
        z = rng.randn(jp.popsize, dim).astype(np.float32)
        x = (mean + sigma * (z * d) @ b.T).astype(np.float32)
        f = fitness(x).astype(np.float32)
        js = jax_cma.tell(jp, js, jnp.asarray(x), jnp.asarray(f))
        ts = cma.tell(tp, ts, torch.tensor(x), torch.tensor(f))
        for name in FIELDS:
            np.testing.assert_allclose(
                getattr(ts, name).numpy(), np.asarray(getattr(js, name)),
                rtol=2e-4, atol=2e-6, err_msg=f"{name} at generation {gen}")
        assert int(ts.gen) == gen + 1


@pytest.mark.parametrize("active", [False, True], ids=["plain", "active"])
def test_f64_trajectory_matches_numpy_reference(active):
    dim = 16
    rng = np.random.RandomState(dim)
    popsize = cma.default_popsize(dim)
    fitness = _fitness(rng, dim)
    params, state = cma.init(np.zeros(dim), 1.0, popsize, active=active,
                             device="cpu", dtype=torch.float64)
    ref = NumpyCMA(np.zeros(dim), 1.0, popsize, active=active)
    w64 = np.zeros(popsize)
    w64[:ref.mu] = ref.w
    if active:
        w64[ref.mu:] = ref.w_neg
    params = params._replace(weights=torch.tensor(w64))
    for gen in range(30):
        evals, b = np.linalg.eigh(ref.C)
        d = np.sqrt(np.maximum(evals, 1e-20))
        x = ref.mean[None] + ref.sigma * (rng.randn(popsize, dim) * d) @ b.T
        f = fitness(x)
        state = cma.tell(params, state, torch.tensor(x), torch.tensor(f))
        ref.tell(x, f)
        assert state.mean.dtype == torch.float64
        np.testing.assert_allclose(state.mean.numpy(), ref.mean, rtol=1e-9,
                                   atol=1e-12, err_msg=f"mean, gen {gen}")
        np.testing.assert_allclose(float(state.sigma), ref.sigma, rtol=1e-9)
        np.testing.assert_allclose(state.C.numpy(), ref.C, rtol=1e-8,
                                   atol=1e-12, err_msg=f"C, gen {gen}")


def test_ask_samples_the_search_distribution():
    params, state = cma.init(np.full(4, 0.5), 0.3, popsize=4000,
                             device="cpu")
    gen = torch.Generator().manual_seed(0)
    x, y = cma.ask_with_y(params, state, gen)
    assert x.shape == (4000, 4)
    torch.testing.assert_close(x, state.mean + state.sigma * y)
    np.testing.assert_allclose(x.mean(0).numpy(), 0.5, atol=0.02)
    np.testing.assert_allclose(x.std(0).numpy(), 0.3, atol=0.02)


def test_ties_rank_stably_and_nonfinite_fitness_loses():
    params, state = cma.init(np.zeros(3), 1.0, popsize=6, device="cpu")
    jp, js = jax_cma.init(np.zeros(3, np.float32), 1.0, popsize=6)
    x = np.random.RandomState(1).randn(6, 3).astype(np.float32)
    f = np.array([1.0, 1.0, np.nan, 0.5, 1.0, np.inf], np.float32)
    ts = cma.tell(params, state, torch.tensor(x), torch.tensor(f))
    js = jax_cma.tell(jp, js, jnp.asarray(x), jnp.asarray(f))
    for name in FIELDS:
        np.testing.assert_allclose(getattr(ts, name).numpy(),
                                   np.asarray(getattr(js, name)),
                                   rtol=1e-5, atol=1e-6, err_msg=name)
    clean = cma.sanitize_fitness(torch.tensor(f))
    assert torch.isfinite(clean).all() and clean[2] == clean[5] > 1.0


def test_lazy_eigen_keeps_basis_until_refreshed():
    params, state = cma.init(np.zeros(5), 1.0, device="cpu")
    x = torch.tensor(np.random.RandomState(2).randn(params.popsize, 5),
                     dtype=torch.float32)
    f = (x ** 2).sum(1)
    lazy = cma.tell(params, state, x, f, refresh_eigen=False)
    assert torch.equal(lazy.B, state.B) and torch.equal(lazy.D, state.D)
    fresh = cma.refresh_eigen(lazy)
    torch.testing.assert_close(fresh.B @ torch.diag(fresh.D ** 2) @ fresh.B.T,
                               lazy.C, rtol=1e-5, atol=1e-6)
