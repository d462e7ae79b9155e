"""The port's strategy registry, LM-MA-ES and host escape hatch against the
JAX package's (``pix2latent_tpu/strategies/{registry,lmmaes,host}.py``).

- ``tell``: for every registry name, the same state, candidates, loss and
  aux (made with numpy from a seed) through the JAX strategy's tell and the
  port's, within rtol 1e-5, atol 1e-6 in float32; CMA and aCMA within the
  tolerances of ``tests/test_torch_cma.py`` (rtol 2e-4, atol 2e-6; ``B``
  is not compared, its signs may differ).
- LM-MA-ES over 20 generations with injected normals, against JAX within
  rtol 1e-4 in float32, and its transform and inverse.
- The ask semantics of ``tests/test_strategies.py`` on the port: Latin
  hypercube strata, the circular two-point segment, TBPSA's top-quarter
  geometric sigma, every ``NGOptSelector`` branch with and without a
  budget, ``cache_token``, no NaN at population 1, and each strategy
  reducing a sphere.
- The ``Host:`` cases of ``tests/test_host_strategy.py``: a stub backend
  through both drivers, the error without nevergrad, a rejected
  ``checkpoint_path`` and no memo for host strategies.
- The ``CMA`` wrapper class against the JAX package's on the same asks.
"""

import importlib
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pix2latent_tpu.strategies.cma as jax_cma_mod
import pix2latent_tpu.strategies.lmmaes as jax_lm
import pix2latent_tpu_torch.loss_functions as LF
import pix2latent_tpu_torch.strategies.lmmaes as lm
from pix2latent_tpu_torch import VariableManager
from pix2latent_tpu_torch.models.toy import make_toy_model
from pix2latent_tpu_torch.optimizers import (HybridNevergradOptimizer,
                                             NevergradOptimizer)
from pix2latent_tpu_torch.strategies import CMA, registry
from pix2latent_tpu_torch.strategies.host import (_HOST_BACKENDS,
                                                  HostStrategy,
                                                  register_host_backend)
from pix2latent_tpu_torch.strategies.registry import (
    ActiveCMAStrategy, MetaRecenteringStrategy, NGOptSelector,
    RandomSearchStrategy, is_valid_method, resolve)

# the package's ``registry`` attribute is the dict, which hides the module
jax_reg = importlib.import_module("pix2latent_tpu.strategies.registry")

DIM, POP = 8, 12
CMA_FIELDS = ("mean", "sigma", "C", "p_sigma", "p_c")


def _gen(seed=0):
    return torch.Generator().manual_seed(seed)


def _make(name, dim=DIM, pop=POP, **kw):
    return registry[name](dim, pop, device="cpu", **kw)


# --------------------------------------------------------------------- #
# tell against the JAX package                                            #
# --------------------------------------------------------------------- #

def _state_values(template, rng, dim):
    """Random values for each field of a state (by the field's name), so
    that a tell starts from a state no strategy's init gives."""
    vals = {}
    if "C" in template._fields:
        a = rng.randn(dim, dim) / math.sqrt(dim)
        c = a @ a.T + 0.5 * np.eye(dim)
        eig, b = np.linalg.eigh(c)
        vals.update(C=c, B=b, D=np.sqrt(eig))
    for f, v in zip(template._fields, template):
        shape = np.shape(v)
        if f in vals:
            continue
        if f == "gen":
            vals[f] = np.int32(3)
        elif f == "sigma":
            vals[f] = rng.uniform(0.5, 1.5)
        elif f == "diag_c":
            vals[f] = rng.uniform(0.5, 2.0, shape)
        elif f in ("best_f", "gbest_f", "fit", "pbest_f"):
            vals[f] = rng.uniform(0.0, 5.0, shape)
        else:
            vals[f] = 0.5 * rng.randn(*shape)
    return [np.asarray(vals[f], np.int32 if f == "gen" else np.float32)
            for f in template._fields]


def _aux(name, rng, pop, dim):
    if name == "TBPSA":
        return rng.uniform(0.5, 2.0, (pop, 1)).astype(np.float32)
    if name in ("LMMAES", "LMCMA"):
        return {k: rng.randn(pop, dim).astype(np.float32) for k in "zd"}
    return None


def _to(tree, conv):
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: conv(v) for k, v in tree.items()}
    return conv(tree)


@pytest.mark.parametrize("with_aux", [True, False], ids=["aux", "no_aux"])
@pytest.mark.parametrize("name", sorted(jax_reg.registry))
def test_tell_matches_jax(name, with_aux):
    assert sorted(registry) == sorted(jax_reg.registry)
    rng = np.random.RandomState(sorted(registry).index(name))
    mu = rng.randn(DIM).astype(np.float32)
    js = jax_reg.registry[name](DIM, POP, mu, 0.7)
    ts = registry[name](DIM, POP, mu, 0.7, device="cpu")
    assert type(ts).__name__ == type(js).__name__
    jstate0 = js.init(jax.random.PRNGKey(0))
    tstate0 = ts.init(_gen())
    assert tstate0._fields == jstate0._fields
    vals = _state_values(jstate0, rng, DIM)
    jstate = type(jstate0)(*map(jnp.asarray, vals))
    tstate = type(tstate0)(*map(torch.tensor, vals))
    rows = max(POP, 2) if name in ("CMA", "ActiveCMA", "NGOpt", "LMMAES",
                                   "LMCMA") else POP
    x = rng.randn(rows, DIM).astype(np.float32)
    loss = rng.uniform(0.0, 5.0, rows).astype(np.float32)
    aux = _aux(name, rng, rows, DIM) if with_aux else None

    want = js.tell(jstate, jnp.asarray(x), jnp.asarray(loss),
                   aux=_to(aux, jnp.asarray))
    got = ts.tell(tstate, torch.tensor(x), torch.tensor(loss),
                  aux=_to(aux, torch.tensor))
    is_cma = isinstance(ts, ActiveCMAStrategy) or name == "CMA"
    fields = CMA_FIELDS if is_cma else got._fields
    tol = dict(rtol=2e-4, atol=2e-6) if is_cma else dict(rtol=1e-5, atol=1e-6)
    for f in fields:
        np.testing.assert_allclose(getattr(got, f).numpy(),
                                   np.asarray(getattr(want, f)), **tol,
                                   err_msg=f)
        assert getattr(got, f).dtype == torch.float32 or f == "gen"
    np.testing.assert_allclose(ts.mean(got).numpy(),
                               np.asarray(js.mean(want)), **tol)


def test_lmmaes_trajectory_matches_jax():
    dim, pop, gens = 16, 10, 20
    rng = np.random.RandomState(5)
    mean0 = rng.randn(dim).astype(np.float32)
    jp, js = jax_lm.init(mean0, 0.8, popsize=pop)
    tp, ts = lm.init(mean0, 0.8, popsize=pop, device="cpu")
    assert (tp.memory, tp.popsize) == (jp.memory, jp.popsize) == (12, 10)
    np.testing.assert_array_equal(tp.c_d.numpy(), np.asarray(jp.c_d))
    a = rng.randn(dim, dim) / math.sqrt(dim)
    h = a.T @ a + 0.1 * np.eye(dim)

    def f(x):
        return np.einsum("ij,jk,ik->i", x, h, x).astype(np.float32)

    for gen in range(gens):
        z = rng.randn(pop, dim).astype(np.float32)
        jd = jax_lm._transform(jp, js, jnp.asarray(z))
        td = lm._transform(tp, ts, torch.tensor(z))
        np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=1e-4,
                                   atol=1e-5, err_msg=f"d at {gen}")
        # the inverse recovers z
        np.testing.assert_allclose(lm._inverse_transform(tp, ts, td).numpy(),
                                   z, rtol=1e-4, atol=1e-4)
        x = np.asarray(js.mean)[None] + float(js.sigma) * np.asarray(jd)
        fit = f(x)
        js = jax_lm.tell(jp, js, jnp.asarray(x), jnp.asarray(fit),
                         aux={"z": jnp.asarray(z), "d": jd})
        ts = lm.tell(tp, ts, torch.tensor(x), torch.tensor(fit),
                     aux={"z": torch.tensor(z), "d": td})
        for name in ("mean", "sigma", "p_sigma", "paths"):
            np.testing.assert_allclose(
                getattr(ts, name).numpy(), np.asarray(getattr(js, name)),
                rtol=1e-4, atol=1e-6, err_msg=f"{name} at generation {gen}")
        assert int(ts.gen) == gen + 1


def test_lmmaes_ask_reads_the_generator_only():
    p, s = lm.init(np.zeros(6, np.float32), 1.0, popsize=5, device="cpu")
    x1, aux = lm.ask_with_aux(p, s, _gen(3))
    x2 = lm.ask(p, s, _gen(3))
    assert torch.equal(x1, x2) and x1.shape == (5, 6)
    # generation 0: every factor is inert, so d is z
    assert torch.equal(aux["d"], aux["z"])
    with pytest.raises(ValueError):
        lm.init(np.zeros(6), 0.0)


# --------------------------------------------------------------------- #
# ask semantics (tests/test_strategies.py on the port)                   #
# --------------------------------------------------------------------- #

def run_strategy(name, dim=8, pop=12, gens=60, seed=0):
    """Minimize the shifted sphere; returns (best f of the first
    generation, best f of all generations, f of the final mean)."""
    x_star = torch.linspace(-1, 1, dim)

    def f(x):
        return ((x - x_star[None]) ** 2).sum(-1)

    strat = _make(name, dim, pop)
    g = _gen(seed)
    state = strat.init(g)
    bests = []
    for _ in range(gens):
        x, aux = strat.ask_with_aux(state, g)
        loss = f(x)
        bests.append(float(loss.min()))
        state = strat.tell(state, x, loss, aux=aux)
    return bests[0], min(bests), float(f(strat.mean(state)[None])[0])


@pytest.mark.parametrize("name", sorted(registry))
def test_strategy_minimizes_sphere(name):
    # hill climbers need more generations than recombining strategies; so
    # do the keep-best samplers, whose generations are exchangeable: the
    # first holds the best point with chance 1/gens (on this stream it
    # holds it through generation 60, a 0.13 % quantile of the first ask)
    keep_best = name in ("RandomSearch", "MetaRecentering")
    gens = 150 if keep_best or name == "OnePlusOne" else 60
    first, best, final = run_strategy(name, gens=gens)
    if keep_best:
        # they recommend the best point they have seen
        assert final == best, (name, best, final)
    bound = 1.5 if keep_best else 0.15
    assert final < min(first, bound), (name, first, final)


def test_tbpsa_beats_random_search():
    assert run_strategy("TBPSA", gens=80)[2] < \
        run_strategy("RandomSearch", gens=80)[2]


def test_tbpsa_aux_carries_per_candidate_sigmas():
    strat = _make("TBPSA", 4, 10)
    x, aux = strat.ask_with_aux(strat.init(_gen()), _gen())
    assert x.shape == (10, 4) and aux.shape == (10, 1)
    assert bool((aux > 0).all()) and float(aux.max() - aux.min()) > 0


def test_tbpsa_tell_recombines_top_quarter_sigma_geometrically():
    strat = _make("TBPSA", 2, 8)
    state = strat.init(_gen())
    x = torch.arange(16, dtype=torch.float32).reshape(8, 2)
    aux = torch.tensor([[1.], [2.], [4.], [8.], [1.], [1.], [1.], [1.]])
    loss = torch.arange(8, dtype=torch.float32)
    new = strat.tell(state, x, loss, aux=aux)
    # top quarter of 8 = 2 candidates: sigmas 1 and 2 -> geomean sqrt(2)
    np.testing.assert_allclose(float(new.sigma), np.sqrt(2.0), rtol=1e-6)
    np.testing.assert_allclose(new.mean.numpy(), x[:2].mean(0).numpy())


def test_two_points_crossover_is_a_circular_segment():
    strat = _make("TwoPointsDE", 16, 6)
    child = strat._crossover(_gen(1), torch.ones(6, 16), torch.zeros(6, 16))
    for row in child.numpy():
        k = int(row.sum())
        assert 1 <= k <= 16
        doubled = np.concatenate([row, row])
        runs, cur = [], 0
        for v in doubled:
            cur = cur + 1 if v else 0
            runs.append(cur)
        assert max(runs) == (32 if k == 16 else k), row


def test_two_points_de_differs_from_binomial_de():
    de, two = _make("DE", 16, 6), _make("TwoPointsDE", 16, 6)
    x1 = de.ask(de.init(_gen()), _gen())
    x2 = two.ask(two.init(_gen()), _gen())
    assert not torch.allclose(x1, x2)


def test_meta_recentering_is_a_latin_hypercube():
    """Each dimension's n samples land in n distinct strata."""
    from scipy.stats import norm
    n, d = 16, 5
    strat = MetaRecenteringStrategy(d, n, sigma=1.0, budget=n, device="cpu")
    x = strat.ask(strat.init(_gen()), _gen(2))
    assert x.shape == (n, d)
    strata = np.floor(norm.cdf(x.numpy() / strat.scale) * n).astype(int)
    for j in range(d):
        assert sorted(strata[:, j]) == list(range(n)), j


def test_meta_recentering_scale_rules():
    s = MetaRecenteringStrategy(128, 18, budget=540, device="cpu")
    assert s.scale == jax_reg.MetaRecenteringStrategy(128, 18,
                                                      budget=540).scale
    np.testing.assert_allclose(s.scale, np.sqrt(np.log(540.0) / 128.0),
                               rtol=1e-12)
    s = MetaRecenteringStrategy(128, 18, budget=540, autotune=False,
                                device="cpu")
    np.testing.assert_allclose(
        s.scale, (1.0 + np.log(540.0)) / (4.0 * np.log(128.0)), rtol=1e-12)


def test_meta_recentering_beats_fixed_sigma_at_small_budget():
    d, n, gens = 64, 16, 4
    x_star = torch.full((d,), 0.15)

    def run(strat):
        g = _gen(0)
        state = strat.init(g)
        for _ in range(gens):
            x = strat.ask(state, g)
            state = strat.tell(state, x, ((x - x_star) ** 2).sum(-1))
        return float(((strat.mean(state) - x_star) ** 2).sum())

    assert run(MetaRecenteringStrategy(d, n, budget=n * gens, device="cpu")) \
        < run(RandomSearchStrategy(d, n, device="cpu"))


def test_diagonal_variances_adapt_to_scaling():
    scale = torch.tensor([30.0, 1.0, 1.0, 1.0, 1.0, 1.0])
    strat = _make("DiagonalCMA", 6, 16)
    g = _gen(0)
    state = strat.init(g)
    for _ in range(80):
        x = strat.ask(state, g)
        state = strat.tell(state, x, ((x * scale) ** 2).sum(-1))
    diag = state.diag_c.numpy()
    assert diag[0] * 20 < diag[1:].mean()
    assert float(((strat.mean(state) * scale) ** 2).sum()) < 1e-3


def test_diagonal_cma_high_dimensional_sphere():
    dim, pop = 512, 22
    x_star = torch.tensor(np.random.RandomState(0).randn(dim) * 0.3,
                          dtype=torch.float32)
    strat = _make("DiagonalCMA", dim, pop)
    g = _gen(0)
    state, first = strat.init(g), None
    for _ in range(400):
        x = strat.ask(state, g)
        loss = ((x - x_star) ** 2).sum(-1)
        first = first if first is not None else float(loss.min())
        state = strat.tell(state, x, loss)
    assert float(((strat.mean(state) - x_star) ** 2).sum()) < 0.1 * first


def _leaf(strategy):
    return type(strategy).__name__


@pytest.mark.parametrize("args,kw,leaf", [
    ((8, 12), {}, "ActiveCMAStrategy"),
    ((512, 22), {}, "DiagonalCMAStrategy"),
    ((128, 18), dict(budget=20), "MetaRecenteringStrategy"),
    ((512, 22), dict(budget=100), "MetaRecenteringStrategy"),
    ((16, 10), dict(budget=40), "TBPSAStrategy"),
    ((128, 1), dict(budget=1000), "OnePlusOneStrategy"),
    ((300, 1), dict(budget=7000), "ActiveCMAStrategy"),
    ((4096, 8), dict(budget=200000), "DEStrategy"),
    ((128, 18), dict(budget=20000), "ActiveCMAStrategy"),
    ((128, 18), dict(budget=20000, noisy=True), "TBPSAStrategy"),
    ((128, 18), dict(noisy=True), "TBPSAStrategy"),
])
def test_ngopt_branches_match_jax(args, kw, leaf):
    got = NGOptSelector(*args, device="cpu", **kw)
    assert _leaf(got) == _leaf(jax_reg.NGOptSelector(*args, **kw)) == leaf


@pytest.mark.parametrize("name", ["DiagonalCMA", "MetaRecentering", "TBPSA",
                                  "OnePlusOne", "DE", "TwoPointsDE", "PSO",
                                  "RandomSearch"])
def test_population_one_gives_no_nan(name):
    strat = _make(name, 4, 1)
    g = _gen(0)
    state = strat.init(g)
    for _ in range(5):
        x, aux = strat.ask_with_aux(state, g)
        assert x.shape == (1, 4)
        state = strat.tell(state, x, (x ** 2).sum(-1), aux=aux)
    for t in state:
        if t.is_floating_point():
            assert torch.isfinite(t).all() or name in (
                "DE", "TwoPointsDE", "PSO")   # their unvisited fits stay inf
    assert torch.isfinite(strat.mean(state)).all()


def test_cache_token_equal_config_equal_token():
    a = _make("ActiveCMA", 16, 8, mu=None, sigma=0.7)
    b = _make("ActiveCMA", 16, 8, mu=None, sigma=0.7)
    assert a.cache_token() == b.cache_token()
    assert len({a.cache_token(): 1, b.cache_token(): 2}) == 1


def test_cache_token_distinguishes_mu_sigma_budget_and_leaf():
    mu = np.linspace(-1, 1, 8).astype(np.float32)
    toks = {_make("TBPSA", 8, 6).cache_token(),
            _make("TBPSA", 8, 6, sigma=0.5).cache_token(),
            _make("TBPSA", 8, 6, mu=mu).cache_token()}
    assert len(toks) == 3
    a = _make("MetaRecentering", 32, 10, budget=100)
    b = _make("MetaRecentering", 32, 10, budget=10000)
    assert a.scale != b.scale and a.cache_token() != b.cache_token()
    assert NGOptSelector(128, 18, budget=20000, device="cpu").cache_token() \
        != NGOptSelector(128, 18, budget=20000, noisy=True,
                         device="cpu").cache_token()
    assert _make("LMMAES", 16, 8).cache_token() != \
        _make("LMMAES", 16, 8, memory=3).cache_token()


def test_sigma_must_be_positive():
    with pytest.raises(ValueError, match="positive"):
        _make("TBPSA", 4, 4, sigma=0.0)


def test_strategies_default_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for name in ("TBPSA", "CMA", "LMMAES"):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            registry[name](4, 4)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        CMA()


# --------------------------------------------------------------------- #
# the CMA wrapper class                                                   #
# --------------------------------------------------------------------- #

def test_cma_wrapper_matches_jax_on_the_same_asks():
    jw = jax_cma_mod.CMA(mu=np.zeros(16, np.float32), sigma=0.5, seed=3)
    tw = CMA(mu=np.zeros(16, np.float32), sigma=0.5, seed=3, device="cpu")
    assert tw.batch_size() == jw.batch_size() == 12
    x = tw.ask()
    assert x.shape == (12, 16) and x.device.type == "cpu"
    with pytest.raises(ValueError, match="popsize"):
        tw.ask(batch_size=5)
    rng = np.random.RandomState(0)
    for _ in range(3):
        x = rng.randn(12, 16).astype(np.float32)
        y = (x ** 2).sum(1)
        jw.tell(x, y)
        tw.tell(x, y)                  # numpy in, as the reference's
    for name in CMA_FIELDS:
        np.testing.assert_allclose(getattr(tw.state, name).numpy(),
                                   np.asarray(getattr(jw.state, name)),
                                   rtol=2e-4, atol=2e-6, err_msg=name)
    assert torch.equal(tw.mean(), tw.state.mean)
    # the seed fixes the draws
    a = CMA(mu=np.zeros(16), seed=7, device="cpu").ask()
    b = CMA(mu=np.zeros(16), seed=7, device="cpu").ask()
    assert torch.equal(a, b)


# --------------------------------------------------------------------- #
# the Host: escape hatch (tests/test_host_strategy.py on the port)        #
# --------------------------------------------------------------------- #

Z_DIM, RES = 8, 16


class StubHostES:
    """A host-side (mu/2, lambda)-ES with Python state, in place of a
    nevergrad optimizer; counts its calls."""

    def __init__(self, dim, num_samples, mu=None, sigma=1.0):
        self.dim, self.n = dim, num_samples
        self.mean = (np.zeros(dim, np.float32) if mu is None
                     else np.asarray(mu, np.float32).copy())
        self.sigma = float(sigma)
        self.rng = np.random.RandomState(0)
        self.asks = self.tells = 0

    def ask(self):
        self.asks += 1
        return (self.mean[None] + self.sigma
                * self.rng.randn(self.n, self.dim)).astype(np.float32)

    def tell(self, x, loss):
        self.tells += 1
        best = np.argsort(np.asarray(loss))[:max(self.n // 2, 1)]
        self.mean = np.asarray(x)[best].mean(axis=0)
        self.sigma *= 0.95


@pytest.fixture(autouse=True)
def _stub_backend():
    register_host_backend("StubES", StubHostES)
    yield
    _HOST_BACKENDS.pop("StubES", None)


@pytest.fixture(scope="module")
def problem():
    model = make_toy_model(z_dim=Z_DIM, res=RES, width=16, seed=0,
                           device="cpu")
    with torch.no_grad():
        target = model(z=torch.tensor(np.random.RandomState(7).randn(
            1, Z_DIM).astype(np.float32)))[0]
    return model, target


def make_vm(target, names=("z",), gf="z"):
    vm = VariableManager(seed=0, device="cpu")
    for name in names:
        vm.register(name, shape=(Z_DIM,), var_type="input",
                    grad_free=(name == gf), learning_rate=0.05)
    vm.register("target", shape=(RES, RES, 3), var_type="output",
                requires_grad=False, default=target)
    vm.register("weight", shape=(RES, RES, 3), var_type="output",
                requires_grad=False, default=np.ones((RES, RES, 3),
                                                     np.float32))
    return vm


def loss_fn(out, target, weight):
    return LF.masked_l1_loss(out, target, weight)


def test_host_names_resolve():
    assert resolve("CMA").__name__ == "CMAStrategy"
    assert is_valid_method("Host:StubES") and not is_valid_method("Nope")
    assert isinstance(resolve("Host:StubES")(Z_DIM, 6, device="cpu"),
                      HostStrategy)
    with pytest.raises(KeyError, match="Host:<backend>"):
        resolve("NoSuchMethod")


def test_missing_backend_without_nevergrad_raises_helpfully():
    build = resolve("Host:NotRegistered")
    with pytest.raises(RuntimeError, match="register_host_backend"):
        build(Z_DIM, 6, device="cpu")


def test_host_ask_tell_and_seed():
    mu = np.linspace(-0.5, 0.5, Z_DIM).astype(np.float32)
    strat = resolve("Host:StubES")(Z_DIM, 6, mu=mu, sigma=0.25,
                                   device="cpu")
    np.testing.assert_allclose(strat._host.mean, mu)
    assert strat._host.sigma == 0.25
    state = strat.init(_gen())
    x, aux = strat.ask_with_aux(state, _gen())
    assert x.shape == (6, Z_DIM) and x.dtype == torch.float32 and aux is None
    state = strat.tell(state, x, torch.arange(6.0), aux=aux)
    assert int(state.version) == 1
    assert strat._host.asks == 1 and strat._host.tells == 1
    np.testing.assert_allclose(strat.mean(state).numpy(), strat._host.mean)


def test_host_cache_token_is_per_instance():
    a = resolve("Host:StubES")(Z_DIM, 6, device="cpu")
    b = resolve("Host:StubES")(Z_DIM, 6, device="cpu")
    assert a.cache_token() != b.cache_token()
    assert a.cache_token() == a.cache_token()


def test_host_strategy_in_the_eval_only_driver(problem):
    model, target = problem
    opt = NevergradOptimizer("Host:StubES", model, make_vm(target), loss_fn,
                             track_variables=False, device="cpu")
    opt.optimize(num_samples=8, meta_steps=10, grad_steps=0)
    assert opt.ng_strategy._host.asks == 11       # 10 generations + final
    assert opt.ng_strategy._host.tells == 10
    assert np.isfinite(opt.loss).all()


@pytest.mark.parametrize("fused", [False, True], ids=["host_loop", "fused"])
def test_host_strategy_in_the_hybrid_driver(problem, fused):
    model, target = problem
    opt = HybridNevergradOptimizer("Host:StubES", model, make_vm(target),
                                   loss_fn, track_variables=False,
                                   device="cpu")
    drive = opt.optimize_fused if fused else opt.optimize
    drive(num_samples=6, meta_steps=4, grad_steps=4, last_grad_steps=6)
    host = opt.ng_strategy._host
    assert host.asks == 5 and host.tells == 4
    assert np.isfinite(opt.loss).all() and float(np.min(opt.loss)) < 0.6


@pytest.mark.parametrize("driver", ["ng", "ng_fused", "hybrid",
                                    "hybrid_fused"])
def test_host_checkpoint_path_is_rejected(problem, tmp_path, driver):
    model, target = problem
    ckpt = str(tmp_path / "host.npz")
    cls = NevergradOptimizer if driver.startswith("ng") else \
        HybridNevergradOptimizer
    opt = cls("Host:StubES", model, make_vm(target), loss_fn,
              track_variables=False, device="cpu")
    drive = opt.optimize_fused if driver.endswith("fused") else opt.optimize
    kw = dict(grad_steps=1) if cls is NevergradOptimizer else \
        dict(grad_steps=1, last_grad_steps=1)
    with pytest.raises(ValueError, match="Host:"):
        drive(num_samples=6, meta_steps=3, checkpoint_path=ckpt, **kw)
    assert not os.path.exists(ckpt)


def test_host_strategies_are_not_memoised(problem):
    model, target = problem
    opt = HybridNevergradOptimizer("Host:StubES", model, make_vm(target),
                                   loss_fn, track_variables=False,
                                   device="cpu")
    for _ in range(2):
        opt.optimize_fused(num_samples=4, meta_steps=2, grad_steps=1,
                           last_grad_steps=1)
    assert len(getattr(opt, "_fused_gens", {})) == 0


def test_memo_rebuilds_when_the_grad_free_variable_changes(problem):
    """The same strategy on another grad-free variable must not reuse the
    generation, which writes asks into the variable it was built for."""
    _, target = problem
    proj = torch.tensor(np.random.RandomState(0).randn(
        Z_DIM, RES * RES * 3).astype(np.float32))

    def model(z, w):
        return torch.tanh((z + w) @ proj).reshape(-1, RES, RES, 3)

    opt = HybridNevergradOptimizer("TBPSA", model,
                                   make_vm(target, ("z", "w"), "z"), loss_fn,
                                   track_variables=False, device="cpu")
    opt.optimize_fused(num_samples=4, meta_steps=2, grad_steps=2,
                       last_grad_steps=2)
    assert len(opt._fused_gens) == 1
    opt.var_manager = make_vm(target, ("z", "w"), "w")
    opt.core.var_manager = opt.var_manager
    variables, _, _ = opt.optimize_fused(num_samples=4, meta_steps=2,
                                         grad_steps=2, last_grad_steps=2)
    assert len(opt._fused_gens) == 2
    # the ask landed in w, which has no default: it moved off zero
    assert float(variables["input"]["w"].detach().abs().max()) > 0
