"""The port's strategy-registry drivers (``optimizers/{ng_base,
ng_optimizer}.py``) against the JAX package's.

- One ``HybridNevergradOptimizer`` generation through BigGAN-deep-128 at
  channel width 8 under ProjectionLoss with the Clamp hook, the asks
  injected on both sides (JAX's threefry and torch's Philox cannot give the
  same draws; the strategy's ``ask_with_aux`` is replaced, as
  ``tests/test_torch_optimizers.py`` replaces ``cma.ask``), for CMA and
  TBPSA (whose aux, the per-candidate sigmas, is injected too): 4 inner
  steps, the tell loss and the strategy's tell. Per-step per-sample losses,
  the tell fitness and the strategy state after the tell agree at rtol
  2e-3, atol 2e-5.
- ``NevergradOptimizer.optimize`` on the toy model with weights carried from
  JAX, 5 generations and 6 finetune steps with injected asks (DiagonalCMA,
  TBPSA): the strategy state, the final variables and losses agree at rtol
  1e-4.
- On the port alone: the fused and host-loop hybrid drivers give the same
  run; a fused run resumed on its finished checkpoint runs no generation
  and no step; the drivers' ``budget`` reaches NGOpt's routing as in the
  JAX package.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pix2latent_tpu.loss_functions as JLF
import pix2latent_tpu_torch.loss_functions as LF
from pix2latent_tpu import VariableManager as JaxVariableManager
from pix2latent_tpu import hooks as jax_hooks
from pix2latent_tpu.losses.lpips import convert_torch_lpips
from pix2latent_tpu.models.biggan import BigGAN as JaxBigGAN
from pix2latent_tpu.models.biggan import convert_torch_biggan
from pix2latent_tpu.models.toy import make_toy_model as jax_toy
from pix2latent_tpu.optimizers import \
    HybridNevergradOptimizer as JaxHybridNG
from pix2latent_tpu.optimizers import NevergradOptimizer as JaxNG
from pix2latent_tpu.utils.params_io import _flatten
from pix2latent_tpu_torch import VariableManager, hooks
from pix2latent_tpu_torch.models.biggan import BigGAN
from pix2latent_tpu_torch.models.toy import ToyGenerator
from pix2latent_tpu_torch.ops import attention as TA
from pix2latent_tpu_torch.optimizers import (HybridNevergradOptimizer,
                                             NevergradOptimizer)
from pix2latent_tpu_torch.utils.params_io import from_jax_params
from test_biggan_golden import make_state_dict
from test_lpips_golden import make_alex_state_dict

POP, N_STEPS = 6, 4
VERSION, CH, RES = "biggan-deep-128", 8, 128
LR_Z, LR_C, BETA = 0.05, 0.01, 10.0
STATE_FIELDS = {"CMA": ("mean", "sigma", "C", "p_sigma", "p_c"),
                "TBPSA": ("mean", "sigma"),
                "DiagonalCMA": ("mean", "sigma", "diag_c", "p_sigma", "p_c")}


@pytest.fixture(scope="module")
def biggans():
    rng = np.random.RandomState(7)
    gparams = convert_torch_biggan(make_state_dict(rng, VERSION, CH), VERSION)
    lparams = convert_torch_lpips(make_alex_state_dict(rng), net="alex")
    jm = JaxBigGAN(VERSION, params=gparams, channel_width=CH)
    onehot = np.zeros((1, 1000), np.float32)
    onehot[0, 153] = 1.0
    c0 = np.asarray(jm.get_class_embedding(jnp.asarray(onehot)))[0]
    z_star = rng.randn(1, 128).astype(np.float32) * 0.5
    target = np.asarray(jm(z=jnp.asarray(z_star), c=jnp.asarray(c0[None])))[0]
    tm = BigGAN(VERSION, params=_flatten(gparams), channel_width=CH,
                device="cpu")
    return jm, tm, lparams, c0, target


def _register(vm, clamp, c0, target):
    vm.register("z", shape=(128,), var_type="input", grad_free=True,
                learning_rate=LR_Z, hook_fn=clamp)
    vm.register("c", shape=(128,), var_type="input", learning_rate=LR_C,
                default=c0)
    vm.register("target", shape=(RES, RES, 3), var_type="output",
                requires_grad=False, default=target)
    vm.register("weight", shape=(RES, RES, 3), var_type="output",
                requires_grad=False,
                default=np.ones((RES, RES, 3), np.float32))


@pytest.mark.parametrize("method", ["CMA", "TBPSA"])
def test_hybrid_generation_with_injected_asks_matches_jax(biggans, method,
                                                          monkeypatch):
    jm, tm, lparams, c0, target = biggans
    rng = np.random.RandomState(11)
    # the injected ask; some entries beyond the clamp so the hook acts
    x = (rng.randn(POP, 128) * 0.8).astype(np.float32)
    aux = (rng.uniform(0.5, 1.5, (POP, 1)).astype(np.float32)
           if method == "TBPSA" else None)

    # ------------------------- JAX package ------------------------------ #
    jvm = JaxVariableManager(seed=0)
    _register(jvm, jax_hooks.Clamp(2.0), jnp.asarray(c0), jnp.asarray(target))
    jopt = JaxHybridNG(method, jm, jvm, JLF.ProjectionLoss(
        "alex", beta=BETA, lpips_params=lparams), track_variables=False)
    jopt.setup_ng(jvm, POP, budget=30 * POP)
    jaux = None if aux is None else jnp.asarray(aux)
    monkeypatch.setattr(jopt.ng_strategy, "ask_with_aux",
                        lambda state, key: (jnp.asarray(x), jaux))
    core = jopt.core
    variables = jopt.ng_init(jvm)
    opt_state = core.init_opt_state(variables)
    variables, opt_state, _, ys = core.grad_steps(
        variables, opt_state, jax.random.PRNGKey(2), N_STEPS)
    want_inner = np.asarray(ys["loss"])
    want_tell = np.asarray(jopt.ng_update(variables, inverted_loss=True,
                                          step=N_STEPS))

    # ------------------------- the port --------------------------------- #
    vm = VariableManager(seed=0, device="cpu")
    _register(vm, hooks.Clamp(2.0), c0, target)
    opt = HybridNevergradOptimizer(method, tm, vm, LF.ProjectionLoss(
        "alex", beta=BETA, lpips_params=lparams, device="cpu"), device="cpu")
    opt.setup_ng(vm, POP, budget=30 * POP)
    assert type(opt.ng_strategy).__name__ == type(jopt.ng_strategy).__name__
    taux = None if aux is None else torch.tensor(aux)
    monkeypatch.setattr(opt.ng_strategy, "ask_with_aux",
                        lambda state, g: (torch.tensor(x), taux))
    asked = opt.ng_init(vm)
    np.testing.assert_array_equal(asked["input"]["z"].numpy(), x)
    TA.reset_launch_counts()
    tell, inner = opt.refine_and_tell(asked, N_STEPS, 0)

    assert inner.shape == (N_STEPS, POP) and tell.shape == (POP,)
    for step in range(N_STEPS):
        np.testing.assert_allclose(
            inner[step].numpy(), want_inner[step], rtol=2e-3, atol=2e-5,
            err_msg=f"per-sample loss diverged at inner step {step}")
    np.testing.assert_allclose(tell.numpy(), want_tell, rtol=2e-3,
                               atol=2e-5, err_msg="tell fitness")
    assert want_inner[-1].mean() < want_inner[0].mean()    # not vacuous
    for name in STATE_FIELDS[method]:
        np.testing.assert_allclose(
            getattr(opt.ng_state, name).numpy(),
            np.asarray(getattr(jopt.ng_state, name)), rtol=2e-3, atol=2e-5,
            err_msg=name)
    assert TA.launch_counts() == {"fwd": 0, "bwd": 0}     # CPU: plain path


# --------------------------------------------------------------------- #
# the eval-only driver on the toy model                                   #
# --------------------------------------------------------------------- #

Z_DIM, TOY_RES = 8, 16


@pytest.fixture(scope="module")
def toys():
    jm = jax_toy(z_dim=Z_DIM, res=TOY_RES, width=16, seed=0)
    tm = ToyGenerator(z_dim=Z_DIM, res=TOY_RES, width=16)
    tm.load_state_dict(from_jax_params(_flatten(jm.params)), strict=True)
    tm.requires_grad_(False)
    z_true = np.random.RandomState(7).randn(1, Z_DIM).astype(np.float32)
    target = np.asarray(jm(z=jnp.asarray(z_true)))[0]
    return jm, tm, target


def _register_toy(vm, clamp, target):
    vm.register("z", shape=(Z_DIM,), grad_free=True, learning_rate=0.05,
                hook_fn=clamp)
    vm.register("target", shape=(TOY_RES, TOY_RES, 3), var_type="output",
                requires_grad=False, default=target)


def _injected(asks, to_array, aux):
    it = iter(range(len(asks)))

    def ask_with_aux(self, state, _):
        i = next(it)
        return to_array(asks[i]), (None if aux is None
                                   else to_array(aux[i]))
    return ask_with_aux


@pytest.mark.parametrize("method", ["DiagonalCMA", "TBPSA"])
def test_eval_only_trajectory_matches_jax(toys, monkeypatch, method):
    import importlib
    jm, tm, target = toys
    gens, pop, steps = 5, 6, 6
    rng = np.random.RandomState(12)
    asks = rng.randn(gens + 1, pop, Z_DIM).astype(np.float32)
    aux = (rng.uniform(0.5, 1.5, (gens + 1, pop, 1)).astype(np.float32)
           if method == "TBPSA" else None)

    jreg = importlib.import_module("pix2latent_tpu.strategies.registry")
    treg = importlib.import_module("pix2latent_tpu_torch.strategies.registry")
    cls = f"{method}Strategy"
    monkeypatch.setattr(getattr(jreg, cls), "ask_with_aux",
                        _injected(asks, jnp.asarray, aux))
    jvm = JaxVariableManager(seed=0)
    _register_toy(jvm, jax_hooks.Clamp(1.5), jnp.asarray(target))
    jopt = JaxNG(method, jm, jvm, JLF.l1_loss)
    jv, _, jl = jopt.optimize(pop, gens, steps)

    monkeypatch.setattr(getattr(treg, cls), "ask_with_aux",
                        _injected(asks, torch.tensor, aux))
    vm = VariableManager(seed=0, device="cpu")
    _register_toy(vm, hooks.Clamp(1.5), target)
    opt = NevergradOptimizer(method, tm, vm, LF.l1_loss, device="cpu")
    tv, _, tl = opt.optimize(pop, gens, steps)

    assert len(opt.losses) == gens and tl[0][0] == jl[0][0] == gens + steps
    for name in STATE_FIELDS[method]:
        np.testing.assert_allclose(getattr(opt.ng_state, name).numpy(),
                                   np.asarray(getattr(jopt.ng_state, name)),
                                   rtol=1e-4, atol=1e-6, err_msg=name)
    np.testing.assert_allclose(tv["input"]["z"].detach().numpy(),
                               np.asarray(jv["input"]["z"]), rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(tl[0][1]["loss"], np.asarray(jl[0][1]["loss"]),
                               rtol=1e-4, atol=1e-5)


# --------------------------------------------------------------------- #
# the port's drivers                                                      #
# --------------------------------------------------------------------- #

def _toy_opt(toys, cls, method, **kw):
    _, tm, target = toys
    vm = VariableManager(seed=0, device="cpu")
    _register_toy(vm, hooks.Clamp(1.5), target)
    return cls(method, tm, vm, LF.l1_loss, device="cpu",
               track_variables=False, **kw)


def _outcome(opt, variables):
    return ([t.clone() for t in opt.ng_state],
            variables["input"]["z"].detach().clone(),
            torch.as_tensor(np.asarray(opt.loss)), list(opt.losses))


@pytest.mark.parametrize("method", ["TBPSA", "LMMAES", "CMA"])
def test_fused_and_host_loop_hybrid_drivers_agree(toys, method):
    runs = []
    for fused in (False, True):
        opt = _toy_opt(toys, HybridNevergradOptimizer, method, seed=4)
        drive = opt.optimize_fused if fused else opt.optimize
        v, _, _ = drive(num_samples=6, meta_steps=3, grad_steps=3,
                        last_grad_steps=4)
        runs.append(_outcome(opt, v))
    (s1, z1, l1, t1), (s2, z2, l2, t2) = runs
    for a, b in zip(s1, s2):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7)
    torch.testing.assert_close(z1, z2, rtol=1e-6, atol=1e-7)
    torch.testing.assert_close(l1, l2, rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(t1, t2, rtol=1e-6)
    assert len(t1) == 3


@pytest.mark.parametrize("cls", [NevergradOptimizer,
                                 HybridNevergradOptimizer])
def test_fused_resume_runs_no_generation(toys, tmp_path, capsys, cls):
    ckpt = str(tmp_path / "ng.npz")
    kw = (dict(grad_steps=5) if cls is NevergradOptimizer
          else dict(grad_steps=2, last_grad_steps=5))
    first = _toy_opt(toys, cls, "DiagonalCMA")
    v1, _, _ = first.optimize_fused(num_samples=6, meta_steps=3,
                                    checkpoint_path=ckpt, **kw)
    capsys.readouterr()
    again = _toy_opt(toys, cls, "DiagonalCMA")
    v2, _, _ = again.optimize_fused(num_samples=6, meta_steps=3,
                                    checkpoint_path=ckpt, **kw)
    out = capsys.readouterr().out
    assert "at generation 3" in out and "resumed gradient run at step 5/5" \
        in out
    assert again.gen_seconds == [] and again.losses == []
    for a, b in zip(again.ng_state, first.ng_state):
        assert torch.equal(a, b)
    assert torch.equal(v2["input"]["z"], v1["input"]["z"])


def test_budget_reaches_ngopt_routing(toys):
    import importlib
    from pix2latent_tpu.optimizers.ng_base import _BaseNGOptimizer as JaxNGB
    jreg = importlib.import_module("pix2latent_tpu.strategies.registry")

    # d = 8, 6 workers, 2 generations: budget 12 routes to TBPSA; without a
    # budget NGOpt falls back to aCMA below 130 dimensions
    opt = _toy_opt(toys, HybridNevergradOptimizer, "NGOpt")
    opt.optimize(num_samples=6, meta_steps=2, grad_steps=1, last_grad_steps=1)
    assert type(opt.ng_strategy).__name__ == "TBPSAStrategy"
    opt.setup_ng(opt.var_manager, 6)
    assert type(opt.ng_strategy).__name__ == "ActiveCMAStrategy"
    # the BasinCMA-shaped regime (pop 18, 30 generations, d = 128): aCMA
    vm = VariableManager(device="cpu")
    vm.register("z", shape=(128,), grad_free=True)
    opt.setup_ng(vm, 18, budget=30 * 18)
    assert type(opt.ng_strategy).__name__ == "ActiveCMAStrategy"

    class Driver(JaxNGB):
        def __init__(self):
            JaxNGB.__init__(self, method="NGOpt")
            self._k = jax.random.PRNGKey(0)

        def next_key(self):
            self._k, k = jax.random.split(self._k)
            return k

    jvm = JaxVariableManager()
    jvm.register("z", shape=(Z_DIM,), grad_free=True)
    for budget, leaf in ((12, "TBPSAStrategy"), (None, "ActiveCMAStrategy")):
        drv = Driver()
        drv.setup_ng(jvm, 6, budget=budget)
        assert isinstance(drv.ng_strategy, getattr(jreg, leaf))
