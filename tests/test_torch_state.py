"""The port's state layer (variables, distributions, hooks, per-variable
Adam) against the JAX package: deterministic functions on the same inputs,
samplers by their statistics (torch's Philox and JAX's threefry give
different streams), and Adam trajectories fed identical gradients."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from pix2latent_tpu import VariableManager as JaxVariableManager
from pix2latent_tpu import hooks as jax_hooks
from pix2latent_tpu_torch import (VariableManager, distribution, hooks,
                                  load_variables, save_variables)


def _gen(seed=0):
    return torch.Generator().manual_seed(seed)


def test_registry_rules():
    vm = VariableManager(device="cpu")
    assert vm.register("z", (4,))
    assert not vm.register("z", (4,))
    with pytest.raises(ValueError):
        vm.register("w", (3,), default=np.zeros(4))
    assert not vm.edit_variable("z", {"bogus": 1})
    assert not vm.edit_variable("nope", {"learning_rate": 1.0})
    assert vm.edit_variable("z", {"default": np.ones(4)})
    assert vm.defaults()["z"].tolist() == [1.0] * 4
    vm.unregister("z")
    assert vm.variable_info == {}


def test_initialize_draws_in_sorted_order_and_broadcasts_defaults():
    vm = VariableManager(seed=4, device="cpu")
    vm.register("b", (3,), distribution=distribution.Normal())
    vm.register("a", (2,), distribution=distribution.Normal())
    vm.register("t", (2, 2), var_type="output", requires_grad=False,
                default=np.arange(4.0).reshape(2, 2))
    v = vm.initialize(5, generator=_gen(1))
    g = _gen(1)
    a = torch.randn((5, 2), generator=g)
    b = torch.randn((5, 3), generator=g)
    torch.testing.assert_close(v["input"]["a"], a)
    torch.testing.assert_close(v["input"]["b"], b)
    assert v["output"]["t"].shape == (5, 2, 2)
    assert torch.equal(v["output"]["t"][3], torch.arange(4.0).reshape(2, 2))
    over = vm.initialize(2, defaults={"a": torch.ones(2)})
    assert torch.equal(over["input"]["a"], torch.ones(2, 2))


def test_truncated_normal_modulo_sign_rule_matches_jnp_fmod():
    x = np.linspace(-5.5, 5.5, 101).astype(np.float32)
    np.testing.assert_array_equal(
        torch.fmod(torch.tensor(x) + 0.25, 2.0).numpy(),
        np.asarray(jnp.fmod(jnp.asarray(x) + 0.25, 2.0)))
    s = distribution.TruncatedNormalModulo(sigma=1.0, trunc=2.0)(
        _gen(), 20000, (4,))
    assert s.shape == (20000, 4) and s.abs().max() < 2.0
    assert abs(float(s.mean())) < 0.02


@pytest.mark.parametrize("name,check", [
    ("TruncatedClampNormal", lambda s: s.abs().max() <= 1.5
     and (s.abs() == 1.5).any()),
    ("Normal", lambda s: abs(float(s.std()) - 1.5) < 0.03),
    ("Uniform", lambda s: s.min() >= -1.5 and s.max() < 1.5
     and abs(float(s.mean())) < 0.03),
])
def test_distribution_statistics(name, check):
    kwargs = {"Uniform": dict(low=-1.5, high=1.5)}.get(
        name, dict(sigma=1.5) if name == "Normal" else dict(sigma=1.0,
                                                              trunc=1.5))
    s = getattr(distribution, name)(**kwargs)(_gen(2), 20000, (2,))
    assert s.dtype == torch.float32 and s.shape == (20000, 2)
    assert check(s)


@pytest.mark.parametrize("name,args", [("Clamp", (0.7,)),
                                       ("Normalize", (0.5, 2.0))])
def test_deterministic_hooks_match_jax(name, args):
    x = np.random.RandomState(3).randn(4, 6).astype(np.float32)
    want = getattr(jax_hooks, name)(*args)(jax.random.PRNGKey(0),
                                           jnp.asarray(x), 3)
    got = getattr(hooks, name)(*args)(_gen(), torch.tensor(x), 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)


def test_perturb_hooks_and_compose():
    x = torch.zeros(4000, 8)
    noisy = hooks.NormalPerturb(0.3)(_gen(), x)
    assert abs(float(noisy.std()) - 0.3) < 0.01
    sched = hooks.ScheduledNormalPerturb(sigma=0.5, max_step=11, pow=2)
    assert abs(float(sched(_gen(), x, 5).std()) - 0.0625) < 0.003
    assert torch.equal(sched(_gen(), x, 10), x)
    both = hooks.Compose([hooks.NormalPerturb(3.0), hooks.Clamp(1.0)])
    assert float(both(_gen(), x).abs().max()) == 1.0


def test_apply_hooks_leaves_inputs_untouched():
    vm = VariableManager(device="cpu")
    vm.register("z", (3,), hook_fn=hooks.Clamp(1.0))
    v = {"input": {"z": torch.full((2, 3), 5.0)}}
    out = vm.apply_hooks(_gen(), v, 0)
    assert torch.equal(v["input"]["z"], torch.full((2, 3), 5.0))
    assert torch.equal(out["input"]["z"], torch.ones(2, 3))


def test_per_variable_adam_matches_optax():
    """Fed the same gradients, the port's per-variable torch Adam and the
    JAX package's optax optimizer take the same steps; frozen variables
    get no optimizer."""
    specs = [("a", 0.05, True), ("b", 0.01, True), ("t", 0.3, False)]
    jvm, vm = JaxVariableManager(), VariableManager(device="cpu")
    for name, lr, grad in specs:
        for m in (jvm, vm):
            m.register(name, (5,), learning_rate=lr, requires_grad=grad)
    rng = np.random.RandomState(0)
    init = {n: rng.randn(3, 5).astype(np.float32) for n, _, _ in specs}
    jvars = {"input": {n: jnp.asarray(a) for n, a in init.items()}}
    tvars = {"input": {n: torch.tensor(a, requires_grad=g)
                       for (n, _, g), a in zip(specs, init.values())}}
    opt_j = jvm.make_optimizer()
    state = opt_j.init(jvars)
    opt_t = vm.make_optimizer(tvars)
    assert len(opt_t.optimizers) == 1
    assert [g["lr"] for g in opt_t.optimizers[0].param_groups] == [0.05, 0.01]
    for _ in range(10):
        grads = {n: rng.randn(3, 5).astype(np.float32) for n in init}
        upd, state = opt_j.update(
            {"input": {n: jnp.asarray(g) for n, g in grads.items()}}, state,
            jvars)
        jvars = optax.apply_updates(jvars, upd)
        opt_t.zero_grad()
        for n, g in grads.items():
            if tvars["input"][n].requires_grad:
                tvars["input"][n].grad = torch.tensor(g)
        opt_t.step()
    for n in init:
        np.testing.assert_allclose(tvars["input"][n].detach().numpy(),
                                   np.asarray(jvars["input"][n]), rtol=1e-5,
                                   atol=1e-6, err_msg=n)
    np.testing.assert_array_equal(tvars["input"]["t"].detach().numpy(),
                                  init["t"])


def test_unknown_optimizer_raises():
    vm = VariableManager(device="cpu")
    vm.register("z", (2,), optimizer="lamb")
    with pytest.raises(ValueError):
        vm.make_optimizer({"input": {"z": torch.zeros(1, 2,
                                                      requires_grad=True)}})


def test_save_variables_writes_exactly_the_path(tmp_path):
    v = {"input": {"z": torch.arange(6.0).reshape(2, 3)}}
    path = tmp_path / "state.ckpt"
    save_variables(str(path), v, extras={"step": np.int64(7)})
    assert sorted(p.name for p in tmp_path.iterdir()) == ["state.ckpt"]
    back = load_variables(str(path))
    np.testing.assert_array_equal(back["variables"]["input"]["z"],
                                  np.arange(6.0).reshape(2, 3))
    assert back["step"] == 7
