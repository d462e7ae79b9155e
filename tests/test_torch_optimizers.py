"""The port's StyleGAN2 slice drivers against the JAX package's.

- One BasinCMA generation through a tiny StyleGAN2 (im_res 16, channel
  multiplier 2, equalized weights) with injected CMA candidates, the
  Normalize hook and the masked L1 loss with the cars border mask; the port
  runs with both kernel flags on (their plain versions on the CPU), the JAX
  package with both off. Per-step per-sample losses, the tell fitness and
  the CMA state agree at the tolerances of ``tests/test_torch_basincma.py``
  (rtol 2e-3, atol 2e-5; CMA state atol 1e-5).
- ``GradientOptimizer`` and ``CMAOptimizer`` trajectories on the toy model
  with weights carried from JAX, fed the same draws (a fixed initial
  population; injected CMA asks) and deterministic hooks: rtol 1e-4, atol
  1e-5 on the final variables and losses; CMA state as above.
- ``max_batch_size`` chunking (pop 5 in chunks of 2, the last wrap-padded):
  the chunked gradient equals the unchunked one and the JAX package's
  chunked one (rtol 1e-5, atol 1e-6), and so do three chunked steps.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pix2latent_tpu.loss_functions as JLF
import pix2latent_tpu.strategies.cma as jax_cma
import pix2latent_tpu_torch.loss_functions as LF
import pix2latent_tpu_torch.strategies.cma as torch_cma
from pix2latent_tpu import VariableManager as JaxVariableManager
from pix2latent_tpu import hooks as jax_hooks
from pix2latent_tpu.core.step import ExecutionCore as JaxCore
from pix2latent_tpu.models.toy import make_toy_model as jax_toy
from pix2latent_tpu.optimizers import BasinCMAOptimizer as JaxBasinCMA
from pix2latent_tpu.optimizers import CMAOptimizer as JaxCMAOptimizer
from pix2latent_tpu.optimizers import GradientOptimizer as JaxGradient
from pix2latent_tpu.utils.params_io import _flatten
from pix2latent_tpu_torch import VariableManager, hooks
from pix2latent_tpu_torch.core.step import ExecutionCore, chunk_spec
from pix2latent_tpu_torch.examples.common import cars_loss_mask
from pix2latent_tpu_torch.models.toy import ToyGenerator
from pix2latent_tpu_torch.ops import fir_blur as FB
from pix2latent_tpu_torch.ops import mod_backward as MB
from pix2latent_tpu_torch.optimizers import (BasinCMAOptimizer, CMAOptimizer,
                                             GradientOptimizer)
from pix2latent_tpu_torch.utils.params_io import from_jax_params
from test_torch_stylegan2 import Pair

TRAJ = dict(rtol=1e-4, atol=1e-5)
CMA_FIELDS = ("mean", "sigma", "C", "p_sigma", "p_c")


def _assert_cma_state(got, want):
    for name in CMA_FIELDS:
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(want, name)), rtol=2e-3,
                                   atol=1e-5, err_msg=name)


# --------------------------------------------------------------------- #
# BasinCMA through StyleGAN2                                              #
# --------------------------------------------------------------------- #

SG2_POP, SG2_STEPS, SG2_RES = 4, 3, 16


def _register_sg2(vm, normalize, target):
    vm.register("z", shape=(512,), var_type="input", grad_free=True,
                learning_rate=0.05, hook_fn=normalize)
    vm.register("target", shape=(SG2_RES, SG2_RES, 3), var_type="output",
                requires_grad=False, default=target)
    vm.register("weight", shape=(SG2_RES, SG2_RES, 3), var_type="output",
                requires_grad=False,
                default=np.ones((SG2_RES, SG2_RES, 3), np.float32))
    vm.register("loss_mask", shape=(SG2_RES, SG2_RES, 3), var_type="output",
                requires_grad=False, default=cars_loss_mask(SG2_RES))


def test_basincma_generation_on_stylegan2_matches_jax():
    pair = Pair(SG2_RES, 2)
    rng = np.random.RandomState(8)
    target = np.asarray(pair.jm(z=jnp.asarray(rng.randn(1, 512),
                                              jnp.float32)))[0]
    x = rng.randn(SG2_POP, 512).astype(np.float32)

    jvm = JaxVariableManager(seed=0)
    _register_sg2(jvm, jax_hooks.Normalize(), jnp.asarray(target))
    jopt = JaxBasinCMA(pair.jm, jvm, JLF.ReconstructionLoss("l1"),
                       track_variables=False)
    jopt.setup_cma(jvm, popsize=SG2_POP)
    core = jopt.core
    variables = jvm.initialize(num_samples=SG2_POP, key=jax.random.PRNGKey(1))
    variables["input"]["z"] = jnp.asarray(x)
    opt_state = core.init_opt_state(variables)
    variables, opt_state, _, ys = core.grad_steps(
        variables, opt_state, jax.random.PRNGKey(2), SG2_STEPS)
    want_inner = np.asarray(ys["loss"])
    want_tell = core.tell_loss(variables, jax.random.PRNGKey(3), SG2_STEPS)
    want_state = jax_cma.tell(jopt.cma_params, jopt.cma_state, jnp.asarray(x),
                              want_tell)

    vm = VariableManager(seed=0, device="cpu")
    _register_sg2(vm, hooks.Normalize(), target)
    model = pair.port(fused_mod_bwd=True, fir_kernel=True)
    opt = BasinCMAOptimizer(model, vm, LF.ReconstructionLoss("l1"),
                            device="cpu")
    opt.setup_cma(vm, popsize=SG2_POP)
    asked = opt.cma_init(vm)
    asked["input"]["z"] = torch.tensor(x)
    opt._sampled = torch.tensor(x)
    tell, inner = opt.refine_and_tell(asked, SG2_STEPS, 0)

    assert inner.shape == (SG2_STEPS, SG2_POP)
    np.testing.assert_allclose(inner.numpy(), want_inner, rtol=2e-3, atol=2e-5)
    np.testing.assert_allclose(tell.numpy(), np.asarray(want_tell), rtol=2e-3,
                               atol=2e-5)
    assert want_inner[-1].mean() < want_inner[0].mean()     # not vacuous
    _assert_cma_state(opt.cma_state, want_state)
    assert FB.launch_counts() == {"fwd": 0, "bwd": 0}      # CPU: plain
    assert MB.launch_counts() == {"bwd": 0}


# --------------------------------------------------------------------- #
# toy-model drivers                                                       #
# --------------------------------------------------------------------- #

Z_DIM, RES, WIDTH = 16, 16, 8


@pytest.fixture(scope="module")
def toys():
    jm = jax_toy(z_dim=Z_DIM, res=RES, width=WIDTH, seed=0)
    tm = ToyGenerator(z_dim=Z_DIM, res=RES, width=WIDTH)
    tm.load_state_dict(from_jax_params(_flatten(jm.params)), strict=True)
    tm.requires_grad_(False)
    z_star = np.random.RandomState(9).randn(1, Z_DIM).astype(np.float32) * 0.5
    target = np.asarray(jm(z=jnp.asarray(z_star)))[0]
    np.testing.assert_allclose(tm(z=torch.tensor(z_star))[0].numpy(), target,
                               rtol=1e-5, atol=1e-6)
    return jm, tm, target


def _register_toy(vm, clamp, target, z0=None):
    dist = None
    if z0 is not None:
        dist = lambda _rng, n, shape: z0[:n]              # noqa: E731
    vm.register("z", shape=(Z_DIM,), grad_free=True, learning_rate=0.05,
                hook_fn=clamp, distribution=dist)
    vm.register("target", shape=(RES, RES, 3), var_type="output",
                requires_grad=False, default=target)


def test_gradient_optimizer_trajectory_matches_jax(toys):
    jm, tm, target = toys
    z0 = np.random.RandomState(10).randn(5, Z_DIM).astype(np.float32)
    jvm = JaxVariableManager(seed=0)
    _register_toy(jvm, jax_hooks.Clamp(1.5), jnp.asarray(target),
                  jnp.asarray(z0))
    jv, jouts, jl = JaxGradient(jm, jvm, JLF.l1_loss).optimize(5, 8)

    vm = VariableManager(seed=0, device="cpu")
    _register_toy(vm, hooks.Clamp(1.5), target, torch.tensor(z0))
    tv, outs, tl = GradientOptimizer(tm, vm, LF.l1_loss,
                                     device="cpu").optimize(5, 8)
    # both return the collage of the population (to_grid)
    assert tl[0][0] == jl[0][0] == 8 and outs[0].shape == jouts[0].shape
    np.testing.assert_allclose(outs[0], np.asarray(jouts[0]), **TRAJ)
    np.testing.assert_allclose(tv["input"]["z"].detach().numpy(),
                               np.asarray(jv["input"]["z"]), **TRAJ)
    np.testing.assert_allclose(tl[0][1]["loss"], np.asarray(jl[0][1]["loss"]),
                               **TRAJ)


def test_cma_optimizer_trajectory_matches_jax(toys, monkeypatch):
    jm, tm, target = toys
    gens, pop, steps = 3, 6, 4
    asks = np.random.RandomState(11).randn(gens + 1, pop, Z_DIM).astype(
        np.float32)

    def injected(to_array):
        it = iter(asks)
        return lambda *_: to_array(next(it))

    jvm = JaxVariableManager(seed=0)
    _register_toy(jvm, jax_hooks.Clamp(1.5), jnp.asarray(target))
    monkeypatch.setattr(jax_cma, "ask", injected(jnp.asarray))
    jopt = JaxCMAOptimizer(jm, jvm, JLF.l1_loss)
    jv, _, jl = jopt.optimize(gens, steps, popsize=pop)

    vm = VariableManager(seed=0, device="cpu")
    _register_toy(vm, hooks.Clamp(1.5), target)
    monkeypatch.setattr(torch_cma, "ask", injected(torch.tensor))
    opt = CMAOptimizer(tm, vm, LF.l1_loss, device="cpu")
    tv, _, tl = opt.optimize(gens, steps, popsize=pop)

    assert len(opt.losses) == gens and tl[0][0] == gens + steps
    _assert_cma_state(opt.cma_state, jopt.cma_state)
    np.testing.assert_allclose(tv["input"]["z"].detach().numpy(),
                               np.asarray(jv["input"]["z"]), **TRAJ)
    np.testing.assert_allclose(tl[0][1]["loss"], np.asarray(jl[0][1]["loss"]),
                               **TRAJ)
    with pytest.raises(ValueError):
        opt.optimize(1, 0, num_samples=4)


# --------------------------------------------------------------------- #
# max_batch_size chunking                                                 #
# --------------------------------------------------------------------- #

CHUNK_POP, MBS = 5, 2


def test_chunk_spec_wraps_the_last_chunk():
    assert chunk_spec(5, 2) == (3, 2, 1)
    assert chunk_spec(22, 4) == (6, 4, 2)
    assert chunk_spec(4, 4) == (1, 4, 0) and chunk_spec(4, None) == (1, 4, 0)


def _toy_cores(toys, mbs):
    jm, tm, target = toys
    jvm = JaxVariableManager(seed=0)
    _register_toy(jvm, jax_hooks.Clamp(1.5), jnp.asarray(target))
    vm = VariableManager(seed=0, device="cpu")
    _register_toy(vm, hooks.Clamp(1.5), target)
    return (JaxCore(jm, jvm, JLF.l1_loss, max_batch_size=mbs),
            ExecutionCore(tm, vm, LF.l1_loss, max_batch_size=mbs), vm)


def _population(vm, z):
    v = vm.initialize(CHUNK_POP)
    v["input"]["z"] = torch.tensor(z)
    return v


def test_chunked_gradient_matches_unchunked_and_jax(toys):
    z = np.random.RandomState(12).randn(CHUNK_POP, Z_DIM).astype(np.float32)
    jcore, core, vm = _toy_cores(toys, MBS)
    _, unchunked, _ = _toy_cores(toys, None)

    grads, losses = [], []
    for c in (core, unchunked):
        variables, _ = c.init_opt_state(c._dedupe_outputs(_population(vm, z)))
        per_sample, out = c._forward_backward(variables)
        assert out.shape == (CHUNK_POP, RES, RES, 3)
        grads.append(variables["input"]["z"].grad.numpy())
        losses.append(per_sample.numpy())
    jv = jcore._dedupe_outputs({"input": {"z": jnp.asarray(z)},
                                "output": {"target": jnp.asarray(
                                    toys[2])[None]}})
    jps, _, jgrads = jcore._value_and_grad(jcore.model.params, jv)
    for g, ps in zip(grads, losses):
        np.testing.assert_allclose(g, np.asarray(jgrads["input"]["z"]),
                                   rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(ps, np.asarray(jps), rtol=1e-5, atol=1e-6)
    assert np.abs(grads[0]).max() > 0


def test_chunked_steps_and_tell_match_jax(toys):
    z = np.random.RandomState(13).randn(CHUNK_POP, Z_DIM).astype(np.float32)
    jcore, core, vm = _toy_cores(toys, MBS)
    jv = {"input": {"z": jnp.asarray(z)},
          "output": {"target": jnp.broadcast_to(jnp.asarray(toys[2]),
                                                (CHUNK_POP, RES, RES, 3))}}
    jv, _, _, ys = jcore.grad_steps(jv, jcore.init_opt_state(jv),
                                    jax.random.PRNGKey(0), 3)
    want_tell = jcore.tell_loss(jv, jax.random.PRNGKey(1), 3)

    variables, opt = core.init_opt_state(_population(vm, z))
    variables, _, out, ts = core.grad_steps(variables, opt, vm.generator, 3)
    tell = core.tell_loss(variables, vm.generator, 3)
    assert out.shape == (CHUNK_POP, RES, RES, 3)
    np.testing.assert_allclose(ts["loss"].numpy(), np.asarray(ys["loss"]),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(variables["input"]["z"].detach().numpy(),
                               np.asarray(jv["input"]["z"]), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(tell.numpy(), np.asarray(want_tell), rtol=1e-5,
                               atol=1e-6)
