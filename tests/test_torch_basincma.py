"""The port's BasinCMA slice end to end against the JAX package.

One generation with the CMA candidates injected (JAX's threefry and torch's
Philox cannot give the same ask): fresh Adam state, 4 inner steps on (z, c)
through BigGAN-deep-128 under ProjectionLoss with the Clamp hook, the tell
loss of the refined population, and the CMA tell keyed to the asked
candidates. The JAX side drives its ExecutionCore, ``tell_loss`` and
``cma.tell`` with the same candidates. Per-step per-sample losses and the
tell fitness agree at the tolerances of tests/test_e2e_parity.py (rtol
2e-3, atol 2e-5).

Also here: the optimizer end to end on the toy model, the rule that the port
imports nothing of JAX, and the rule that entry points need an explicit
``device="cpu"`` when no GPU is present.
"""

import math
import re
import subprocess
import sys
from pathlib import Path

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
from pix2latent_tpu.optimizers import BasinCMAOptimizer as JaxBasinCMA
from pix2latent_tpu.strategies import cma as jax_cma
from pix2latent_tpu.utils.params_io import _flatten
from pix2latent_tpu_torch import VariableManager, hooks
from pix2latent_tpu_torch.losses.lpips import LPIPS
from pix2latent_tpu_torch.models.biggan import BigGAN
from pix2latent_tpu_torch.models.toy import make_toy_model
from pix2latent_tpu_torch.ops import attention as TA
from pix2latent_tpu_torch.optimizers import BasinCMAOptimizer
from test_biggan_golden import make_state_dict
from test_lpips_golden import make_alex_state_dict

ROOT = Path(__file__).resolve().parents[1]
POP, N_STEPS = 6, 4
VERSION, CH, RES = "biggan-deep-128", 8, 128
LR_Z, LR_C, BETA = 0.05, 0.01, 10.0


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


def test_generation_with_injected_candidates_matches_jax():
    rng = np.random.RandomState(7)
    gparams = convert_torch_biggan(make_state_dict(rng, VERSION, CH), VERSION)
    lparams = convert_torch_lpips(make_alex_state_dict(rng), net="alex")
    jm = JaxBigGAN(VERSION, params=gparams, channel_width=CH)
    onehot = np.zeros((1, 1000), np.float32)
    onehot[0, 153] = 1.0
    c0 = np.asarray(jm.get_class_embedding(jnp.asarray(onehot)))[0]
    z_star = rng.randn(1, 128).astype(np.float32) * 0.5
    target = np.asarray(jm(z=jnp.asarray(z_star), c=jnp.asarray(c0[None])))[0]
    # the injected ask; some entries beyond the clamp so the hook acts
    x = (rng.randn(POP, 128) * 0.8).astype(np.float32)

    # ------------------------- JAX package ------------------------------ #
    jvm = JaxVariableManager(seed=0)
    _register(jvm, jax_hooks.Clamp(2.0), jnp.asarray(c0), jnp.asarray(target))
    jopt = JaxBasinCMA(jm, jvm, JLF.ProjectionLoss(
        "alex", beta=BETA, lpips_params=lparams), track_variables=False)
    jopt.setup_cma(jvm, popsize=POP)
    core = jopt.core
    variables = jvm.initialize(num_samples=POP, key=jax.random.PRNGKey(1))
    variables["input"]["z"] = jnp.asarray(x)
    opt_state = core.init_opt_state(variables)
    variables, opt_state, _, ys = core.grad_steps(
        variables, opt_state, jax.random.PRNGKey(2), N_STEPS)
    want_inner = np.asarray(ys["loss"])
    want_tell = core.tell_loss(variables, jax.random.PRNGKey(3), N_STEPS)
    want_state = jax_cma.tell(jopt.cma_params, jopt.cma_state,
                              jnp.asarray(x), want_tell)

    # ------------------------- the port --------------------------------- #
    vm = VariableManager(seed=0, device="cpu")
    _register(vm, hooks.Clamp(2.0), c0, target)
    tm = BigGAN(VERSION, params=_flatten(gparams), channel_width=CH,
                device="cpu")
    opt = BasinCMAOptimizer(tm, vm, LF.ProjectionLoss(
        "alex", beta=BETA, lpips_params=lparams, device="cpu"), device="cpu")
    opt.setup_cma(vm, popsize=POP)
    asked = opt.cma_init(vm)
    asked["input"]["z"] = torch.tensor(x)
    opt._sampled = torch.tensor(x)
    TA.reset_launch_counts()
    tell, inner = opt.refine_and_tell(asked, N_STEPS, 0)

    assert inner.shape == (N_STEPS, POP) and tell.shape == (POP,)
    for step in range(N_STEPS):
        np.testing.assert_allclose(
            inner[step].numpy(), want_inner[step], rtol=2e-3, atol=2e-5,
            err_msg=f"per-sample loss diverged at inner step {step}")
    np.testing.assert_allclose(tell.numpy(), np.asarray(want_tell),
                               rtol=2e-3, atol=2e-5, err_msg="tell fitness")
    assert want_inner[-1].mean() < want_inner[0].mean()    # not vacuous
    for name in ("mean", "sigma", "C", "p_sigma", "p_c"):
        np.testing.assert_allclose(
            getattr(opt.cma_state, name).numpy(),
            np.asarray(getattr(want_state, name)), rtol=2e-3, atol=1e-5,
            err_msg=name)
    assert TA.launch_counts() == {"fwd": 0, "bwd": 0}     # CPU: plain path


def test_optimize_runs_the_search_on_the_toy_model():
    model = make_toy_model(z_dim=16, res=16, width=8, seed=0, device="cpu")
    with torch.no_grad():
        target = model(z=torch.full((1, 16), 0.3))[0]
    vm = VariableManager(seed=0, device="cpu")
    vm.register("z", shape=(16,), grad_free=True, learning_rate=0.05,
                hook_fn=hooks.Clamp(2.0))
    vm.register("target", shape=(16, 16, 3), var_type="output",
                requires_grad=False, default=target)
    opt = BasinCMAOptimizer(model, vm, LF.l1_loss, seed=3, device="cpu")
    variables, outs, final = opt.optimize(3, 5, last_grad_steps=7)
    pop = opt.num_samples
    assert pop == 4 + int(math.floor(3 * math.log(16)))
    assert len(opt.losses) == 3 and all(map(math.isfinite, opt.losses))
    assert len(opt.gen_seconds) == 3
    # the result is the collage of the population, as the JAX package's
    assert outs[0].shape == (3 * 18 + 2, 4 * 18 + 2, 3)
    np.testing.assert_array_equal(outs[0][2:18, 2:18],
                                  opt.out[0].detach().numpy())
    assert final[0][0] == 3 * 5 + 7 and final[0][1]["loss"].shape == (pop,)
    assert variables["input"]["z"].abs().max() <= 2.0 + 0.05 * 7
    assert float(opt.cma_state.gen) == 3


_FORBIDDEN = re.compile(
    r"^\s*(import|from)\s+(jax|flax|optax|pix2latent_tpu)\b", re.M)


def test_port_imports_nothing_of_jax():
    files = sorted((ROOT / "pix2latent_tpu_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 10
    names = {f.relative_to(ROOT).as_posix() for f in files}
    assert {f"pix2latent_tpu_torch/{m}.py" for m in (
        "ops/upfirdn2d", "ops/fir_blur", "ops/mod_backward",
        "models/stylegan2", "optimizers/gradient", "optimizers/cma_optimizer",
        "utils/params_io", "core/step",
        "transform/spatial", "transform/transform_optimizer",
        "ops/affine_matmul", "ops/grid_sample", "strategies/registry",
        "strategies/lmmaes", "strategies/host", "optimizers/ng_base",
        "optimizers/ng_optimizer", "examples/invert_biggan_adam",
        "examples/invert_biggan_cma", "examples/invert_biggan_nevergrad",
        "examples/invert_biggan_hybrid_nevergrad",
        "examples/invert_stylegan2_cars_basincma",
        "examples/invert_stylegan2_cars_adam",
        "examples/invert_stylegan2_cars_cma",
        "examples/invert_stylegan2_cars_ng",
        "examples/invert_stylegan2_cars_hybrid_ng",
        "edit/ganspace", "edit/editor", "examples/edit_biggan",
        "utils/benchmark", "utils/imagenet_tools", "utils/profiling",
        "utils/misc", "variables", "distribution")} <= names
    for f in files:
        assert not _FORBIDDEN.search(f.read_text()), f
    probe = ("import sys, pkgutil, importlib, pix2latent_tpu_torch as p\n"
             "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
             "    importlib.import_module(m.name)\n"
             "bad = [m for m in sys.modules if m.split('.')[0] in\n"
             "       ('jax', 'flax', 'optax', 'pix2latent_tpu')]\n"
             "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", probe], cwd=ROOT, check=True,
                   timeout=120)


def test_entry_points_need_a_device_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        VariableManager()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        BigGAN(VERSION, channel_width=CH)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        LPIPS()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        LF.ProjectionLoss()
    model = make_toy_model(device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        BasinCMAOptimizer(model, VariableManager(device="cpu"), LF.l1_loss)
    with pytest.raises(ValueError):
        BasinCMAOptimizer(model, VariableManager(device="cpu"), LF.l1_loss,
                          device="meta")
