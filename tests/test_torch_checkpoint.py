"""The port's checkpoint and resume (``utils/checkpoint.py``) and its
segmented gradient runs (``core/step.py``), against the JAX package's
protocol (``tests/test_aux.py`` TestCheckpoint, TestFusedCheckpointer,
TestLoopCheckpointerDrivers; ``tests/test_core.py`` TestSegmentedGradSteps).

JAX's keys and torch's generator give different streams, so the port is held
against its own uninterrupted run, bitwise, on the CPU: a segmented run
equals one run step for step, and a run resumed after a crash lands on the
uninterrupted trajectory. The host-loop drivers' resume is held against the
JAX package's on the same toy model, weights and injected CMA asks.
"""

import os

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
from pix2latent_tpu.models.toy import make_toy_model as jax_toy
from pix2latent_tpu.optimizers import BasinCMAOptimizer as JaxBasinCMA
from pix2latent_tpu.optimizers import CMAOptimizer as JaxCMAOptimizer
from pix2latent_tpu.utils.params_io import _flatten
from pix2latent_tpu_torch import VariableManager, hooks
from pix2latent_tpu_torch.core.step import ExecutionCore
from pix2latent_tpu_torch.models.toy import ToyGenerator, make_toy_model
from pix2latent_tpu_torch.optimizers import BasinCMAOptimizer, CMAOptimizer
from pix2latent_tpu_torch.utils.checkpoint import (FusedCheckpointer,
                                                   load_checkpoint,
                                                   save_checkpoint)
from pix2latent_tpu_torch.utils.params_io import from_jax_params

Z_DIM, RES = 4, 8


# --------------------------------------------------------------------- #
# the checkpoint file                                                     #
# --------------------------------------------------------------------- #

def test_roundtrip_namedtuple_generator_and_counter(tmp_path):
    _, state = torch_cma.init(np.zeros(8), sigma=1.5)
    gen = torch.Generator().manual_seed(3)
    tree = {"cma_state": state, "generator": gen.get_state(),
            "meta_iter": np.int32(7), "nested": [torch.ones(2), (None,)]}
    p = str(tmp_path / "ckpt.npz")
    save_checkpoint(p, tree)
    assert not [f for f in os.listdir(tmp_path) if f.endswith(".tmp")]
    like = {"cma_state": torch_cma.init(np.zeros(8))[1],
            "generator": torch.Generator().get_state(),
            "meta_iter": torch.zeros((), dtype=torch.int32),
            "nested": [torch.zeros(2, dtype=torch.float64), (None,)]}
    back = load_checkpoint(p, like)
    assert isinstance(back["cma_state"], torch_cma.CMAState)
    assert float(back["cma_state"].sigma) == 1.5
    assert int(back["meta_iter"]) == 7
    assert back["nested"][0].dtype == torch.float64       # like's dtype
    assert back["nested"][1] == (None,)
    assert torch.equal(back["generator"], tree["generator"])
    restored = torch.Generator()
    restored.set_state(back["generator"])
    assert torch.equal(torch.randn(5, generator=restored),
                       torch.randn(5, generator=torch.Generator().manual_seed(3)))


def test_leaf_count_mismatch_raises(tmp_path):
    p = str(tmp_path / "c.npz")
    save_checkpoint(p, {"a": torch.ones(3)})
    with pytest.raises(ValueError, match="leaves"):
        load_checkpoint(p, {"a": torch.ones(3), "b": torch.ones(2)})


def _toy_problem(hook=True):
    model = make_toy_model(z_dim=Z_DIM, res=RES, width=8, seed=0, device="cpu")
    with torch.no_grad():
        target = model(z=torch.full((1, Z_DIM), 0.4))[0]
    vm = VariableManager(seed=0, device="cpu")
    vm.register("z", shape=(Z_DIM,), learning_rate=0.05,
                hook_fn=hooks.NormalPerturb(0.01) if hook else None)
    vm.register("target", shape=(RES, RES, 3), var_type="output",
                requires_grad=False, default=target)
    return model, vm


def _start(core, vm, pop=5, seed=11):
    variables = vm.initialize(pop, generator=torch.Generator().manual_seed(seed))
    return core.init_opt_state(variables)


def test_adam_state_roundtrips_with_its_step_count(tmp_path):
    model, vm = _toy_problem()
    core = ExecutionCore(model, vm, LF.l1_loss)
    variables, opt = _start(core, vm)
    gen = torch.Generator().manual_seed(1)
    core.grad_steps(variables, opt, gen, 3)
    p = str(tmp_path / "adam.npz")
    save_checkpoint(p, {"v": variables, "opt": opt.state()})

    variables2, opt2 = _start(core, vm)
    back = load_checkpoint(p, {"v": variables2, "opt": opt2.state_template()})
    opt2.load_state(back["opt"])
    core._restore(variables2, back["v"])
    (st,) = opt2.optimizers[0].state.values()
    (want,) = opt.optimizers[0].state.values()
    assert float(st["step"]) == 3.0
    for key in ("exp_avg", "exp_avg_sq"):
        assert torch.equal(st[key], want[key])
    # both continue identically
    for v, o in ((variables, opt), (variables2, opt2)):
        core.grad_steps(v, o, torch.Generator().manual_seed(2), 2)
    assert torch.equal(variables["input"]["z"], variables2["input"]["z"])


def test_zeroed_template_is_a_fresh_optimizer():
    model, vm = _toy_problem()
    core = ExecutionCore(model, vm, LF.l1_loss)
    runs = []
    for primed in (False, True):
        variables, opt = _start(core, vm)
        if primed:
            opt.load_state(opt.state_template())
        core.grad_steps(variables, opt, torch.Generator().manual_seed(4), 3)
        runs.append(variables["input"]["z"].detach())
    assert torch.equal(*runs)


# --------------------------------------------------------------------- #
# FusedCheckpointer and LoopCheckpointer                                  #
# --------------------------------------------------------------------- #

def _carry(v):
    return {"state": torch.tensor([v, v + 1.0]),
            "generator": torch.Generator().manual_seed(int(v)).get_state()}


def test_fused_checkpointer_fresh_run_then_resume(tmp_path):
    p = str(tmp_path / "fc.npz")
    ck = FusedCheckpointer(p, "test loop", every=1)
    assert ck.resume(_carry(0.0)) == 0 and ck.loaded is None
    ck.save(0, _carry(10.0))          # input of gen 0
    ck.save(1, _carry(11.0))          # input of gen 1
    ck2 = FusedCheckpointer(p, "test loop")
    assert ck2.resume(_carry(0.0)) == 1
    np.testing.assert_allclose(ck2.loaded["state"].numpy(), [11.0, 12.0])
    assert torch.equal(ck2.loaded["generator"], _carry(11.0)["generator"])


def test_fused_checkpointer_every_and_finalize(tmp_path):
    p = str(tmp_path / "fc2.npz")
    ck = FusedCheckpointer(p, "test loop", every=2)
    ck.save(0, _carry(1.0))           # 0 % 2 == 0: written
    ck.save(1, _carry(2.0))           # skipped
    assert FusedCheckpointer(p, "test loop").resume(_carry(0.0)) == 0
    ck.finalize(5, _carry(3.0))       # the terminal write always lands
    ck3 = FusedCheckpointer(p, "test loop")
    assert ck3.resume(_carry(0.0)) == 5
    np.testing.assert_allclose(ck3.loaded["state"].numpy(), [3.0, 4.0])


def test_fused_checkpointer_disabled_without_path():
    ck = FusedCheckpointer(None, "test loop")
    assert ck.resume(_carry(0.0)) == 0
    ck.save(0, _carry(1.0))
    ck.finalize(3, _carry(2.0))
    assert ck.loaded is None


@pytest.fixture(scope="module")
def toys():
    jm = jax_toy(z_dim=Z_DIM, res=16, width=8, seed=0)
    tm = ToyGenerator(z_dim=Z_DIM, res=16, width=8)
    tm.load_state_dict(from_jax_params(_flatten(jm.params)), strict=True)
    tm.requires_grad_(False)
    target = np.asarray(jm(z=jnp.ones((1, Z_DIM))))[0]
    return jm, tm, target


def _loop_vms(target):
    jvm = JaxVariableManager(seed=0)
    jvm.register("z", shape=(Z_DIM,), grad_free=True,
                 hook_fn=jax_hooks.Clamp(1.5))
    jvm.register("target", shape=(16, 16, 3), var_type="output",
                 requires_grad=False, default=jnp.asarray(target))
    vm = VariableManager(seed=0, device="cpu")
    vm.register("z", shape=(Z_DIM,), grad_free=True, hook_fn=hooks.Clamp(1.5))
    vm.register("target", shape=(16, 16, 3), var_type="output",
                requires_grad=False, default=target)
    return jvm, vm


@pytest.mark.parametrize("driver", ["cma", "basincma"])
def test_loop_checkpointer_resume_matches_jax(toys, tmp_path, monkeypatch,
                                              driver):
    """Three generations checkpointed, then a second driver on the same
    path resumes at generation 3 and runs only the last ask. The asks are
    injected, so the CMA state of both packages agree (CMA state atol 1e-5,
    as tests/test_torch_optimizers.py), and the resumed run's state is the
    first run's, bitwise."""
    jm, tm, target = toys
    asks = np.random.RandomState(5).randn(8, 6, Z_DIM).astype(np.float32)

    def injected(to_array):
        it = iter(asks)
        return lambda *_: to_array(next(it))

    kwargs = dict(meta_steps=3, grad_steps=2, popsize=6)
    if driver == "basincma":
        kwargs["last_grad_steps"] = 2
    jdrv, drv = {"cma": (JaxCMAOptimizer, CMAOptimizer),
                 "basincma": (JaxBasinCMA, BasinCMAOptimizer)}[driver]
    jvm, vm = _loop_vms(target)
    monkeypatch.setattr(jax_cma, "ask", injected(jnp.asarray))
    jopt = jdrv(jm, jvm, JLF.l1_loss)
    jopt.optimize(checkpoint_path=str(tmp_path / "jax.npz"), **kwargs)

    monkeypatch.setattr(torch_cma, "ask", injected(torch.tensor))
    p = str(tmp_path / "port.npz")
    opt = drv(tm, vm, LF.l1_loss, device="cpu")
    opt.optimize(checkpoint_path=p, **kwargs)
    assert os.path.exists(p)
    for name in ("mean", "sigma", "C", "p_sigma", "p_c"):
        np.testing.assert_allclose(
            getattr(opt.cma_state, name).numpy(),
            np.asarray(getattr(jopt.cma_state, name)), rtol=2e-3, atol=1e-5,
            err_msg=name)

    opt2 = drv(tm, vm, LF.l1_loss, device="cpu")
    opt2.optimize(checkpoint_path=p, **kwargs)
    assert opt2.losses == []                     # no generation ran again
    for a, b in zip(opt2.cma_state, opt.cma_state):
        assert torch.equal(a, b)


# --------------------------------------------------------------------- #
# segmented gradient runs                                                 #
# --------------------------------------------------------------------- #

@pytest.mark.parametrize("seg", [3, 4, 10])
def test_segmented_run_equals_one_run(seg):
    model, vm = _toy_problem(hook=True)
    runs = []
    for segment_steps in (None, seg):
        core = ExecutionCore(model, vm, LF.l1_loss,
                             segment_steps=segment_steps)
        variables, opt = _start(core, vm)
        gen = torch.Generator().manual_seed(42)
        variables, _, out, ys = core.grad_steps(variables, opt, gen, 10,
                                                start_step=7)
        runs.append((variables["input"]["z"].detach(), ys["loss"], out,
                     gen.get_state()))
    for a, b in zip(*runs):
        assert torch.equal(a, b)


def test_tracked_concatenates_across_segments():
    model, vm = _toy_problem(hook=False)
    whole = ExecutionCore(model, vm, LF.l1_loss, track_variables=True,
                          segment_steps=None)
    segmented = ExecutionCore(model, vm, LF.l1_loss, track_variables=True,
                              segment_steps=4)
    got = []
    for core in (whole, segmented):
        variables, opt = _start(core, vm)
        _, _, _, ys = core.grad_steps(variables, opt,
                                      torch.Generator().manual_seed(0), 10)
        assert ys["tracked"]["z"].shape == (10, 5, Z_DIM)
        assert ys["loss"].shape == (10, 5)
        got.append(np.asarray(ys["tracked"]["z"]))
    assert isinstance(got[1], np.ndarray)          # read to the host
    np.testing.assert_array_equal(got[0], got[1])
    # the last tracked row is the final variable
    np.testing.assert_array_equal(got[1][-1], variables["input"]["z"].detach())


def test_resume_after_crash_equals_the_uninterrupted_run(tmp_path,
                                                         monkeypatch):
    model, vm = _toy_problem(hook=True)
    p = str(tmp_path / "final.ckpt")
    core = ExecutionCore(model, vm, LF.l1_loss, segment_steps=3)
    variables, opt = _start(core, vm)
    expected, _, _, eys = core.grad_steps(variables, opt,
                                          torch.Generator().manual_seed(9), 10)
    expected = expected["input"]["z"].detach().clone()

    real = ExecutionCore._run_steps
    calls = {"n": 0}

    def flaky(self, *a, **k):
        calls["n"] += 1
        if calls["n"] == 3:
            raise RuntimeError("injected crash")
        return real(self, *a, **k)

    monkeypatch.setattr(ExecutionCore, "_run_steps", flaky)
    variables, opt = _start(core, vm)
    with pytest.raises(RuntimeError, match="injected crash"):
        core.grad_steps(variables, opt, torch.Generator().manual_seed(9), 10,
                        checkpoint_path=p)
    monkeypatch.setattr(ExecutionCore, "_run_steps", real)

    # restart: a fresh population and generator, as a restarted driver has
    variables, opt = _start(core, vm)
    v2, _, _, ys2 = core.grad_steps(variables, opt,
                                    torch.Generator().manual_seed(9), 10,
                                    checkpoint_path=p)
    assert torch.equal(v2["input"]["z"], expected)
    n_tail = ys2["loss"].shape[0]
    assert 0 < n_tail < 10
    assert torch.equal(eys["loss"][-n_tail:], ys2["loss"])

    # a finished checkpoint runs no step: the saved variables and one
    # evaluation
    monkeypatch.setattr(ExecutionCore, "_run_steps", None)
    variables, opt = _start(core, vm)
    v3, _, out3, ys3 = core.grad_steps(variables, opt,
                                       torch.Generator().manual_seed(9), 10,
                                       checkpoint_path=p)
    assert torch.equal(v3["input"]["z"], expected)
    assert out3.shape == (5, RES, RES, 3) and ys3["loss"].shape == (1, 5)
