"""The port's fused drivers, logging and result convention against the JAX
package's (``tests/test_optimizers.py`` TestCMAOptimizer fused cases,
TestFusedBasinCMA, TestMicrobatching, TestFusedCheckpointing,
TestNonImageModelOutput, the log and tracking tests of
TestGradientOptimizer).

- One fused generation with injected CMA candidates, on the toy model with
  weights carried from JAX, population 6 in microbatches of 4 (the last
  wrap-padded), BasinCMA (3 inner steps) and eval-only: the min tell loss
  and the CMA state agree with the JAX package's fused generation at the
  tolerances of ``tests/test_torch_optimizers.py`` (rtol 1e-4, atol 1e-5 on
  losses; CMA state rtol 2e-3, atol 1e-5).
- Resume: a fused run cut after two generations and resumed on its
  checkpoint equals the uninterrupted run bitwise (the CMA state, the
  variables and the final losses), as does a run whose final Adam run is
  cut and resumed.
- The result convention: ``_final_results`` returns the same collage as the
  JAX package's ``to_grid`` of the same images, and the raw output when it
  is not an image batch.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
import pix2latent_tpu.loss_functions as JLF
import pix2latent_tpu.strategies.cma as jax_cma
import pix2latent_tpu_torch.loss_functions as LF
import pix2latent_tpu_torch.strategies.cma as torch_cma
from pix2latent_tpu import VariableManager as JaxVariableManager
from pix2latent_tpu import hooks as jax_hooks
from pix2latent_tpu.models.toy import make_toy_model as jax_toy
from pix2latent_tpu.optimizers import BasinCMAOptimizer as JaxBasinCMA
from pix2latent_tpu.optimizers import CMAOptimizer as JaxCMAOptimizer
from pix2latent_tpu.utils.image import to_grid as jax_to_grid
from pix2latent_tpu.utils.params_io import _flatten
from pix2latent_tpu_torch import VariableManager, distribution, hooks
from pix2latent_tpu_torch.core.step import ExecutionCore
from pix2latent_tpu_torch.models.toy import ToyGenerator
from pix2latent_tpu_torch.optimizers import (BasinCMAOptimizer, CMAOptimizer,
                                             GradientOptimizer)
from pix2latent_tpu_torch.utils.params_io import from_jax_params

Z_DIM, RES = 8, 16
CMA_FIELDS = ("mean", "sigma", "C", "p_sigma", "p_c")


@pytest.fixture(scope="module")
def toys():
    jm = jax_toy(z_dim=Z_DIM, res=RES, width=16, seed=0)
    tm = ToyGenerator(z_dim=Z_DIM, res=RES, width=16)
    tm.load_state_dict(from_jax_params(_flatten(jm.params)), strict=True)
    tm.requires_grad_(False)
    z_true = np.random.RandomState(7).randn(1, Z_DIM).astype(np.float32)
    target = np.asarray(jm(z=jnp.asarray(z_true)))[0]
    return jm, tm, target


def make_vm(target, grad_free=True, device="cpu"):
    vm = VariableManager(seed=0, device=device)
    vm.register("z", shape=(Z_DIM,), grad_free=grad_free,
                distribution=distribution.TruncatedNormalModulo(1.0, 2.0),
                learning_rate=0.05, hook_fn=hooks.Clamp(4.0))
    vm.register("target", shape=(RES, RES, 3), var_type="output",
                requires_grad=False, default=target)
    vm.register("weight", shape=(RES, RES, 3), var_type="output",
                requires_grad=False, default=np.ones((RES, RES, 3), np.float32))
    return vm


def loss_fn(out, target, weight):
    return LF.masked_l1_loss(out, target, weight)


def jax_loss_fn(out, target, weight):
    return JLF.masked_l1_loss(out, target, weight)


# --------------------------------------------------------------------- #
# one fused generation against the JAX package's                          #
# --------------------------------------------------------------------- #

@pytest.mark.parametrize("grad_steps", [3, 0])
def test_fused_generation_with_injected_candidates_matches_jax(
        toys, monkeypatch, grad_steps):
    jm, tm, target = toys
    pop, mbs = 6, 4
    x = np.random.RandomState(3).randn(pop, Z_DIM).astype(np.float32)

    jvm = JaxVariableManager(seed=0)
    jvm.register("z", shape=(Z_DIM,), grad_free=True, learning_rate=0.05,
                 hook_fn=jax_hooks.Clamp(4.0))
    jvm.register("target", shape=(RES, RES, 3), var_type="output",
                 requires_grad=False, default=jnp.asarray(target))
    jvm.register("weight", shape=(RES, RES, 3), var_type="output",
                 requires_grad=False, default=jnp.ones((RES, RES, 3)))
    monkeypatch.setattr(jax_cma, "ask", lambda *_: jnp.asarray(x))
    jdrv = JaxBasinCMA if grad_steps else JaxCMAOptimizer
    jopt = jdrv(jm, jvm, jax_loss_fn, max_batch_size=mbs,
                track_variables=False)
    jopt.setup_cma(jvm, popsize=pop)
    jax_gen = jopt._get_fused_gen(grad_steps)
    want_state, want_min = jax_gen(jopt.model.params, jvm.defaults(),
                                   jopt.cma_state, jopt.next_key(),
                                   jnp.asarray(0, jnp.int32))

    monkeypatch.setattr(torch_cma, "ask", lambda *_: torch.tensor(x))
    drv = BasinCMAOptimizer if grad_steps else CMAOptimizer
    opt = drv(tm, make_vm(target), loss_fn, max_batch_size=mbs, device="cpu")
    opt.setup_cma(opt.var_manager, popsize=pop)
    state, got_min = opt._get_fused_gen(grad_steps)(opt.cma_state, 0)

    assert got_min.shape == () and got_min.device.type == "cpu"
    np.testing.assert_allclose(float(got_min), float(want_min), rtol=1e-4,
                               atol=1e-5)
    for name in CMA_FIELDS:
        np.testing.assert_allclose(getattr(state, name).numpy(),
                                   np.asarray(getattr(want_state, name)),
                                   rtol=2e-3, atol=1e-5, err_msg=name)


def test_fused_generation_is_memoised(toys):
    _, tm, target = toys
    opt = BasinCMAOptimizer(tm, make_vm(target), loss_fn, device="cpu",
                            track_variables=False)
    opt.optimize_fused(meta_steps=2, grad_steps=2, last_grad_steps=2)
    assert len(opt._fused_gens) == 1
    opt.optimize_fused(meta_steps=1, grad_steps=2, last_grad_steps=2)
    assert len(opt._fused_gens) == 1
    opt.optimize_fused(meta_steps=1, grad_steps=2, last_grad_steps=2,
                       active=True)
    assert len(opt._fused_gens) == 2


# --------------------------------------------------------------------- #
# the fused BasinCMA driver                                               #
# --------------------------------------------------------------------- #

def _basin(target, tm, **kwargs):
    return BasinCMAOptimizer(tm, make_vm(target), loss_fn, device="cpu",
                             track_variables=False, **kwargs)


def _outcome(opt, variables):
    return ([t.clone() for t in opt.cma_state],
            variables["input"]["z"].detach().clone(),
            torch.as_tensor(np.asarray(opt.loss)))


def _assert_same(a, b):
    for x, y in zip(a[0], b[0]):
        assert torch.equal(x, y)
    assert torch.equal(a[1], b[1])
    assert torch.equal(a[2], b[2])


def test_fused_basincma_resume_matches_uninterrupted(toys, tmp_path):
    _, tm, target = toys
    full = _basin(target, tm)
    v, _, _ = full.optimize_fused(meta_steps=4, grad_steps=3,
                                  last_grad_steps=5)
    want = _outcome(full, v)

    ckpt = str(tmp_path / "fused.npz")
    part = _basin(target, tm)     # two generations, then the run "crashes"
    part.optimize_fused(meta_steps=2, grad_steps=3, last_grad_steps=5,
                        checkpoint_path=ckpt)
    res = _basin(target, tm)
    v, _, _ = res.optimize_fused(meta_steps=4, grad_steps=3,
                                 last_grad_steps=5, checkpoint_path=ckpt)
    assert len(res.losses) == 2                 # generations 2 and 3
    assert res.losses == full.losses[2:]
    _assert_same(_outcome(res, v), want)


def test_fused_basincma_resumes_its_final_run(toys, tmp_path, monkeypatch):
    _, tm, target = toys
    full = _basin(target, tm, segment_steps=2)
    v, _, _ = full.optimize_fused(meta_steps=2, grad_steps=2,
                                  last_grad_steps=7)
    want = _outcome(full, v)

    ckpt = str(tmp_path / "final.npz")
    real = ExecutionCore._run_steps
    calls = {"n": 0}

    def flaky(self, *a, **k):
        calls["n"] += 1
        if calls["n"] == 2 + 3:           # the third segment of the final
            raise RuntimeError("injected crash")
        return real(self, *a, **k)

    monkeypatch.setattr(ExecutionCore, "_run_steps", flaky)
    with pytest.raises(RuntimeError, match="injected crash"):
        _basin(target, tm, segment_steps=2).optimize_fused(
            meta_steps=2, grad_steps=2, last_grad_steps=7,
            checkpoint_path=ckpt)
    monkeypatch.setattr(ExecutionCore, "_run_steps", real)
    res = _basin(target, tm, segment_steps=2)
    v, _, _ = res.optimize_fused(meta_steps=2, grad_steps=2,
                                 last_grad_steps=7, checkpoint_path=ckpt)
    assert res.gen_seconds == []                # the meta loop was done
    _assert_same(_outcome(res, v), want)


def test_fused_basincma_records_loss_curve_one_behind(toys):
    _, tm, target = toys
    opt = _basin(target, tm)
    opt.optimize_fused(meta_steps=5, grad_steps=3, last_grad_steps=5,
                       progress_every=0)
    assert len(opt.losses) == 5 and len(opt.gen_seconds) == 5
    assert all(isinstance(v, float) and np.isfinite(v) for v in opt.losses)


def test_fused_basincma_returns_reference_convention(toys):
    _, tm, target = toys
    opt = _basin(target, tm)
    variables, outs, losses = opt.optimize_fused(meta_steps=1, grad_steps=2,
                                                 last_grad_steps=2)
    assert "input" in variables and "z" in variables["input"]
    assert outs[0].ndim == 3
    np.testing.assert_array_equal(outs[0], np.asarray(jax_to_grid(
        opt.out.numpy())))
    assert losses[-1][0] == 1 * 2 + 2
    assert losses[-1][1]["loss"].shape == (opt.num_samples,)


@pytest.mark.parametrize("mbs", [5, 4])
def test_fused_basincma_with_microbatch(toys, mbs):
    _, tm, target = toys
    runs = []
    for m in (None, mbs):
        opt = _basin(target, tm, max_batch_size=m)
        variables, _, losses = opt.optimize_fused(meta_steps=2, grad_steps=3,
                                                  last_grad_steps=4)
        assert np.isfinite(np.asarray(losses[-1][1]["loss"])).all()
        runs.append((variables["input"]["z"].detach(), opt.losses))
    # chunking is exact up to the order of the f32 sums
    torch.testing.assert_close(runs[0][0], runs[1][0], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(runs[0][1], runs[1][1], rtol=1e-5, atol=1e-6)


# --------------------------------------------------------------------- #
# CMAOptimizer.optimize_fused                                             #
# --------------------------------------------------------------------- #

def test_cma_fused_eval_only_converges(toys):
    _, tm, target = toys
    opt = CMAOptimizer(tm, make_vm(target), loss_fn, seed=3, device="cpu")
    opt.optimize_fused(meta_steps=30, grad_steps=0, progress_every=0)
    assert len(opt.losses) == 30
    assert min(opt.losses) < 0.25
    opt2 = CMAOptimizer(tm, make_vm(target), loss_fn, seed=3, device="cpu")
    opt2.optimize_fused(meta_steps=10, grad_steps=30, progress_every=0)
    assert float(np.min(np.asarray(opt2.loss))) < 0.25


def test_cma_fused_checkpoint_resume(toys, tmp_path):
    _, tm, target = toys
    path = str(tmp_path / "cma_fused.npz")

    def run(meta, ckpt):
        opt = CMAOptimizer(tm, make_vm(target), loss_fn, seed=7,
                           device="cpu")
        variables, _, _ = opt.optimize_fused(
            meta_steps=meta, grad_steps=5, progress_every=0,
            checkpoint_path=ckpt)
        return _outcome(opt, variables)

    run(3, path)                      # "crash" after 3 of 6 generations
    resumed = run(6, path)            # resumes at 3
    _assert_same(resumed, run(6, None))


# --------------------------------------------------------------------- #
# logging, tracking and the result convention                             #
# --------------------------------------------------------------------- #

def test_log_mode_collects_curve_and_frames(toys):
    _, tm, target = toys
    opt = GradientOptimizer(tm, make_vm(target, grad_free=False), loss_fn,
                            log=True, device="cpu")
    opt.log_resize_factor = 0.5
    variables, outs, losses = opt.optimize(num_samples=2, grad_steps=20)
    assert [it for it, _ in losses] == [5, 10, 15, 20]
    assert len(outs) == 4 and outs[0].dtype == np.uint8
    assert outs[0].shape == (10, 19, 3)       # the 2-wide collage, halved
    assert losses[-1][1]["loss"].min() < losses[0][1]["loss"].min()


def test_tracked_variables(toys):
    _, tm, target = toys
    opt = GradientOptimizer(tm, make_vm(target, grad_free=False), loss_fn,
                            track_variables=True, device="cpu")
    variables, _, _ = opt.optimize(num_samples=2, grad_steps=10)
    assert opt.tracked["z"].shape == (10, 2, Z_DIM)
    np.testing.assert_array_equal(opt.tracked["z"][-1],
                                  variables["input"]["z"].detach().numpy())


def test_final_results_collage_matches_jax(toys):
    jm, tm, target = toys
    jvm = JaxVariableManager(seed=0)
    jvm.register("z", shape=(Z_DIM,), learning_rate=0.05)
    jvm.register("target", shape=(RES, RES, 3), var_type="output",
                 requires_grad=False, default=jnp.asarray(target))
    jopt = JaxCMAOptimizer(jm, jvm, JLF.l1_loss)
    opt = CMAOptimizer(tm, make_vm(target), loss_fn, device="cpu")
    images = np.random.RandomState(0).uniform(
        -1, 1, (7, RES, RES, 3)).astype(np.float32)
    for o in (jopt, opt):
        o.out, o.loss = images, np.zeros(7, np.float32)
    _, jouts, _ = jopt._final_results({}, 3)
    _, outs, losses = opt._final_results({}, 3)
    assert outs[0].shape == (3 * 18 + 2, 3 * 18 + 2, 3)
    np.testing.assert_array_equal(outs[0], np.asarray(jouts[0]))
    assert losses == [[3, {"loss": opt.loss}]]


class TestNonImageModelOutput:
    """Vector outputs: no collage, and in log mode no benchmark either."""

    def _setup(self, log):
        d_out = 24
        W = torch.tensor(np.random.RandomState(3).randn(Z_DIM, d_out)
                         .astype(np.float32) / 2.0)
        target = torch.tensor(np.random.RandomState(4).randn(Z_DIM)
                              .astype(np.float32)) @ W
        vm = VariableManager(seed=0, device="cpu")
        vm.register("z", shape=(Z_DIM,), grad_free=True,
                    distribution=distribution.TruncatedNormalModulo(1.0, 2.0))
        vm.register("target", shape=(d_out,), var_type="output",
                    requires_grad=False, default=target)
        return CMAOptimizer(lambda z: z @ W, vm,
                            lambda out, target: ((out - target) ** 2).mean(-1),
                            log=log, device="cpu")

    def test_fused_returns_raw_outputs(self):
        opt = self._setup(log=False)
        _, outs, losses = opt.optimize_fused(meta_steps=8, grad_steps=0)
        assert np.asarray(outs[0]).ndim == 2        # raw [pop, d_out]
        assert np.isfinite(losses[-1][1]["loss"]).all()

    def test_host_loop_log_mode_skips_collage_and_benchmark(self):
        opt = self._setup(log=True)

        class Refuses:
            def evaluate(self, *args):
                raise AssertionError("a benchmark scores images only")

        opt.register_benchmark(Refuses())
        _, outs, losses = opt.optimize(meta_steps=6, grad_steps=0)
        assert [it for it, _ in losses] == [5]      # log_iter 5
        assert all(o.ndim == 2 for o in outs)


def test_benchmark_result_is_logged(toys):
    _, tm, target = toys

    class Bench:
        def evaluate(self, out, target, weight):
            assert target.shape == (1, RES, RES, 3)
            return {"score": float(out.mean())}

    opt = GradientOptimizer(tm, make_vm(target, grad_free=False), loss_fn,
                            log=True, device="cpu")
    opt.register_benchmark(Bench())
    _, _, losses = opt.optimize(num_samples=2, grad_steps=5)
    assert list(losses[0][1]) == ["score"]


def test_step_api_keeps_its_optimizer(toys):
    _, tm, target = toys
    vm = make_vm(target, grad_free=False)
    opt = GradientOptimizer(tm, vm, loss_fn, device="cpu")
    variables = vm.initialize(3, generator=opt.generator)
    losses = []
    for _ in range(4):
        variables, out, loss = opt.step(variables)
        losses.append(loss.mean())
    assert out.shape == (3, RES, RES, 3) and losses[-1] < losses[0]
    _, _, loss = opt.step(variables, optimize=False)
    assert loss.shape == (3,)
