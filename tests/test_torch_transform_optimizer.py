"""The port's transform search against the JAX package's
(``tests/test_e2e_parity_transform.py``, ``tests/test_transforms.py``
TestTransformBasinCMA and TestFusedTransformBasinCMA).

- One generation of the search with injected Δt, z and c through
  BigGAN-deep-128 at channel width 8, population 5 in microbatches of 2, 3
  inner Adam steps on (z, c) against the per-sample warped targets, then the
  tell in the un-warped frame, given the warped targets' loss context (which
  that frame must not use): per-step warped-frame losses and the tell agree
  with the JAX package's at rtol 2e-3, atol 2e-5, under ``masked_l1`` and
  under ProjectionLoss.
- BasinCMA, CMA and Gradient with registered transforms run, and their
  un-warped tell equals the JAX package's ``core.tell_loss(inverted=True)``
  on the same variables.
- Variable propagation against the JAX package's formulas on the same noise
  (drawn from a clone of the port's generator), a non-finite candidate
  losing the EMA; ``get_candidate`` is None when no loss was finite.
- On the toy model: the alignment search recovers a shift through both
  drivers; the fused and host-loop drivers give equal tell losses for one
  seed; a resumed search equals the uninterrupted one for both drivers, and
  re-running a finished fused search runs no step.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pix2latent_tpu.loss_functions as JLF
import pix2latent_tpu.transform as JT
import pix2latent_tpu_torch.loss_functions as LF
import pix2latent_tpu_torch.transform as T
from pix2latent_tpu import VariableManager as JaxVariableManager
from pix2latent_tpu import hooks as jax_hooks
from pix2latent_tpu.losses.lpips import convert_torch_lpips
from pix2latent_tpu.models.biggan import BigGAN as JaxBigGAN
from pix2latent_tpu.models.biggan import convert_torch_biggan
from pix2latent_tpu.models.toy import make_toy_model as jax_toy
from pix2latent_tpu.optimizers import GradientOptimizer as JaxGradient
from pix2latent_tpu.utils.params_io import _flatten
from pix2latent_tpu_torch import VariableManager, hooks
from pix2latent_tpu_torch.models.biggan import BigGAN
from pix2latent_tpu_torch.models.toy import ToyGenerator
from pix2latent_tpu_torch.optimizers import (BasinCMAOptimizer, CMAOptimizer,
                                             GradientOptimizer)
from pix2latent_tpu_torch.utils.params_io import from_jax_params
from test_biggan_golden import make_state_dict
from test_lpips_golden import make_alex_state_dict

POP, N_STEPS, MBS = 5, 3, 2
VERSION, CH, RES = "biggan-deep-128", 8, 128
LR_Z, LR_C, BETA = 0.05, 0.01, 10.0
SENSITIVITY = 0.1
DEFAULT_T = (1.0, 0.0, 0.0)
Z_DIM, TOY_RES = 8, 16


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _to_jax(variables):
    return {vt: {k: jnp.asarray(_np(v)) for k, v in d.items()}
            for vt, d in variables.items()}


# --------------------------------------------------------------------- #
# one generation through BigGAN-deep-128 against the JAX package          #
# --------------------------------------------------------------------- #

@pytest.mark.parametrize("loss", ["masked_l1", "projection"])
def test_transform_generation_matches_jax(loss):
    rng = np.random.RandomState(11)
    gparams = convert_torch_biggan(make_state_dict(rng, VERSION, CH), VERSION)
    jm = JaxBigGAN(VERSION, params=gparams, channel_width=CH)
    onehot = np.zeros((1, 1000), np.float32)
    onehot[0, 153] = 1.0
    c_star = np.asarray(jm.get_class_embedding(jnp.asarray(onehot)))
    z_star = rng.randn(1, 128).astype(np.float32) * 0.5
    target = np.asarray(jm(z=jnp.asarray(z_star), c=jnp.asarray(c_star)))[0]
    # the injected ask: per-sample transform deltas and latent starts
    dt = rng.randn(POP, 3).astype(np.float32)
    z0 = (rng.randn(POP, 128) * 0.5).astype(np.float32)
    c0 = np.repeat(c_star, POP, 0)
    weight = np.ones((RES, RES, 3), np.float32)
    weight[:, :RES // 4] = 0.5                # binarized to 0 in the tell
    if loss == "masked_l1":
        jloss = lambda out, target, weight: JLF.masked_l1_loss(  # noqa: E731
            out, target, weight)
        tloss = lambda out, target, weight: LF.masked_l1_loss(  # noqa: E731
            out, target, weight)
    else:
        lparams = convert_torch_lpips(make_alex_state_dict(rng), net="alex")
        jloss = JLF.ProjectionLoss("alex", beta=BETA, lpips_params=lparams)
        tloss = LF.ProjectionLoss("alex", beta=BETA, lpips_params=lparams,
                                  device="cpu")

    def register(vm, target, weight, zeros):
        vm.register("z", shape=(128,), var_type="input", learning_rate=LR_Z)
        vm.register("c", shape=(128,), var_type="input", learning_rate=LR_C)
        vm.register("target", shape=(RES, RES, 3), var_type="output",
                    requires_grad=False, default=target)
        vm.register("weight", shape=(RES, RES, 3), var_type="output",
                    requires_grad=False, default=weight)
        vm.register("t", shape=(3,), var_type="transform",
                    requires_grad=False, default=zeros)

    # ------------------------- JAX package ------------------------------ #
    jvm = JaxVariableManager(seed=0)
    register(jvm, jnp.asarray(target), jnp.asarray(weight), jnp.zeros(3))
    jopt = JaxGradient(jm, jvm, jloss, max_batch_size=MBS,
                       track_variables=False)
    warp = JT.SpatialTransform(t=DEFAULT_T, sensitivity=SENSITIVITY)
    jopt.register_transform(warp, "t", "target")
    jopt.register_transform(warp, "t", "weight")
    jcore = jopt.core
    jv = jvm.initialize(num_samples=POP, key=jax.random.PRNGKey(1))
    jv["input"]["z"], jv["input"]["c"] = jnp.asarray(z0), jnp.asarray(c0)
    jv["transform"]["t"] = jnp.asarray(dt)
    jv = jcore.apply_transforms(jv)
    want_warped = {k: np.asarray(a) for k, a in jv["output"].items()}
    jv, _, _, ys = jcore.grad_steps(jv, jcore.init_opt_state(jv),
                                    jax.random.PRNGKey(2), N_STEPS)
    want_inner = np.asarray(ys["loss"])
    want_tell = np.asarray(jcore.tell_loss(jv, jax.random.PRNGKey(3),
                                           N_STEPS, inverted=True))

    # ------------------------- the port --------------------------------- #
    vm = VariableManager(seed=0, device="cpu")
    register(vm, target, weight, np.zeros(3, np.float32))
    tm = BigGAN(VERSION, params=_flatten(gparams), channel_width=CH,
                device="cpu")
    opt = GradientOptimizer(tm, vm, tloss, max_batch_size=MBS,
                            track_variables=False, device="cpu")
    twarp = T.SpatialTransform(t=DEFAULT_T, sensitivity=SENSITIVITY,
                               device="cpu")
    opt.register_transform(twarp, "t", "target")
    opt.register_transform(twarp, "t", "weight")
    core = opt.core
    v = vm.initialize(POP)
    v["input"]["z"], v["input"]["c"] = torch.tensor(z0), torch.tensor(c0)
    v["transform"]["t"] = torch.tensor(dt)
    v = core._dedupe_outputs(core.apply_transforms(v))
    for name, want in want_warped.items():     # the per-sample warped targets
        assert v["output"][name].shape == (POP, RES, RES, 3)
        np.testing.assert_allclose(_np(v["output"][name]), want, atol=1e-5)
    ctx = core.make_ctx(v)
    assert (ctx is not None) == (loss == "projection")
    v, optimizer = core.init_opt_state(v)
    v, _, _, ys = core.grad_steps(v, optimizer, opt.generator, N_STEPS,
                                  ctx=ctx)
    got_inner = _np(ys["loss"])
    # the tell is given the warped targets' context, which it must not use
    got_tell = _np(core.tell_loss(v, opt.generator, N_STEPS, ctx=ctx))

    assert got_inner.shape == (N_STEPS, POP) and got_tell.shape == (POP,)
    for step in range(N_STEPS):
        np.testing.assert_allclose(
            got_inner[step], want_inner[step], rtol=2e-3, atol=2e-5,
            err_msg=f"warped-frame loss diverged at step {step}")
    np.testing.assert_allclose(got_tell, want_tell, rtol=2e-3, atol=2e-5,
                               err_msg="un-warped tell diverged")
    assert want_inner[-1].mean() < want_inner[0].mean()     # not vacuous
    assert not np.allclose(got_tell, got_inner[-1], rtol=0.05)
    warped = _np(core.tell_loss(v, opt.generator, N_STEPS, inverted=False,
                                ctx=ctx))
    assert not np.allclose(got_tell, warped, rtol=0.05)


# --------------------------------------------------------------------- #
# the toy problems                                                        #
# --------------------------------------------------------------------- #

@pytest.fixture(scope="module")
def toys():
    jm = jax_toy(z_dim=Z_DIM, res=TOY_RES, width=16, seed=0)
    tm = ToyGenerator(z_dim=Z_DIM, res=TOY_RES, width=16)
    tm.load_state_dict(from_jax_params(_flatten(jm.params)), strict=True)
    tm.requires_grad_(False)
    z_true = np.random.RandomState(3).randn(1, Z_DIM).astype(np.float32)
    clean = np.asarray(jm(z=jnp.asarray(z_true)))
    shifted = np.asarray(JT.SpatialTransform(sensitivity=1.0).transform(
        jnp.asarray(clean), jnp.asarray([[1.0, 0.4, 0.0]])))[0]
    return jm, tm, shifted


def _toy_search(tm, target, seed=0):
    """The JAX package's toy alignment problem on the port."""
    vm = VariableManager(seed=0, device="cpu")
    vm.register("z", shape=(Z_DIM,), var_type="input", learning_rate=0.05)
    vm.register("target", shape=(TOY_RES, TOY_RES, 3), var_type="output",
                requires_grad=False, default=target)
    vm.register("weight", shape=(TOY_RES, TOY_RES, 3), var_type="output",
                requires_grad=False,
                default=np.ones((TOY_RES, TOY_RES, 3), np.float32))
    vm.register("t", shape=(3,), var_type="transform", requires_grad=False,
                grad_free=(np.array([1.0, 0, 0]), 0.3))
    opt = T.TransformBasinCMAOptimizer(
        tm, vm, lambda out, target, weight: LF.masked_l1_loss(
            out, target, weight), seed=seed, device="cpu")
    opt.register_transform(T.SpatialTransform(sensitivity=1.0, device="cpu"),
                           "t", "target")
    opt.register_transform(T.SpatialTransform(sensitivity=1.0, device="cpu"),
                           "t", "weight")
    opt.set_variable_propagation("z")
    return opt


@pytest.mark.parametrize("fused", [False, True])
def test_alignment_search_recovers_shift(toys, fused):
    _, tm, shifted = toys
    opt = _toy_search(tm, shifted)
    drive = opt.optimize_fused if fused else opt.optimize
    variables, (outs, targets, candidate_out), loss = drive(meta_steps=6,
                                                            grad_steps=8)
    candidate = opt.get_candidate()
    assert candidate is not None and candidate.shape == (3,)
    assert opt._best_loss < 0.2
    assert len(opt.losses) == 6 and all(map(math.isfinite, opt.losses))
    assert min(opt.losses) == pytest.approx(opt._best_loss)
    assert tuple(candidate_out.shape) == (TOY_RES, TOY_RES, 3)
    assert outs[0].ndim == 3 and targets[0].ndim == 3
    assert np.isfinite(outs[0]).all()
    assert loss.shape == (opt.num_samples,) and np.isfinite(loss).any()
    assert "z" in opt.vp_means
    # self.loss is the warped frame's, the tell the un-warped frame's
    assert not np.allclose(loss, opt.final_tell, rtol=0.05)
    if not fused:
        assert len(opt.transform_tracked) == 6


def test_fused_and_host_loop_give_equal_tell_losses(toys):
    _, tm, shifted = toys
    host, fused = _toy_search(tm, shifted, 5), _toy_search(tm, shifted, 5)
    host.optimize(meta_steps=4, grad_steps=3)
    fused.optimize_fused(meta_steps=4, grad_steps=3)
    np.testing.assert_allclose(fused.losses, host.losses, rtol=1e-6)
    np.testing.assert_allclose(fused.final_tell, host.final_tell, rtol=1e-6)
    np.testing.assert_allclose(fused.loss, host.loss, rtol=1e-6)
    np.testing.assert_allclose(fused.get_candidate(), host.get_candidate(),
                               rtol=1e-6)
    np.testing.assert_allclose(_np(fused.vp_means["z"]),
                               _np(host.vp_means["z"]), rtol=1e-5, atol=1e-7)
    for a, b in zip(fused.cma_state, host.cma_state):
        np.testing.assert_allclose(_np(a), _np(b), rtol=1e-6, atol=1e-7)



def test_host_loop_logs_each_run_and_warped_target(toys):
    # the host loop's generation logs every log_iter steps, records the
    # asked t and the warped targets, and runs a shorter last generation
    _, tm, shifted = toys
    opt = _toy_search(tm, shifted)
    opt.log, opt.log_iter = True, 2
    variables, (outs, targets, candidate_out), losses = opt.optimize(
        meta_steps=3, grad_steps=4, last_grad_steps=2)
    assert [entry[0] for entry in losses] == [2, 4, 6, 8, 10]
    assert len(outs) == 5 and all(o.dtype == np.uint8 for o in outs)
    assert len(targets) == 3 and len(opt.transform_tracked) == 3
    assert opt.gen_seconds and len(opt.gen_seconds) == 3
    for t, tracked in zip(opt.transform_tracked[1:],
                          opt.transform_tracked[:-1]):
        assert t.shape == (opt.num_samples, 3)
        assert not np.array_equal(t, tracked)
    assert tuple(candidate_out.shape) == (TOY_RES, TOY_RES, 3)
    assert opt.loss.shape == (opt.num_samples,)
    assert opt.get_candidate() is not None

def _interrupt(monkeypatch, at_gen):
    """Make the search raise KeyboardInterrupt as generation ``at_gen``
    starts (once)."""
    orig = T.TransformBasinCMAOptimizer._run_generation
    state = {"armed": True}

    def run(self, carry, gen_idx, *args, **kwargs):
        if state["armed"] and gen_idx == at_gen:
            state["armed"] = False
            raise KeyboardInterrupt
        return orig(self, carry, gen_idx, *args, **kwargs)

    monkeypatch.setattr(T.TransformBasinCMAOptimizer, "_run_generation", run)


def _same_search(a, b, same_loss=True):
    np.testing.assert_array_equal(a.final_tell, b.final_tell)
    if same_loss:
        np.testing.assert_array_equal(a.loss, b.loss)
    np.testing.assert_array_equal(a.get_candidate(), b.get_candidate())
    assert a._best_loss == b._best_loss
    np.testing.assert_array_equal(_np(a.vp_means["z"]), _np(b.vp_means["z"]))
    for x, y in zip(a.cma_state, b.cma_state):
        np.testing.assert_array_equal(_np(x), _np(y))


@pytest.mark.parametrize("at_gen", [2, 3])
def test_fused_resume_equals_the_uninterrupted_search(toys, tmp_path,
                                                      monkeypatch, at_gen):
    _, tm, shifted = toys
    full = _toy_search(tm, shifted)
    full.optimize_fused(meta_steps=4, grad_steps=3)

    ckpt = str(tmp_path / "search.npz")
    part = _toy_search(tm, shifted)
    with monkeypatch.context() as m:
        _interrupt(m, at_gen)           # 3: the last, tell-less generation
        with pytest.raises(KeyboardInterrupt):
            part.optimize_fused(meta_steps=4, grad_steps=3,
                                checkpoint_path=ckpt)
    res = _toy_search(tm, shifted)
    res.optimize_fused(meta_steps=4, grad_steps=3, checkpoint_path=ckpt)
    _same_search(res, full)
    assert res.losses == full.losses[len(full.losses) - len(res.losses):]

    # a finished search runs no step again: one evaluation (whose
    # warped-frame loss, after the last step, is self.loss), the tell and
    # the re-rendering
    again = _toy_search(tm, shifted)
    steps = []
    orig = again.core._forward_backward
    monkeypatch.setattr(again.core, "_forward_backward",
                        lambda *a, **k: steps.append(1) or orig(*a, **k))
    again.optimize_fused(meta_steps=4, grad_steps=3, checkpoint_path=ckpt)
    assert steps == [] and again.gen_seconds and len(again.losses) == 1
    _same_search(again, full, same_loss=False)


def test_host_loop_resume_equals_the_uninterrupted_search(toys, tmp_path,
                                                          monkeypatch):
    _, tm, shifted = toys
    full = _toy_search(tm, shifted)
    full.optimize(meta_steps=4, grad_steps=3)

    ckpt = str(tmp_path / "search.npz")
    part = _toy_search(tm, shifted)
    calls = {"n": 0}
    orig = part.core.tell_loss

    def dies_in_generation_2(*args, **kwargs):
        calls["n"] += 1
        if calls["n"] == 3:
            raise KeyboardInterrupt
        return orig(*args, **kwargs)

    monkeypatch.setattr(part.core, "tell_loss", dies_in_generation_2)
    with pytest.raises(KeyboardInterrupt):
        part.optimize(meta_steps=4, grad_steps=3, checkpoint_path=ckpt)
    res = _toy_search(tm, shifted)
    res.optimize(meta_steps=4, grad_steps=3, checkpoint_path=ckpt)
    _same_search(res, full)
    assert res.losses == full.losses[2:]
    assert len(res.transform_tracked) == 2


def test_get_candidate_is_none_without_a_finite_loss(toys, tmp_path):
    _, tm, shifted = toys
    opt = _toy_search(tm, shifted)
    opt.loss_fn = opt.core.loss_fn = \
        lambda out, target, weight: out.sum((1, 2, 3)) * math.nan
    opt.optimize(meta_steps=2, grad_steps=1,
                 checkpoint_path=str(tmp_path / "nan.npz"))
    assert opt._candidate is not None          # the checkpoint's placeholder
    assert opt.get_candidate() is None
    opt.optimize_fused(meta_steps=2, grad_steps=1)
    assert opt.get_candidate() is None and opt._best_loss == math.inf


def test_propagation_bookkeeping(toys):
    _, tm, shifted = toys
    opt = _toy_search(tm, shifted)
    opt.set_variable_propagation("z")          # a duplicate: not added again
    assert opt.variables_to_propagate == ["z"]
    opt.set_variable_propagation("nope")
    with pytest.raises(RuntimeError, match="nope"):
        opt.optimize(meta_steps=2, grad_steps=1)
    with pytest.raises(RuntimeError, match="nope"):
        opt.optimize_fused(meta_steps=2, grad_steps=1)
    opt.del_variable_propagation("nope")
    assert opt.variables_to_propagate == ["z"]


def test_propagation_matches_jax_formulas(toys, monkeypatch):
    jm, tm, shifted = toys
    rng = np.random.RandomState(21)
    pop = 7
    data = rng.randn(pop, Z_DIM).astype(np.float32)
    loss = rng.rand(pop).astype(np.float32)
    best = int(loss.argmin())
    loss[best] = np.nan                        # the smallest, but not finite
    loss[(best + 1) % pop] = -np.inf
    mean0 = rng.randn(Z_DIM).astype(np.float32)

    jvm = JaxVariableManager(seed=0)
    jvm.register("z", shape=(Z_DIM,), var_type="input")
    jvm.register("target", shape=(TOY_RES, TOY_RES, 3), var_type="output",
                 requires_grad=False, default=jnp.asarray(shifted))
    jvm.register("t", shape=(3,), var_type="transform", requires_grad=False,
                 grad_free=True)
    jopt = JT.TransformBasinCMAOptimizer(
        jm, jvm, lambda out, target: JLF.l1_loss(out, target))
    jopt.set_variable_propagation("z")
    opt = _toy_search(tm, shifted)

    # the EMA toward the best finite sample, from the population mean
    for o, d, l in ((jopt, jnp.asarray(data), loss), (opt, torch.tensor(data),
                                                       torch.tensor(loss))):
        o.update_propagation_variable_statistic({"input": {"z": d}}, l)
        o.update_propagation_variable_statistic({"input": {"z": d * 0.5}}, l)
    np.testing.assert_allclose(_np(opt.vp_means["z"]),
                               np.asarray(jopt.vp_means["z"]), rtol=1e-6,
                               atol=1e-7)

    # the resampling, on the port's next noise
    jopt.vp_means["z"] = jnp.asarray(mean0)
    opt.vp_means["z"] = torch.tensor(mean0)
    start = opt.generator.get_state()
    clone = torch.Generator()
    clone.set_state(start)
    noise = torch.randn((pop, Z_DIM), generator=clone).numpy()
    monkeypatch.setattr(jax.random, "normal",
                        lambda key, shape, dtype: jnp.asarray(noise, dtype))
    for renormalize in (True, False):
        opt.generator.set_state(start)
        got = opt.propagate_variable({"input": {"z": torch.tensor(data)}},
                                     2, 5, magnitude=0.7,
                                     renormalize=renormalize)
        want = jopt.propagate_variable({"input": {"z": jnp.asarray(data)}},
                                       2, 5, magnitude=0.7,
                                       renormalize=renormalize)
        np.testing.assert_allclose(_np(got["input"]["z"]),
                                   np.asarray(want["input"]["z"]),
                                   rtol=1e-5, atol=1e-6)
        z = _np(got["input"]["z"])
        if renormalize:              # per sample: mean 0, ddof-1 std 1
            np.testing.assert_allclose(z.std(1, ddof=1), 1.0, rtol=1e-5)
            np.testing.assert_allclose(z.mean(1), 0.0, atol=1e-6)
        else:
            np.testing.assert_allclose(z, mean0 + 0.7 * 0.6 * noise,
                                       rtol=1e-6, atol=1e-6)


# --------------------------------------------------------------------- #
# the other drivers with registered transforms                            #
# --------------------------------------------------------------------- #

def _driver_problem(jm, tm, target, compose):
    """The same toy problem registered on both packages, the target and the
    weight warped by ``t`` (spatial, or spatial + hue with the weight
    warped by the spatial part only)."""
    def register(vm, target, weight, clamp, mu):
        vm.register("z", shape=(Z_DIM,), var_type="input", grad_free=True,
                    learning_rate=0.05, hook_fn=clamp)
        vm.register("target", shape=(TOY_RES, TOY_RES, 3), var_type="output",
                    requires_grad=False, default=target)
        vm.register("weight", shape=(TOY_RES, TOY_RES, 3), var_type="output",
                    requires_grad=False, default=weight)
        vm.register("t", shape=mu.shape, var_type="transform",
                    requires_grad=False, default=mu)

    weight = np.ones((TOY_RES, TOY_RES, 3), np.float32)
    weight[:3] = 0.4
    if compose:
        fn, t = T.setup_transform_fn(spatial_transform=True,
                                     color_transform=("hue",), device="cpu")
        jfn, _ = JT.setup_transform_fn(spatial_transform=True,
                                       color_transform=("hue",))
        tfs, jtfs = (fn, T.SpatialOnly(fn)), (jfn, JT.SpatialOnly(jfn))
        mu = np.array([0.3, -0.5, 0.2, 0.4], np.float32)
    else:
        tfs = (T.SpatialTransform(device="cpu"),) * 2
        jtfs = (JT.SpatialTransform(),) * 2
        mu = np.array([0.5, 1.5, -0.8], np.float32)
    jvm = JaxVariableManager(seed=0)
    register(jvm, jnp.asarray(target), jnp.asarray(weight),
             jax_hooks.Clamp(2.0), jnp.asarray(mu))
    vm = VariableManager(seed=0, device="cpu")
    register(vm, target, weight, hooks.Clamp(2.0), mu)
    return jvm, vm, tfs, jtfs


@pytest.mark.parametrize("compose", [False, True])
@pytest.mark.parametrize("driver", ["basincma", "cma", "adam"])
def test_drivers_with_transforms_tell_as_jax(toys, driver, compose):
    jm, tm, shifted = toys
    jvm, vm, tfs, jtfs = _driver_problem(jm, tm, shifted, compose)

    def loss(out, target, weight):
        return LF.masked_l1_loss(out, target, weight)

    drv = {"basincma": BasinCMAOptimizer, "cma": CMAOptimizer,
           "adam": GradientOptimizer}[driver]
    opt = drv(tm, vm, loss, max_batch_size=4, device="cpu")
    for fn, name in zip(tfs, ("target", "weight")):
        opt.register_transform(fn, "t", name)
    if driver == "basincma":
        variables, _, _ = opt.optimize(2, 2, last_grad_steps=2)
        assert len(opt.losses) == 2 and all(map(math.isfinite, opt.losses))
    elif driver == "cma":
        variables, _, _ = opt.optimize(2, grad_steps=2)
        assert len(opt.losses) == 2 and all(map(math.isfinite, opt.losses))
    else:
        variables, _, _ = opt.optimize(num_samples=6, grad_steps=3)
    got = _np(opt.core.tell_loss(variables, opt.generator, 7))

    jopt = JaxGradient(jm, jvm, lambda out, target, weight: JLF.masked_l1_loss(
        out, target, weight), max_batch_size=4)
    for fn, name in zip(jtfs, ("target", "weight")):
        jopt.register_transform(fn, "t", name)
    want = np.asarray(jopt.core.tell_loss(_to_jax(variables),
                                          jax.random.PRNGKey(0), 7,
                                          inverted=True))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    warped = _np(opt.core.tell_loss(variables, opt.generator, 7,
                                    inverted=False))
    assert not np.allclose(got, warped, rtol=0.05)
