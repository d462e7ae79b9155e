"""Batched inversion in the port against the JAX package, on its toy
generator with the JAX weights (numpy-seeded inputs):

- the stacked CMA ``tell`` over M states equals ``jax.vmap(cma.tell)``:
  ``C``, ``mean``, ``sigma`` and the paths within 1e-5 (eigenvector signs
  may differ), and the single-state ``ask`` / ``tell`` are unchanged;
- one ``BatchedBasinCMAOptimizer`` generation fed the JAX driver's asked
  candidates equals the JAX generation in float32 (tell losses, refined
  rows and the M new CMA states within rel 1e-4), with a learnable input;
- the contracts of the JAX package's ``tests/test_optimizers.py``
  (``TestBatchedBasinCMA``) and ``tests/test_two_phase.py``: independent
  searches, chunked equals plain, resume runs no finished generation, the
  segmented final equals one run, the un-warped tells;
- ``TransformBasinCMAOptimizer.optimize_fused_batched`` equals M solo
  ``optimize_fused`` runs of the port (``tests/test_transform_batched.py``:
  same candidates and best losses, the per-search shifts recovered, resume).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pix2latent_tpu.loss_functions as JLF
import pix2latent_tpu_torch.loss_functions as LF
from pix2latent_tpu.models.toy import make_toy_model as jax_toy
from pix2latent_tpu.optimizers.batched import \
    BatchedBasinCMAOptimizer as JaxBatched
from pix2latent_tpu.strategies import cma as jcma
from pix2latent_tpu.utils.params_io import _flatten
from pix2latent_tpu_torch import VariableManager
from pix2latent_tpu_torch.models.toy import ToyGenerator
from pix2latent_tpu_torch.optimizers import BatchedBasinCMAOptimizer
from pix2latent_tpu_torch.strategies import cma
from pix2latent_tpu_torch.transform import (SpatialTransform,
                                            TransformBasinCMAOptimizer)
from pix2latent_tpu_torch.utils.params_io import from_jax_params
from tests.test_torch_examples import one_thread  # noqa: F401

ZD, RES, C_DIM = 8, 16, 4
T_FROZEN = np.array([1.0, 0.25, -0.1], np.float32)


def _pair(c_dim=0):
    jm = jax_toy(z_dim=ZD, c_dim=c_dim, res=RES, width=16, seed=2)
    tm = ToyGenerator(z_dim=ZD, c_dim=c_dim, res=RES, width=16)
    tm.load_state_dict(from_jax_params(_flatten(jm.params)), strict=True)
    return jm, tm.requires_grad_(False)


@pytest.fixture(scope="module")
def toy():
    return _pair()[1]


def _targets(model, m, seed):
    z = torch.tensor(np.random.RandomState(seed).randn(m, ZD).astype(
        np.float32))
    with torch.no_grad():
        return model(z)


def _l1(out, target):
    return LF.l1_loss(out, target)


def _opt(model, **kw):
    kw.setdefault("popsize", 8)
    return BatchedBasinCMAOptimizer(model, kw.pop("loss", _l1), z_dim=ZD,
                                    device="cpu", **kw)


# --------------------------------------------------------------------- #
# the stacked CMA                                                         #
# --------------------------------------------------------------------- #

@pytest.mark.parametrize("active", [False, True])
def test_stacked_tell_matches_jax_vmap(active):
    m, n, pop = 3, 6, 10
    rng = np.random.RandomState(0)
    jparams, jstate = jcma.init(np.zeros(n), 0.7, pop, active=active)
    tparams, tstate = cma.init(np.zeros(n), 0.7, pop, active=active,
                               device="cpu")
    jstates = jax.tree.map(lambda a: jnp.broadcast_to(a, (m, *a.shape)),
                           jstate)
    tstates = cma.stack_states(tstate, m)
    for _ in range(3):
        x = (rng.randn(m, pop, n) * 0.7).astype(np.float32)
        f = rng.rand(m, pop).astype(np.float32)
        f[1, 2] = np.nan                         # a non-finite fitness
        jstates = jax.vmap(lambda s, xi, fi: jcma.tell(jparams, s, xi, fi))(
            jstates, jnp.asarray(x), jnp.asarray(f))
        tstates = cma.tell(tparams, tstates, torch.tensor(x), torch.tensor(f))
        for name in ("mean", "sigma", "C", "p_sigma", "p_c", "D"):
            np.testing.assert_allclose(
                getattr(tstates, name).numpy(),
                np.asarray(getattr(jstates, name)), rtol=1e-5, atol=1e-5,
                err_msg=name)
    # each stacked state is the single-state tell of its rows
    single = cma.tell(tparams, cma.CMAState(*(t[0] for t in tstates)),
                      torch.tensor(x[0]), torch.tensor(f[0]))
    np.testing.assert_allclose(single.C.numpy(),
                               cma.tell(tparams, tstates, torch.tensor(x),
                                        torch.tensor(f)).C[0].numpy(),
                               rtol=1e-6, atol=1e-7)


def test_stacked_ask_shapes_and_single_ask_unchanged():
    params, state = cma.init(np.zeros(5), 0.5, 7, device="cpu")
    g = torch.Generator().manual_seed(0)
    x = cma.ask(params, cma.stack_states(state, 3), g)
    assert tuple(x.shape) == (3, 7, 5)
    g1, g2 = torch.Generator().manual_seed(1), torch.Generator().manual_seed(1)
    a = cma.ask(params, state, g1)
    z = torch.randn((7, 5), generator=g2)
    np.testing.assert_array_equal(
        a.numpy(), (state.mean[None] + state.sigma * (
            (z * state.D[None]) @ state.B.T)).numpy())


# --------------------------------------------------------------------- #
# one generation against the JAX driver's                                 #
# --------------------------------------------------------------------- #

def test_generation_matches_jax_at_the_same_candidates():
    jm, tm = _pair(c_dim=C_DIM)
    m, pop, steps = 2, 8, 4
    rng = np.random.RandomState(4)
    z_true = rng.randn(m, ZD).astype(np.float32)
    c = rng.randn(m, C_DIM).astype(np.float32)
    targets = np.asarray(jm(z=jnp.asarray(z_true), c=jnp.asarray(c)))

    jopt = JaxBatched(jm, lambda out, target: JLF.l1_loss(out, target),
                      z_dim=ZD, popsize=pop, learnable_inputs={"c": 0.01})
    gen = jopt._build_generation(m, steps)
    _, state0 = jcma.init(np.zeros(ZD), 1.0, pop)
    jstates = jax.tree.map(lambda a: jnp.broadcast_to(a, (m, *a.shape)),
                           state0)
    data = {"targets": jnp.asarray(targets), "fixed": {"c": jnp.asarray(c)}}
    key = jax.random.PRNGKey(7)
    jstates2, jlearn, jloss, jmin = gen(jm.params, data, jstates, key,
                                        jnp.asarray(0, jnp.int32))
    # the candidates the JAX generation asked (its own key splits)
    k_ask, _ = jax.random.split(key)
    x = np.asarray(jax.vmap(lambda s, k: jcma.ask(jopt.cma_params, s, k))(
        jstates, jax.random.split(k_ask, m)))

    topt = _opt(tm, popsize=pop, learnable_inputs={"c": 0.01})
    tdata = {"targets": torch.tensor(targets), "fixed": {"c": torch.tensor(c)}}
    aux = topt._make_aux(tdata, m)
    _, tstate0 = cma.init(np.zeros(ZD), 1.0, pop, device="cpu")
    tstates2, tlearn, tloss, tmin = topt.generation(
        cma.stack_states(tstate0, m), tdata, aux, steps, 0,
        x=torch.tensor(x))
    # tolerance: rel 1e-4, float32 (Adam over 4 steps, XLA's fusion order)
    np.testing.assert_allclose(tloss.numpy(), np.asarray(jloss), rtol=1e-4,
                               atol=1e-6)
    np.testing.assert_allclose(tmin.numpy(), np.asarray(jmin), rtol=1e-4,
                               atol=1e-6)
    for name in ("z", "c"):
        np.testing.assert_allclose(tlearn[name].detach().numpy(),
                                   np.asarray(jlearn[name]), rtol=1e-4,
                                   atol=1e-5, err_msg=name)
    for name in ("mean", "sigma", "C", "p_sigma", "p_c"):
        np.testing.assert_allclose(getattr(tstates2, name).numpy(),
                                   np.asarray(getattr(jstates2, name)),
                                   rtol=1e-4, atol=1e-5, err_msg=name)


# --------------------------------------------------------------------- #
# the JAX package's batched contracts                                     #
# --------------------------------------------------------------------- #

def test_inverts_several_images_and_records_curves(toy):
    targets = _targets(toy, 3, seed=11)
    opt = _opt(toy)
    res = opt.optimize(targets, meta_steps=5, grad_steps=8,
                       last_grad_steps=30)
    assert tuple(res["z"].shape) == (3, ZD)
    assert tuple(res["out"].shape) == tuple(targets.shape)
    assert res["loss_curves"].shape == (5, 3)
    assert np.isfinite(res["loss_curves"]).all()
    assert float(res["loss"].max()) < 0.05
    assert np.all(res["loss_curves"][-1] <= res["loss_curves"][0] + 1e-6)
    assert len(opt.gen_seconds) == 5


def test_image_results_do_not_depend_on_the_other_images(toy):
    """One generation at the same candidates: image 0's losses, refined rows
    and CMA state are the same whatever image 1's target is."""
    a, b, c = _targets(toy, 3, seed=12)
    x = torch.tensor(np.random.RandomState(1).randn(2, 8, ZD).astype(
        np.float32))
    outs = []
    for other in (b, c):
        opt = _opt(toy)
        data = {"targets": torch.stack([a, other]), "fixed": {}}
        _, state0 = cma.init(np.zeros(ZD), 1.0, 8, device="cpu")
        outs.append(opt.generation(cma.stack_states(state0, 2), data,
                                   opt._make_aux(data, 2), 5, 0, x=x))
    (s1, l1, f1, _), (s2, l2, f2, _) = outs
    np.testing.assert_allclose(f1[0].numpy(), f2[0].numpy(), rtol=1e-6)
    np.testing.assert_allclose(l1["z"][:8].detach().numpy(),
                               l2["z"][:8].detach().numpy(), rtol=1e-6)
    np.testing.assert_allclose(s1.C[0].numpy(), s2.C[0].numpy(), rtol=1e-6)
    assert not np.allclose(f1[1].numpy(), f2[1].numpy())
    # and, as the JAX test, a solo run of image 0 reaches the same quality
    both = _opt(toy).optimize(torch.stack([a, b]), meta_steps=3,
                              grad_steps=5, last_grad_steps=10)
    solo = _opt(toy).optimize(a[None], meta_steps=3, grad_steps=5,
                              last_grad_steps=10)
    assert abs(float(both["loss"][0]) - float(solo["loss"][0])) < 0.1


def test_learnable_inputs_are_refined_per_image():
    jm, tm = _pair(c_dim=C_DIM)
    rng = np.random.RandomState(14)
    z, c = (torch.tensor(rng.randn(2, d).astype(np.float32))
            for d in (ZD, C_DIM))
    with torch.no_grad():
        targets = tm(z, c)
    res = _opt(tm, learnable_inputs={"c": 0.01}).optimize(
        targets, fixed_inputs={"c": c}, meta_steps=3, grad_steps=5,
        last_grad_steps=20)
    assert tuple(res["c"].shape) == (2, C_DIM)
    assert not torch.equal(res["c"], c)
    assert float(res["loss"].max()) < 0.1


def test_chunked_matches_plain(toy):
    targets = _targets(toy, 2, seed=21)

    def run(mbs):
        return _opt(toy, loss=LF.ReconstructionLoss(), seed=3,
                    max_batch_size=mbs).optimize(
            targets, meta_steps=3, grad_steps=5, last_grad_steps=10)

    plain, chunked = run(None), run(3)      # 16 rows: 6 chunks of 3
    np.testing.assert_allclose(chunked["z"].numpy(), plain["z"].numpy(),
                               rtol=0, atol=5e-3)
    np.testing.assert_allclose(chunked["loss"].numpy(),
                               plain["loss"].numpy(), rtol=0, atol=1e-4)


def test_resume_runs_no_finished_generation(toy, tmp_path, capsys):
    targets = _targets(toy, 2, seed=23)
    path = str(tmp_path / "batched.npz")

    def run(meta, ckpt=path):
        opt = _opt(toy, seed=5)
        return opt.optimize(targets, meta_steps=meta, grad_steps=5,
                            last_grad_steps=10, checkpoint_path=ckpt), opt

    run(2)                                   # a run cut after 2 generations
    resumed, opt = run(4)
    assert len(opt.gen_seconds) == 2         # generations 2 and 3 only
    straight, _ = run(4, ckpt=None)
    np.testing.assert_allclose(resumed["z"].numpy(), straight["z"].numpy(),
                               rtol=0, atol=1e-6)
    capsys.readouterr()
    again, opt = run(4)                      # finished: no step runs
    out = capsys.readouterr().out
    assert opt.gen_seconds == []
    assert "resumed the final run at step 10/10" in out
    np.testing.assert_array_equal(again["z"].numpy(), resumed["z"].numpy())


@pytest.mark.parametrize("mbs", [None, 3])
def test_segmented_final_matches_one_run(toy, mbs):
    targets = _targets(toy, 2, seed=31)

    def run(seg):
        return _opt(toy, seed=7, max_batch_size=mbs).optimize(
            targets, meta_steps=2, grad_steps=5, last_grad_steps=10,
            final_segment_steps=seg)

    one, seg = run(None), run(4)             # 4 + 4 + 2
    np.testing.assert_allclose(seg["z"].numpy(), one["z"].numpy(), rtol=0,
                               atol=1e-6)
    np.testing.assert_allclose(seg["loss"].numpy(), one["loss"].numpy(),
                               rtol=0, atol=1e-6)


def test_inverted_tell_with_the_identity_is_the_plain_run(toy):
    targets = _targets(toy, 2, seed=5)
    warp = SpatialTransform(sensitivity=1.0, device="cpu")

    def run(tell):
        opt = _opt(toy, popsize=6, seed=11, max_batch_size=5)
        return opt.optimize(targets, meta_steps=2, grad_steps=3,
                            last_grad_steps=4, tell_inverted=tell), opt

    plain, op = run(None)
    inv, oi = run({"transform_fn": warp, "t": torch.zeros(2, 3),
                   "targets": targets})
    np.testing.assert_allclose(inv["z"].numpy(), plain["z"].numpy(),
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(inv["loss"].numpy(), plain["loss"].numpy(),
                               rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(np.stack(oi.losses), np.stack(op.losses),
                               rtol=1e-6, atol=1e-7)


def _warped(toy, warp, seed=7):
    targets = _targets(toy, 2, seed=seed)
    t = torch.tensor(np.stack([T_FROZEN, -0.5 * T_FROZEN]))
    with torch.no_grad():
        warped = torch.cat([warp(targets[i:i + 1], t[i:i + 1])
                            for i in range(2)])
    return targets, t, warped


def test_inverted_tell_scores_the_original_frame(toy):
    warp = SpatialTransform(sensitivity=1.0, device="cpu")
    targets, t, warped = _warped(toy, warp)
    res = _opt(toy, popsize=6, seed=3).optimize(
        warped, meta_steps=2, grad_steps=3, last_grad_steps=4,
        tell_inverted={"transform_fn": warp, "t": t, "targets": targets})
    with torch.no_grad():
        out = toy(res["z"])
        expected = torch.stack([
            (warp(out[i:i + 1], t[i:i + 1], invert=True)[0]
             - targets[i]).abs().mean() for i in range(2)])
    np.testing.assert_allclose(res["loss"].numpy(), expected.numpy(),
                               rtol=1e-5, atol=1e-6)


def test_inverted_tell_precomputed_context_matches_direct(toy):
    class PrecomputeL1:
        def __call__(self, output, target, weight=None):
            return (target - output).abs()

        def precompute(self, target, weight=None, loss_mask=None):
            return {"target": target}

        def from_ctx(self, output, ctx):
            return (ctx["target"] - output).abs()

    warp = SpatialTransform(sensitivity=1.0, device="cpu")
    targets, t, warped = _warped(toy, warp)

    def run(loss):
        opt = _opt(toy, loss=loss, popsize=6, seed=3)
        return opt.optimize(warped, meta_steps=2, grad_steps=3,
                            last_grad_steps=4,
                            tell_inverted={"transform_fn": warp, "t": t,
                                           "targets": targets}), opt

    (direct, od), (ctxed, oc) = run(_l1), run(PrecomputeL1())
    np.testing.assert_allclose(ctxed["z"].numpy(), direct["z"].numpy(),
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(np.stack(oc.losses), np.stack(od.losses),
                               rtol=1e-6, atol=1e-7)


def test_a_reused_optimizer_tells_with_the_new_transform(toy):
    targets = _targets(toy, 2, seed=9)
    t = torch.tensor(np.stack([T_FROZEN, -0.5 * T_FROZEN]))
    warp_a = SpatialTransform(sensitivity=1.0, device="cpu")
    warp_b = SpatialTransform(sensitivity=0.25, device="cpu")

    def tell(warp):
        return {"transform_fn": warp, "t": t, "targets": targets}

    shared = _opt(toy, popsize=6, seed=3)
    shared.optimize(targets, meta_steps=1, grad_steps=2, last_grad_steps=2,
                    tell_inverted=tell(warp_a))
    shared.generator.manual_seed(3)          # replay the stream
    reused = shared.optimize(targets, meta_steps=1, grad_steps=2,
                             last_grad_steps=2, tell_inverted=tell(warp_b))
    fresh = _opt(toy, popsize=6, seed=3).optimize(
        targets, meta_steps=1, grad_steps=2, last_grad_steps=2,
        tell_inverted=tell(warp_b))
    np.testing.assert_allclose(reused["loss"].numpy(), fresh["loss"].numpy(),
                               rtol=1e-6, atol=1e-7)


# --------------------------------------------------------------------- #
# the batched transform search                                            #
# --------------------------------------------------------------------- #

SHIFTS = [0.4, -0.3, 0.2]


def _shifted(toy, m):
    clean = _targets(toy, 1, seed=3)
    warp = SpatialTransform(sensitivity=1.0, device="cpu")
    return torch.cat([warp.transform(clean, torch.tensor(
        [[1.0, SHIFTS[i % 3], 0.0]])) for i in range(m)])


def _search(toy, target, seed=0):
    vm = VariableManager(seed=0, device="cpu")
    vm.register("z", shape=(ZD,), var_type="input", learning_rate=0.05)
    vm.register("target", shape=(RES, RES, 3), var_type="output",
                requires_grad=False, default=target)
    vm.register("weight", shape=(RES, RES, 3), var_type="output",
                requires_grad=False, default=torch.ones(RES, RES, 3))
    vm.register("t", shape=(3,), var_type="transform", requires_grad=False,
                grad_free=(np.array([1.0, 0, 0]), 0.3))
    opt = TransformBasinCMAOptimizer(
        toy, vm, lambda out, target, weight: LF.masked_l1_loss(
            out, target, weight), seed=seed, device="cpu")
    opt.register_transform(SpatialTransform(sensitivity=1.0, device="cpu"),
                           "t", "target")
    opt.register_transform(SpatialTransform(sensitivity=1.0, device="cpu"),
                           "t", "weight")
    opt.set_variable_propagation("z")
    return opt


def test_batched_search_equals_solo_searches(toy):
    targets = _shifted(toy, 2)
    seeds = [11, 29]
    solo = []
    for i in range(2):
        opt = _search(toy, targets[i], seed=seeds[i])
        opt.optimize_fused(meta_steps=4, grad_steps=4)
        solo.append((opt._candidate, opt._best_loss, opt.losses))
    res = _search(toy, targets[0]).optimize_fused_batched(
        {"target": targets}, meta_steps=4, grad_steps=4, seeds=seeds)
    assert res["candidate"].shape == (2, 3) and res["loss"].shape == (2, 7)
    np.testing.assert_allclose(res["candidate"],
                               np.stack([s[0] for s in solo]),
                               rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(res["best_loss"], [s[1] for s in solo],
                               rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(res["loss_curves"],
                               np.stack([s[2] for s in solo], 1),
                               rtol=2e-4, atol=2e-5)


def test_batched_searches_recover_their_own_shifts(toy):
    m = 3
    res = _search(toy, _shifted(toy, 1)[0]).optimize_fused_batched(
        {"target": _shifted(toy, m)}, meta_steps=6, grad_steps=8)
    assert np.isfinite(res["best_loss"]).all()
    assert (res["best_loss"] < 0.25).all(), res["best_loss"]
    cand = res["candidate"]
    for i in range(m):
        for j in range(i + 1, m):
            assert not np.allclose(cand[i], cand[j], atol=1e-6), (i, j)
    assert res["candidate_out"].shape == (m, RES, RES, 3)
    np.testing.assert_allclose(res["loss_curves"].min(axis=0),
                               res["best_loss"], rtol=1e-6)


def test_batched_search_resumes_into_the_last_generation(toy, tmp_path,
                                                         monkeypatch):
    targets = _shifted(toy, 2)
    path = str(tmp_path / "search.npz")
    full = _search(toy, targets[0]).optimize_fused_batched(
        {"target": targets}, meta_steps=4, grad_steps=3, seeds=[1, 2])
    run = TransformBasinCMAOptimizer._run_generation_batched

    def dies_in_the_last(self, carry, gens, defaults, gen_idx, *a):
        if gen_idx == 3:
            raise KeyboardInterrupt
        return run(self, carry, gens, defaults, gen_idx, *a)

    monkeypatch.setattr(TransformBasinCMAOptimizer,
                        "_run_generation_batched", dies_in_the_last)
    with pytest.raises(KeyboardInterrupt):
        _search(toy, targets[0]).optimize_fused_batched(
            {"target": targets}, meta_steps=4, grad_steps=3, seeds=[1, 2],
            checkpoint_path=path)
    monkeypatch.setattr(TransformBasinCMAOptimizer,
                        "_run_generation_batched", run)
    opt = _search(toy, targets[0])
    res = opt.optimize_fused_batched(
        {"target": targets}, meta_steps=4, grad_steps=3, seeds=[1, 2],
        checkpoint_path=path)
    assert len(opt.gen_seconds) == 1         # the last generation only
    np.testing.assert_allclose(res["candidate"], full["candidate"],
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(res["best_loss"], full["best_loss"],
                               rtol=1e-5, atol=1e-7)


def test_batched_search_rejects_an_unregistered_default(toy):
    targets = _shifted(toy, 2)
    with pytest.raises(ValueError, match="unregistered"):
        _search(toy, targets[0]).optimize_fused_batched(
            {"nope": targets}, meta_steps=2, grad_steps=2)
