"""Population sharding in the port (``pix2latent_tpu_torch/parallel/``)
against the JAX package's ``pix2latent_tpu/parallel/`` and against the port
without a mesh.

- The pure functions against the JAX package: ``pad_population`` over mesh
  sizes 1 to 8 (JAX meshes from the conftest's 8 virtual devices), the
  single-process ``local_population_rows``, the padded budget of the
  registry drivers (``tests/test_strategies.py``
  test_padded_population_rescales_budget), ``topology``, and
  ``initialize_multihost`` in a subprocess (no config, torchrun markers
  with a failing group, explicit world size 1 over gloo, a second call).
- One gloo group of two processes, which rendezvous through a file: on a
  toy generator with a NormalPerturb hook (which draws), population 7
  padded to 8 and ``max_batch_size`` 3 within a rank, BasinCMA's host loop
  and fused driver, ``BatchedBasinCMAOptimizer`` with M = 2, and a fused run
  stopped after 3 of 6 generations and resumed (a checkpoint written at
  world size 2 resumed at world size 1, and the other way round), and the
  transform search (host loop, fused, and 3 batched searches whose rows
  straddle the ranks) with z propagated. Each is
  held against the same run without a mesh in this process: the tell
  losses of every generation, the CMA mean and the final variables within
  rel 1e-5 / atol 1e-6; the two ranks' CMA and generator states bitwise
  equal.
- The surface shared with the JAX package: the constructors' positional
  parameters, ``pix2latent_tpu_torch.utils``' submodules and the models'
  exports.

Run as a script (``python tests/test_torch_parallel.py --worker RANK WORLD
RDV OUT [CKPT]``) this file is one rank of that group.
"""

from __future__ import annotations

import inspect
import os
import shutil
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from pix2latent_tpu_torch import VariableManager, hooks  # noqa: E402
from pix2latent_tpu_torch import loss_functions as LF  # noqa: E402
from pix2latent_tpu_torch.models.toy import make_toy_model  # noqa: E402
from pix2latent_tpu_torch.optimizers import (  # noqa: E402
    BasinCMAOptimizer, BatchedBasinCMAOptimizer)
from pix2latent_tpu_torch.parallel import mesh as M  # noqa: E402
from pix2latent_tpu_torch.parallel import multihost  # noqa: E402

ZD, CD, RES = 8, 4, 16
POP, PADDED, MBS = 7, 8, 3
GENS, STEPS, FINAL = 3, 4, 4
RTOL, ATOL = 1e-5, 1e-6
WORLD = 2


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread per test (see ``tests/test_torch_examples.py``)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# --------------------------------------------------------------------- #
# the problem both sides run                                              #
# --------------------------------------------------------------------- #

def _model():
    return make_toy_model(z_dim=ZD, c_dim=CD, res=RES, width=8, seed=3,
                          device="cpu")


def _vm(model):
    """z searched by CMA with a hook that draws; c refined by Adam from a
    default; the target of a known latent and a non-uniform weight."""
    rng = np.random.RandomState(11)
    c0 = rng.randn(CD).astype(np.float32)
    with torch.no_grad():
        target = model(torch.tensor(rng.randn(1, ZD).astype(np.float32)),
                       torch.tensor(c0[None]))[0]
    vm = VariableManager(device="cpu")
    vm.register("z", shape=(ZD,), var_type="input", grad_free=True,
                learning_rate=0.05, hook_fn=hooks.NormalPerturb(0.05))
    vm.register("c", shape=(CD,), var_type="input", learning_rate=0.01,
                default=c0)
    vm.register("target", shape=(RES, RES, 3), var_type="output",
                requires_grad=False, default=target)
    vm.register("weight", shape=(RES, RES, 3), var_type="output",
                requires_grad=False,
                default=rng.uniform(0.3, 1.0, (RES, RES, 3)).astype(
                    np.float32))
    return vm


def _loss(out, target, weight):
    return LF.l1_loss(out, target) * weight


class _Recording(BasinCMAOptimizer):
    """BasinCMA that keeps every tell's losses."""

    def _tell(self, state, x, loss, aux):
        self.tells.append(loss.detach().clone())
        return super()._tell(state, x, loss, aux)


class _RecordingBatched(BatchedBasinCMAOptimizer):
    """Batched BasinCMA that keeps every evaluation of the rows (the
    tells', then the final run's)."""

    def _eval_chunked(self, learn, aux):
        loss = super()._eval_chunked(learn, aux)
        self.evals.append(loss.clone())
        return loss


def _basin(mesh, popsize, driver, gens=GENS, **kw):
    model = _model()
    opt = _Recording(model, _vm(model), _loss, max_batch_size=MBS,
                     mesh=mesh, seed=5, device="cpu")
    opt.tells = []
    M.reset_gather_counts()
    variables, _, losses = getattr(opt, driver)(
        gens, STEPS, last_grad_steps=FINAL, popsize=popsize, **kw)
    out = {"tells": np.stack([t.numpy() for t in opt.tells])
           if opt.tells else np.zeros((0,)),
           "gathers": np.int64(M.gather_counts()["gathers"]),
           "final_loss": np.asarray(losses[-1][1]["loss"]),
           "num_samples": np.int64(opt.num_samples),
           "mean": opt.cma_state.mean.numpy(),
           "out": opt.out.numpy(),
           "generator": opt.generator.get_state().numpy()}
    for vt, d in variables.items():
        for name, t in d.items():
            out[f"var/{vt}/{name}"] = t.detach().numpy()
    for field, t in opt.cma_state._asdict().items():
        out[f"state/{field}"] = t.numpy()
    for name, arr in opt.tracked.items():
        out[f"tracked/{name}"] = np.asarray(arr)
    return out


def _batched(mesh, popsize):
    model = _model()
    rng = np.random.RandomState(4)
    c = rng.randn(2, CD).astype(np.float32)
    with torch.no_grad():
        targets = model(torch.tensor(rng.randn(2, ZD).astype(np.float32)),
                        torch.tensor(c))
    opt = _RecordingBatched(
        model, LF.l1_loss, z_dim=ZD, popsize=popsize, seed=6,
        learnable_inputs={"c": 0.01}, max_batch_size=MBS,
        hook_fn=hooks.NormalPerturb(0.05), mesh=mesh, device="cpu")
    opt.evals = []
    M.reset_gather_counts()
    res = opt.optimize(targets, fixed_inputs={"c": c}, meta_steps=GENS,
                       grad_steps=STEPS, last_grad_steps=FINAL)
    out = {"evals": torch.stack(opt.evals).numpy(),
           "gathers": np.int64(M.gather_counts()["gathers"]),
           "z": res["z"].numpy(), "c": res["c"].numpy(),
           "loss": res["loss"].numpy(), "all_losses": res["all_losses"],
           "loss_curves": res["loss_curves"],
           "num_samples": np.int64(opt.popsize),
           "generator": opt.generator.get_state().numpy()}
    for field, t in res["cma_states"]._asdict().items():
        out[f"state/{field}"] = t.numpy()
    return out


def _search(mesh, seed=0):
    """The toy alignment search (``tests/test_torch_batched.py``) with a
    hook that draws on z, and z propagated."""
    from pix2latent_tpu_torch.transform import (SpatialTransform,
                                                TransformBasinCMAOptimizer)
    model = make_toy_model(z_dim=ZD, res=RES, width=8, seed=3, device="cpu")
    vm = VariableManager(device="cpu")
    vm.register("z", shape=(ZD,), var_type="input", learning_rate=0.05,
                hook_fn=hooks.NormalPerturb(0.05))
    vm.register("target", shape=(RES, RES, 3), var_type="output",
                requires_grad=False, default=_shifted(model, 1)[0])
    vm.register("weight", shape=(RES, RES, 3), var_type="output",
                requires_grad=False, default=torch.ones(RES, RES, 3))
    vm.register("t", shape=(3,), var_type="transform", requires_grad=False,
                grad_free=(np.array([1.0, 0, 0]), 0.3))
    opt = TransformBasinCMAOptimizer(
        model, vm, lambda out, target, weight: LF.masked_l1_loss(
            out, target, weight), max_batch_size=MBS, mesh=mesh, seed=seed,
        device="cpu")
    for name in ("target", "weight"):
        opt.register_transform(SpatialTransform(sensitivity=1.0,
                                                device="cpu"), "t", name)
    opt.set_variable_propagation("z")
    return opt, model


def _shifted(model, m):
    from pix2latent_tpu_torch.transform import SpatialTransform
    z = torch.tensor(np.random.RandomState(3).randn(1, ZD).astype(np.float32))
    with torch.no_grad():
        clean = model(z)
    warp = SpatialTransform(sensitivity=1.0, device="cpu")
    return torch.cat([warp.transform(clean, torch.tensor(
        [[1.0, (0.4, -0.3, 0.2)[i % 3], 0.0]])) for i in range(m)])


def _transform(mesh, popsize, driver):
    opt, model = _search(mesh)
    M.reset_gather_counts()
    if driver == "batched":
        res = opt.optimize_fused_batched(
            {"target": _shifted(model, 3)}, meta_steps=GENS, grad_steps=3,
            popsize=popsize, seeds=[1, 2, 3])
        out = {"gathers": np.int64(M.gather_counts()["gathers"]),
               "num_samples": np.int64(opt.num_samples)}
        for key in ("candidate", "best_loss", "loss", "inner_loss",
                    "candidate_out", "loss_curves"):
            out[key] = np.asarray(res[key])
        out["var/input/z"] = res["variables"]["input"]["z"].detach().numpy()
        out["vp/z"] = res["vp_means"]["z"].numpy()
        for field, t in res["cma_states"]._asdict().items():
            out[f"state/{field}"] = t.numpy()
        out["generator"] = opt.generator.get_state().numpy()
        return out
    variables, results, loss = getattr(opt, driver)(
        meta_steps=GENS, grad_steps=3, popsize=popsize)
    out = {"gathers": np.int64(M.gather_counts()["gathers"]),
           "num_samples": np.int64(opt.num_samples),
           "losses": np.asarray(opt.losses), "loss": np.asarray(loss),
           "final_tell": opt.final_tell, "candidate": opt.get_candidate(),
           "candidate_out": np.asarray(results[2]),
           "out": opt.out.detach().numpy(),
           "vp/z": opt.vp_means["z"].numpy(),
           "generator": opt.generator.get_state().numpy()}
    for vt, d in variables.items():
        for name, t in d.items():
            out[f"var/{vt}/{name}"] = t.detach().numpy()
    for field, t in opt.cma_state._asdict().items():
        out[f"state/{field}"] = t.numpy()
    if driver == "optimize":
        out["transform_tracked"] = np.stack(opt.transform_tracked)
        for name, arr in opt.tracked.items():
            out[f"tracked/{name}"] = np.asarray(arr)
    return out


def _runs(mesh, popsize, ckpt_dir, foreign=None):
    """Every run of the group, as ``{run: {key: array}}``. ``ckpt_dir``
    gets a fused run stopped after 3 generations (``stopped.npz``, kept as
    ``at3.npz``) and then resumed to 6 there. ``foreign``: a checkpoint
    written at another world size, stopped after 3 generations, resumed
    here to 6."""
    runs = {"optimize": _basin(mesh, popsize, "optimize"),
            "optimize_fused": _basin(mesh, popsize, "optimize_fused"),
            "batched": _batched(mesh, popsize),
            "transform_fused": _transform(mesh, popsize, "optimize_fused"),
            "transform_optimize": _transform(mesh, popsize, "optimize"),
            "transform_batched": _transform(mesh, popsize, "batched")}
    path = str(Path(ckpt_dir) / "stopped.npz")
    _basin(mesh, popsize, "optimize_fused", checkpoint_path=path)
    if mesh is None or mesh.is_writer:
        shutil.copy(path, Path(ckpt_dir) / "at3.npz")
    if mesh is not None:
        mesh.barrier()
    runs["resumed"] = _basin(mesh, popsize, "optimize_fused", 6,
                             checkpoint_path=path)
    # the finished run again: the final run resumes from its own checkpoint
    runs["finished"] = _basin(mesh, popsize, "optimize_fused", 6,
                              checkpoint_path=path)
    if foreign is not None:
        runs["foreign"] = _basin(mesh, popsize, "optimize_fused", 6,
                                 checkpoint_path=foreign)
    return runs


def _worker(rank, world, rdv, out, foreign=None):
    import torch.distributed as dist
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{rdv}",
                            world_size=world, rank=rank)
    try:
        mesh = M.make_mesh(devices="cpu")
        assert (mesh.rank, mesh.size) == (rank, world), mesh
        runs = _runs(mesh, POP, Path(out), foreign)
        flat = {f"{run}|{k}": v for run, d in runs.items()
                for k, v in d.items()}
        np.savez(Path(out) / f"rank{rank}.npz", **flat)
    finally:
        dist.destroy_process_group()


def _unflat(path):
    runs = {}
    with np.load(path) as z:
        for key in z.files:
            run, k = key.split("|", 1)
            runs.setdefault(run, {})[k] = z[key]
    return runs


# --------------------------------------------------------------------- #
# world size 2 against no mesh                                            #
# --------------------------------------------------------------------- #

@pytest.fixture(scope="module")
def group(tmp_path_factory):
    """The two ranks' runs, and this process's runs without a mesh."""
    tmp = tmp_path_factory.mktemp("parallel")
    ws2, ws1 = tmp / "ws2", tmp / "ws1"
    ws2.mkdir()
    ws1.mkdir()
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        # a world-size-1 checkpoint stopped after 3 generations, for the
        # group to resume
        _basin(None, PADDED, "optimize_fused",
               checkpoint_path=str(ws1 / "at3.npz"))
        env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
        for k in ("WORLD_SIZE", "RANK", "LOCAL_RANK", "MASTER_ADDR",
                  "MASTER_PORT", "TORCHELASTIC_RUN_ID"):
            env.pop(k, None)
        procs = [subprocess.Popen(
            [sys.executable, __file__, "--worker", str(r), str(WORLD),
             str(tmp / "rdv"), str(ws2), str(ws1 / "at3.npz")],
            cwd=ROOT, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True) for r in range(WORLD)]
        logs = [p.communicate(timeout=600)[0] for p in procs]
        for p, log in zip(procs, logs):
            assert p.returncode == 0, log[-4000:]
        ranks = [_unflat(ws2 / f"rank{r}.npz") for r in range(WORLD)]
        # no mesh, at the padded population; then the group's checkpoint
        # stopped after 3 generations resumed here
        plain = _runs(None, PADDED, ws1)
        plain["foreign"] = _basin(None, PADDED, "optimize_fused", 6,
                                  checkpoint_path=str(ws2 / "at3.npz"))
        plain["straight"] = _basin(None, PADDED, "optimize_fused", 6)
    finally:
        torch.set_num_threads(n)
    return ranks, plain


def _close(got, want, what):
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL,
                               err_msg=what)


@pytest.mark.parametrize("run", ["optimize", "optimize_fused"])
def test_basincma_on_two_ranks_matches_no_mesh(group, run):
    ranks, plain = group
    want = plain[run]
    for r, got in enumerate(ranks):
        got = got[run]
        assert int(got["num_samples"]) == PADDED
        assert int(got["num_samples"]) % WORLD == 0
        assert got["final_loss"].shape == (PADDED,)
        assert got["tells"].shape == (GENS, PADDED)
        _close(got["tells"], want["tells"], f"rank {r} tell losses")
        _close(got["mean"], want["mean"], f"rank {r} CMA mean")
        _close(got["final_loss"], want["final_loss"], f"rank {r} final loss")
        _close(got["out"], want["out"], f"rank {r} images")
        for key in want:
            if key.startswith(("var/", "tracked/")):
                assert got[key].shape == want[key].shape, key
                _close(got[key], want[key], f"rank {r} {key}")
    if run == "optimize":
        assert ranks[0][run]["tracked/z"].shape == (
            GENS * STEPS + FINAL, PADDED, ZD)


@pytest.mark.parametrize("run", ["optimize", "optimize_fused", "batched",
                                 "resumed", "finished", "foreign",
                                 "transform_fused", "transform_optimize",
                                 "transform_batched"])
def test_ranks_end_with_bitwise_equal_states(group, run):
    ranks, _ = group
    a, b = ranks[0][run], ranks[1][run]
    keys = [k for k in a if k.startswith("state/")] + ["generator"]
    assert len(keys) > 1
    for key in keys:
        np.testing.assert_array_equal(a[key], b[key], err_msg=key)


def test_batched_on_two_ranks_matches_no_mesh(group):
    ranks, plain = group
    want = plain["batched"]
    assert want["evals"].shape == (GENS + 1, 2 * PADDED)
    for r, got in enumerate(ranks):
        got = got["batched"]
        assert int(got["num_samples"]) == PADDED
        _close(got["evals"], want["evals"], f"rank {r} row losses")
        _close(got["state/mean"], want["state/mean"], f"rank {r} CMA means")
        for key in ("z", "c", "loss", "all_losses", "loss_curves"):
            _close(got[key], want[key], f"rank {r} {key}")


@pytest.mark.parametrize("run", ["transform_fused", "transform_optimize",
                                 "transform_batched"])
def test_transform_search_on_two_ranks_matches_no_mesh(group, run):
    """The search's tells, candidate, propagation means, final variables
    and images; the batched one with 3 searches of 8 rows, so a rank holds
    the rows of two searches and a search's rows lie on both ranks."""
    ranks, plain = group
    want = plain[run]
    for r, rk in enumerate(ranks):
        got = rk[run]
        assert int(got["num_samples"]) == PADDED
        for key in want:
            if key in ("gathers", "generator") or key.startswith("state/"):
                continue
            assert got[key].shape == want[key].shape, (run, key)
            _close(got[key], want[key], f"rank {r} {run} {key}")
        _close(got["state/mean"], want["state/mean"], f"rank {r} CMA mean")


@pytest.mark.parametrize("run", ["resumed", "foreign"])
def test_checkpoint_resumes_across_world_sizes(group, run):
    """Stopped after 3 of 6 generations and resumed: at world size 2 from
    its own file (``resumed``) and from one written at world size 1
    (``foreign``), and here at world size 1 from the group's file."""
    ranks, plain = group
    straight = plain["straight"]
    for got in [plain["foreign"], plain["resumed"]] + [rk[run]
                                                       for rk in ranks]:
        assert got["tells"].shape == (3, PADDED)
        _close(got["tells"], straight["tells"][3:],
               f"{run} tells after the resume")
        _close(got["final_loss"], straight["final_loss"], f"{run} loss")
        _close(got["var/input/z"], straight["var/input/z"], f"{run} z")


def test_finished_run_resumes_its_final_run(group):
    """The finished run again: no generation, the final run's gathered
    checkpoint split over the ranks and gathered back."""
    ranks, plain = group
    for got in [rk["finished"] for rk in ranks]:
        assert got["tells"].shape == (0,)
        for key in ("var/input/z", "var/input/c"):
            _close(got[key], plain["finished"][key], key)
            _close(got[key], plain["resumed"][key], key)


@pytest.mark.parametrize("run,expect", [
    # the tells, then z, c, the images and the losses, and the host loop's
    # tracked z and c
    ("optimize", GENS + 4 + 2),
    ("optimize_fused", GENS + 4),
    # the tells, then the final losses, z and c
    ("batched", GENS + 3),
    # a finished run: no tell; its final run's checkpoint is read, and
    # nothing is written
    ("finished", 4),
    # the search: the tells and the propagated z each generation, then the
    # last inner losses, the images and z, t, target and weight (each warped
    # per row); the host loop's images and losses, and its tracked z; the
    # batched search's inner losses and variables
    ("transform_fused", 2 * GENS + 2 + 4),
    ("transform_optimize", 2 * GENS + 4 + 2 + 1),
    ("transform_batched", 2 * GENS + 1 + 4)])
def test_one_gather_a_generation(group, run, expect):
    """The gathers of a rank: one a generation, and the end-of-run ones."""
    ranks, plain = group
    assert [int(rk[run]["gathers"]) for rk in ranks] == [expect] * WORLD
    assert int(plain[run]["gathers"]) == 0


# --------------------------------------------------------------------- #
# the pure functions against the JAX package                              #
# --------------------------------------------------------------------- #

@pytest.mark.parametrize("n_dev", range(1, 9))
def test_pad_population_matches_jax(n_dev):
    from pix2latent_tpu.parallel.mesh import make_mesh as jax_mesh
    from pix2latent_tpu.parallel.mesh import pad_population as jax_pad
    jm = jax_mesh(n_dev)
    tm = M.Mesh(rank=0, size=n_dev, device="cpu")
    for n in range(1, 40):
        assert M.pad_population(n, tm) == jax_pad(n, jm), (n, n_dev)
    assert M.pad_population(13, None) == jax_pad(13, None) == 13


def test_local_population_rows_single_process():
    from pix2latent_tpu.parallel import make_mesh as jax_mesh
    from pix2latent_tpu.parallel import multihost as jax_multihost
    mesh = M.make_mesh(devices="cpu")
    assert list(multihost.local_population_rows(mesh, 24)) == list(
        jax_multihost.local_population_rows(jax_mesh(), 24)) == list(
        range(24))
    four = M.Mesh(rank=2, size=4, device="cpu")
    assert list(multihost.local_population_rows(four, 24)) == list(
        range(12, 18))
    with pytest.raises(ValueError):
        multihost.local_population_rows(four, 23)


def test_topology_single_process():
    from pix2latent_tpu.parallel import multihost as jax_multihost
    got, want = multihost.topology(), jax_multihost.topology()
    assert set(got) == set(want)
    assert got["process_index"] == want["process_index"] == 0
    assert got["process_count"] == want["process_count"] == 1
    assert got["local_devices"] == got["global_devices"] == 1


def test_padded_population_rescales_budget_as_jax():
    """As ``tests/test_strategies.py`` test_padded_population_rescales_budget:
    6 requested samples padded to 8 on an 8-rank mesh scale the budget by
    8/6, so MetaRecentering's scale is that of 8 samples at 10 x 8."""
    import jax

    from pix2latent_tpu import VariableManager as JaxVM
    from pix2latent_tpu import distribution as jdist
    from pix2latent_tpu.optimizers.ng_base import _BaseNGOptimizer as JaxNG
    from pix2latent_tpu.parallel.mesh import make_mesh as jax_mesh
    from pix2latent_tpu_torch import distribution as tdist
    from pix2latent_tpu_torch.optimizers import NevergradOptimizer

    jvm = JaxVM()
    jvm.register(variable_name="z", shape=(32,), grad_free=True,
                 distribution=jdist.TruncatedNormalModulo(sigma=1.0),
                 var_type="input")

    class Driver(JaxNG):
        def __init__(self, mesh):
            JaxNG.__init__(self, method="MetaRecentering")
            self.mesh = mesh
            self._k = jax.random.PRNGKey(0)

        def next_key(self):
            self._k, k = jax.random.split(self._k)
            return k

    jd = Driver(jax_mesh())
    jd.setup_ng(jvm, num_samples=6, budget=10 * 6)

    vm = VariableManager(device="cpu")
    vm.register("z", shape=(32,), grad_free=True, var_type="input",
                distribution=tdist.TruncatedNormalModulo(sigma=1.0))
    opt = NevergradOptimizer("MetaRecentering", _model(), vm, _loss,
                             device="cpu")
    opt.mesh = M.Mesh(rank=0, size=8, device="cpu")
    opt.setup_ng(vm, num_samples=6, budget=10 * 6)
    assert opt.num_samples == jd.num_samples == 8
    np.testing.assert_allclose(opt.ng_strategy.scale, jd.ng_strategy.scale,
                               rtol=1e-6)
    alone = NevergradOptimizer("MetaRecentering", _model(), vm, _loss,
                               device="cpu")
    alone.setup_ng(vm, num_samples=6, budget=10 * 6)
    assert alone.num_samples == 6


def test_initialize_multihost_four_ways(tmp_path):
    """In a fresh process: no config is a no-op; torchrun markers with a
    failing group raise RuntimeError; explicit world size 1 over gloo makes
    a group; a second call returns the same topology."""
    code = textwrap.dedent("""
        import os, sys
        sys.path.insert(0, %r)
        import torch.distributed as dist
        from pix2latent_tpu_torch.parallel import make_mesh, multihost
        for k in ("WORLD_SIZE", "RANK", "LOCAL_RANK", "MASTER_ADDR",
                  "MASTER_PORT", "TORCHELASTIC_RUN_ID"):
            os.environ.pop(k, None)
        info = multihost.initialize_multihost()
        assert not dist.is_initialized(), "no config must be a no-op"
        assert info["process_count"] == 1, info
        os.environ["WORLD_SIZE"] = "2"
        try:
            multihost.initialize_multihost(backend="gloo")
        except RuntimeError as e:
            assert "compute garbage" in str(e), e
            print("RAISED_LOUDLY")
        assert not dist.is_initialized()
        del os.environ["WORLD_SIZE"]
        info = multihost.initialize_multihost(
            coordinator_address="file://" + %r, num_processes=1,
            process_id=0, backend="gloo")
        assert dist.is_initialized() and dist.get_backend() == "gloo"
        assert info["process_count"] == 1 and info["process_index"] == 0
        assert multihost.initialize_multihost() == info
        mesh = make_mesh(devices="cpu")
        assert mesh.distributed and mesh.size == 1, mesh
        try:
            make_mesh(2, devices="cpu")
        except ValueError:
            print("N_DEVICES_RAISED")
        dist.destroy_process_group()
        print("MH_OK")
    """) % (str(ROOT), str(tmp_path / "rdv"))
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=300, cwd=ROOT)
    assert "RAISED_LOUDLY" in r.stdout, (r.stdout, r.stderr[-3000:])
    assert "N_DEVICES_RAISED" in r.stdout, (r.stdout, r.stderr[-3000:])
    assert "MH_OK" in r.stdout, (r.stdout, r.stderr[-3000:])


def test_mesh_checks_its_device_and_ranks():
    mesh = M.make_mesh(devices="cpu")
    assert mesh.shape == {"pop": 1} and mesh.is_writer
    with pytest.raises(ValueError):
        M.make_mesh(4, devices="cpu")
    t = torch.arange(12.0).reshape(6, 2)
    M.reset_gather_counts()
    got = mesh.gather(t)
    assert torch.equal(got, t) and got is not t
    assert M.gather_counts()["gathers"] == 1
    assert M.gather_counts()["gather_bytes"] == t.numel() * 4
    two = M.Mesh(rank=1, size=2, device="cpu")
    with pytest.raises(RuntimeError):
        two.gather(t)                      # two ranks need a process group
    v = {"input": {"z": t}, "output": {"target": t[:1]}}
    mine = M.shard_variables(v, two)
    assert torch.equal(mine["input"]["z"], t[3:])
    assert mine["output"]["target"] is v["output"]["target"]
    full = two.embed(mine["input"]["z"], 6)
    assert torch.equal(full[3:], t[3:]) and not full[:3].any()
    with pytest.raises(ValueError):
        M.shard_variables({"input": {"z": t[:5]}}, two)
    from pix2latent_tpu_torch.utils.device import same_device
    assert same_device("cpu", torch.device("cpu"))
    assert not same_device("cpu", "cuda:0")


def test_mesh_scaling_runs_as_one_rank(tmp_path, monkeypatch):
    """``utils/mesh_scaling.py`` without a process group: a one-rank mesh,
    whose generation equals the plain one bitwise."""
    from pix2latent_tpu_torch.utils import mesh_scaling
    for k in ("WORLD_SIZE", "RANK", "LOCAL_RANK", "MASTER_ADDR",
              "MASTER_PORT", "TORCHELASTIC_RUN_ID"):
        monkeypatch.delenv(k, raising=False)
    out = tmp_path / "mesh.json"
    res = mesh_scaling.main(["--device", "cpu", "--channel_width", "4",
                             "--generations", "0", "--steps", "1",
                             "--out", str(out)])
    assert res["ranks"] == 1 and res["population"] == 18
    assert res["gathers"]["gathers"] == 1 and res["tells_finite"]
    assert res["tell_max_rel_by_generation"] == [0.0]
    assert out.read_text().strip().startswith("{")


# --------------------------------------------------------------------- #
# the surface shared with the JAX package                                 #
# --------------------------------------------------------------------- #

def _positional(fn):
    return [p.name for p in inspect.signature(fn).parameters.values()
            if p.kind == p.POSITIONAL_OR_KEYWORD]


def test_constructors_take_mesh_at_the_jax_positions():
    from pix2latent_tpu.core.step import ExecutionCore as JaxCore
    from pix2latent_tpu.optimizers.base import _BaseOptimizer as JaxBase
    from pix2latent_tpu_torch.core.step import ExecutionCore
    from pix2latent_tpu_torch.optimizers.base import _BaseOptimizer
    want = _positional(JaxBase.__init__)
    assert _positional(_BaseOptimizer.__init__) == want
    assert want[:10] == ["self", "model", "var_manager", "loss_fn",
                         "max_batch_size", "log", "track_variables", "mesh",
                         "seed", "segment_steps"]
    device = inspect.signature(_BaseOptimizer.__init__).parameters["device"]
    assert device.kind == device.KEYWORD_ONLY
    assert _positional(ExecutionCore.__init__) == _positional(
        JaxCore.__init__)
    assert _positional(ExecutionCore.__init__)[4] == "mesh"


def test_utils_and_models_export_what_jax_does():
    import pix2latent_tpu.models as jax_models
    import pix2latent_tpu_torch.models as models
    import pix2latent_tpu_torch.utils as utils
    for name in ("image", "misc", "video"):
        assert getattr(utils, name).__name__ == \
            f"pix2latent_tpu_torch.utils.{name}"
    assert set(jax_models.__all__) - {"FlaxModel"} <= set(models.__all__)
    assert callable(models.FunctionModel) and callable(models.as_model)
    import pix2latent_tpu_torch.parallel as par
    from pix2latent_tpu import parallel as jax_par
    assert par.__all__ == jax_par.__all__


if __name__ == "__main__" and sys.argv[1:2] == ["--worker"]:
    rank, world, rdv, out = sys.argv[2:6]
    _worker(int(rank), int(world), rdv, out,
            sys.argv[6] if len(sys.argv) > 6 else None)
