"""The port's FFHQ BasinCMA entry point
(``pix2latent_tpu_torch/examples/invert_stylegan2_ffhq_basincma.py``)
against the JAX package's example: the same memory recipe on the same
arguments (``tests/test_examples.py`` test_ffhq_recipe_defaults), the same
flags, and an end-to-end run on the CPU at a tiny size (the FFHQ wrapper at
64 px with 8 channels a layer), fused and resumed from its checkpoint.

The BigGAN BasinCMA entry point
(``pix2latent_tpu_torch/examples/invert_biggan_basincma.py``) likewise: the
JAX example's flags plus ``--device``, the same variable registration as
the JAX package's ``register_biggan_vars``, and a run on the CPU at a tiny
size (the BigGAN-deep-256 wrapper with the 128 px layout and 4 channels a
layer), through both drivers, resumed from its checkpoint.

The sharded BigGAN entry point
(``pix2latent_tpu_torch/examples/invert_biggan_basincma_sharded.py``): the
JAX example's flags plus ``--device`` and its schedules, and a run as one
rank on the CPU at the same tiny size.

The BigGAN entry point with the transform search
(``pix2latent_tpu_torch/examples/invert_biggan_with_transform.py``): the JAX
example's flags plus ``--device`` and its schedules, both phases on the CPU
at the same tiny size for each ``--method``, with and without ``--fused``
and ``--color_transform``, and the mask's pre-alignment through the API."""

import argparse
import importlib.util
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from pix2latent_tpu_torch import VariableManager
from pix2latent_tpu_torch.examples import common
from pix2latent_tpu_torch.examples import invert_biggan_basincma as bg
from pix2latent_tpu_torch.examples import \
    invert_biggan_basincma_sharded as sharded
from pix2latent_tpu_torch.examples import \
    invert_biggan_with_transform as tf_ex
from pix2latent_tpu_torch.examples import \
    invert_stylegan2_ffhq_basincma as ffhq
from pix2latent_tpu_torch.models import biggan as B
from pix2latent_tpu_torch.models import stylegan2 as S

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread per test, the process's setting restored after:
    with a thread per core in every test worker, the many small operations
    of these runs wait on the other workers' threads, many times slower
    than on one."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_example():
    spec = importlib.util.spec_from_file_location(
        "ffhq_example", ROOT / "examples" / "invert_stylegan2_ffhq_basincma.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _ns(**kw):
    base = dict(model="ffhq", no_recipe=False, bf16=False, remat_from_res=0,
                max_minibatch=None)
    base.update(kw)
    return argparse.Namespace(**base)


@pytest.mark.parametrize("kw", [{}, dict(remat_from_res=512, max_minibatch=4),
                                dict(no_recipe=True), dict(model="cars")])
def test_ffhq_recipe_matches_jax(kw):
    want = vars(_jax_example().apply_ffhq_recipe(_ns(**kw)))
    got = vars(ffhq.apply_ffhq_recipe(_ns(**kw)))
    assert got == want
    if not kw:
        assert (got["bf16"], got["remat_from_res"], got["max_minibatch"]) == \
            (True, 256, 2)


def _flags(parser):
    return {a.dest for a in parser._actions} - {"help"}


def _jax_common():
    jax_common = sys.modules.get("examples.common")
    if jax_common is None:
        sys.path.insert(0, str(ROOT))
        import examples.common as jax_common
    return jax_common


def test_flags_are_the_jax_examples_plus_device():
    jax_common = _jax_common()
    want = _flags(jax_common.base_parser("", model="stylegan2"))
    got = _flags(common.base_parser("", model="stylegan2"))
    assert got == want | {"device"}


@pytest.fixture
def tiny_ffhq(monkeypatch):
    monkeypatch.setitem(S.StyleGAN2.MODELS, "ffhq", 64)
    monkeypatch.setattr(S, "channels_for", lambda res, cm=2: 8)


def test_fused_run_writes_results_and_resumes(tiny_ffhq, tmp_path, capsys):
    # without the recipe: bf16 convolutions and 11 microbatches are slow on
    # the CPU
    args = ["--device", "cpu", "--smoke", "--no_recipe", "--fused",
            "--save_dir", str(tmp_path), "--resume", str(tmp_path / "run.npz")]
    ffhq.main(args)
    first = dict(np.load(tmp_path / "result.npz"))
    assert first["variables/input/z"].shape == (22, 512)
    assert first["loss"].shape == (22,) and first["loss_step"] == 2 * 4 + 8
    assert first["tell_min"].shape == (2,)
    assert os.path.exists(tmp_path / "run.npz.final")
    capsys.readouterr()

    ffhq.main(args)                   # everything is on disk: no step runs
    out = capsys.readouterr().out
    assert "resumed basin-cma fused at generation 2" in out
    assert "resumed gradient run at step 8/8" in out
    again = dict(np.load(tmp_path / "result.npz"))
    np.testing.assert_array_equal(again["variables/input/z"],
                                  first["variables/input/z"])


def test_host_loop_run_tracks_variables(tiny_ffhq, tmp_path):
    ffhq.main(["--device", "cpu", "--smoke", "--no_recipe", "--save_dir",
               str(tmp_path)])
    result = np.load(tmp_path / "result.npz")
    assert result["tracked/z"].shape == (2 * 4 + 8, 22, 512)


def test_help_exits_zero():
    proc = subprocess.run(
        [sys.executable, "-m",
         "pix2latent_tpu_torch.examples.invert_stylegan2_ffhq_basincma",
         "--help"], cwd=ROOT, capture_output=True, timeout=120)
    assert proc.returncode == 0, proc.stderr.decode()[-800:]
    assert b"--remat_from_res" in proc.stdout and b"--device" in proc.stdout


# --------------------------------------------------------------------- #
# BigGAN BasinCMA                                                         #
# --------------------------------------------------------------------- #

def test_biggan_flags_are_the_jax_examples_plus_device():
    # the JAX example builds its parser inside main(): base_parser plus the
    # flags its own source adds
    src = (ROOT / "examples" / "invert_biggan_basincma.py").read_text()
    own = set(re.findall(r'add_argument\(\s*"--(\w+)"', src))
    assert own == {"resume", "fused"}
    want = _flags(_jax_common().base_parser("")) | own
    assert _flags(bg.parser()) == want | {"device"}
    assert bg.schedule(argparse.Namespace(smoke=False)) == (30, 30, 300)
    assert bg.schedule(argparse.Namespace(smoke=True)) == (2, 5, 10)


class _Embedder:
    """A model with a fixed class embedding, for the registrations."""

    def __init__(self, emb, to):
        self.emb, self.to = emb, to

    def get_class_embedding(self, cls):
        return self.to(self.emb[cls % 4][None])


def _spec(info):
    dist, hook = info["distribution"], info["hook_fn"]
    default = info["default"]
    return {"shape": tuple(info["shape"]), "var_type": info["var_type"],
            "requires_grad": bool(info["requires_grad"]),
            "learning_rate": float(info["learning_rate"]),
            "grad_free": info["grad_free"],
            "distribution": None if dist is None else (
                type(dist).__name__, float(dist.sigma), float(dist.trunc)),
            "hook": None if hook is None else (type(hook).__name__,
                                               float(hook.trunc)),
            "default": None if default is None else np.asarray(
                default.cpu() if hasattr(default, "cpu") else default)}


def test_register_biggan_vars_matches_jax():
    import jax.numpy as jnp

    from pix2latent_tpu import VariableManager as JaxVariableManager
    rng = np.random.RandomState(0)
    emb = rng.randn(4, 128).astype(np.float32)
    target = rng.rand(8, 8, 3).astype(np.float32)
    weight = np.ones((8, 8, 3), np.float32)
    args = argparse.Namespace(class_lbl=153, lr=0.05, truncate=1.5,
                              grad_free=True)
    want = _jax_common().register_biggan_vars(
        JaxVariableManager(), _Embedder(emb, jnp.asarray), args,
        jnp.asarray(target), jnp.asarray(weight))
    got = common.register_biggan_vars(
        VariableManager(device="cpu"), _Embedder(emb, torch.tensor), args,
        torch.tensor(target), torch.tensor(weight))
    assert list(got.variable_info) == list(want.variable_info) == [
        "z", "c", "target", "weight"]
    for name in want.variable_info:
        a, b = _spec(got.variable_info[name]), _spec(want.variable_info[name])
        da, db = a.pop("default"), b.pop("default")
        assert a == b, name
        if db is None:
            assert da is None, name
        else:
            np.testing.assert_array_equal(da, db, err_msg=name)
    assert _spec(got.variable_info["z"])["distribution"] == (
        "TruncatedNormalModulo", 1.0, 1.5)
    assert _spec(got.variable_info["c"])["learning_rate"] == 0.01


@pytest.fixture
def tiny_biggan(monkeypatch):
    class TinyBigGAN(B.BigGAN):
        def __init__(self, *args, **kwargs):
            kwargs.setdefault("channel_width", 4)
            super().__init__(*args, **kwargs)

    monkeypatch.setattr(B, "BigGAN", TinyBigGAN)
    monkeypatch.setitem(B.BIGGAN_CONFIGS, "biggan-deep-256",
                        B.BIGGAN_CONFIGS["biggan-deep-128"])


def test_biggan_fused_run_writes_results_and_resumes(tiny_biggan, tmp_path,
                                                     capsys):
    args = ["--device", "cpu", "--smoke", "--fused", "--save_dir",
            str(tmp_path), "--resume", str(tmp_path / "run.npz")]
    bg.main(args)
    first = dict(np.load(tmp_path / "result.npz"))
    assert first["variables/input/z"].shape == (18, 128)
    assert first["variables/input/c"].shape == (18, 128)
    assert first["variables/output/target"].shape[-3:] == (128, 128, 3)
    assert first["loss"].shape == (18,) and first["loss_step"] == 2 * 5 + 10
    assert first["tell_min"].shape == (2,)
    assert np.isfinite(first["loss"]).all()
    assert os.path.exists(tmp_path / "run.npz.final")
    capsys.readouterr()

    bg.main(args)                     # everything is on disk: no step runs
    out = capsys.readouterr().out
    assert "resumed basin-cma fused at generation 2" in out
    assert "resumed gradient run at step 10/10" in out
    again = dict(np.load(tmp_path / "result.npz"))
    for key in ("variables/input/z", "variables/input/c"):
        np.testing.assert_array_equal(again[key], first[key])


def test_biggan_host_loop_run_writes_results(tiny_biggan, tmp_path):
    bg.main(["--device", "cpu", "--smoke", "--save_dir", str(tmp_path)])
    result = np.load(tmp_path / "result.npz")
    assert result["variables/input/z"].shape == (18, 128)
    assert result["tell_min"].shape == (2,)
    assert np.isfinite(result["loss"]).all()
    assert result["tracked/z"].shape == (2 * 5 + 10, 18, 128)


# --------------------------------------------------------------------- #
# BigGAN with the population split across cards                           #
# --------------------------------------------------------------------- #

def test_sharded_flags_and_schedules_are_the_jax_examples():
    src = (ROOT / "examples" / "invert_biggan_basincma_sharded.py").read_text()
    own = set(re.findall(r'add_argument\(\s*"--(\w+)"', src))
    assert own == {"n_devices"}
    want = _flags(_jax_common().base_parser("")) | own
    assert _flags(sharded.parser()) == want | {"device"}
    assert "meta, grad, last = 2, 4, 8" in src
    assert "meta, grad, last = 30, 30, 300" in src
    assert sharded.schedule(argparse.Namespace(smoke=True)) == (2, 4, 8)
    assert sharded.schedule(argparse.Namespace(smoke=False)) == (30, 30, 300)


def test_sharded_run_writes_results(tiny_biggan, tmp_path, monkeypatch,
                                    capsys):
    """Without a process group the example runs as one rank."""
    for k in ("WORLD_SIZE", "RANK", "LOCAL_RANK", "MASTER_ADDR",
              "MASTER_PORT", "TORCHELASTIC_RUN_ID"):
        monkeypatch.delenv(k, raising=False)
    sharded.main(["--device", "cpu", "--smoke", "--n_devices", "1",
                  "--save_dir", str(tmp_path)])
    assert "population mesh: 1 rank(s)" in capsys.readouterr().out
    result = np.load(tmp_path / "result.npz")
    assert result["variables/input/z"].shape == (18, 128)
    assert result["variables/input/c"].shape == (18, 128)
    assert result["loss"].shape == (18,) and result["loss_step"] == 2 * 4 + 8
    assert result["tell_min"].shape == (2,)
    assert np.isfinite(result["loss"]).all()
    assert result["tracked/z"].shape == (2 * 4 + 8, 18, 128)
    with pytest.raises(ValueError):
        sharded.main(["--device", "cpu", "--smoke", "--n_devices", "2",
                      "--save_dir", str(tmp_path)])


# --------------------------------------------------------------------- #
# BigGAN with the transform search                                        #
# --------------------------------------------------------------------- #

def test_transform_flags_and_schedules_are_the_jax_examples():
    src = (ROOT / "examples" / "invert_biggan_with_transform.py").read_text()
    own = set(re.findall(r'add_argument\(\s*"--(\w+)"', src))
    assert own == {"method", "color_transform", "fused"}
    want = _flags(_jax_common().base_parser("")) | own
    assert _flags(tf_ex.parser()) == want | {"device"}
    full = {m: tf_ex.schedule(argparse.Namespace(smoke=False, method=m))
            for m in ("adam", "cma", "basincma")}
    smoke = {m: tf_ex.schedule(argparse.Namespace(smoke=True, method=m))
             for m in ("adam", "cma", "basincma")}
    assert full == {"adam": ((50, 10), (500,)), "cma": ((50, 10), (200, 300)),
                    "basincma": ((50, 10), (30, 30, 300))}
    assert smoke == {"adam": ((3, 4), (20,)), "cma": ((3, 4), (3, 10)),
                     "basincma": ((3, 4), (2, 4, 8))}


@pytest.mark.parametrize("method,extra", [
    ("adam", []), ("cma", ["--fused"]),
    ("basincma", ["--color_transform", "hue,brightness"]),
    ("basincma", ["--fused", "--color_transform", "hue,brightness"])])
def test_transform_example_runs_both_phases(tiny_biggan, tmp_path, capsys,
                                            method, extra):
    tf_ex.main(["--device", "cpu", "--smoke", "--method", method,
                "--save_dir", str(tmp_path)] + extra)
    out = capsys.readouterr().out
    assert "best transform:" in out
    result = dict(np.load(tmp_path / "result.npz"))
    pop = {"adam": 9, "cma": 18, "basincma": 18}[method]
    t = result["variables/transform/t"]
    assert t.shape == (pop, 5 if extra[-1:] == ["hue,brightness"] else 3)
    # phase 2 runs with the frozen candidate in every row
    np.testing.assert_array_equal(t, np.broadcast_to(t[0], t.shape))
    assert result["variables/output/target"].shape == (pop, 128, 128, 3)
    assert result["variables/input/z"].shape == (pop, 128)
    assert np.isfinite(result["loss"]).all()
    steps = {"adam": 20, "cma": 3 + 10, "basincma": 2 * 4 + 8}[method]
    assert result["loss_step"] == steps
    if method != "adam":
        assert result["tell_min"].shape == ({"cma": 3, "basincma": 2}[method],)
        assert np.isfinite(result["tell_min"]).all()


def test_transform_example_needs_a_device_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tf_ex.main(["--smoke"])


def test_transform_example_pre_aligns_to_a_mask():
    # the alignment of --mask_fp through the API, against the JAX package's
    from pix2latent_tpu.transform.utils import compute_pre_alignment
    mask = np.zeros((64, 64, 3), np.float32)
    mask[10:40, 20:60] = 1.0
    for colors in ("", "hue"):
        vm = VariableManager(device="cpu")
        args = argparse.Namespace(color_transform=colors, device="cpu")
        target_tf, weight_tf = tf_ex.build_transforms(vm, args, mask=mask)
        spatial = (target_tf.transform_list[0][0] if colors else target_tf)
        np.testing.assert_allclose(spatial.t,
                                   np.asarray(compute_pre_alignment(mask)),
                                   rtol=1e-6)
        assert vm.variable_info["t"]["var_type"] == "transform"
        assert vm.variable_info["t"]["shape"] == ((4,) if colors else (3,))
