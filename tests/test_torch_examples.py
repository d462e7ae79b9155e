"""The port's FFHQ BasinCMA entry point
(``pix2latent_tpu_torch/examples/invert_stylegan2_ffhq_basincma.py``)
against the JAX package's example: the same memory recipe on the same
arguments (``tests/test_examples.py`` test_ffhq_recipe_defaults), the same
flags, and an end-to-end run on the CPU at a tiny size (the FFHQ wrapper at
64 px with 8 channels a layer), fused and resumed from its checkpoint."""

import argparse
import importlib.util
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from pix2latent_tpu_torch.examples import common
from pix2latent_tpu_torch.examples import \
    invert_stylegan2_ffhq_basincma as ffhq
from pix2latent_tpu_torch.models import stylegan2 as S

ROOT = Path(__file__).resolve().parents[1]


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


def test_flags_are_the_jax_examples_plus_device():
    jax_common = sys.modules.get("examples.common")
    if jax_common is None:
        sys.path.insert(0, str(ROOT))
        import examples.common as jax_common
    want = _flags(jax_common.base_parser("", model="stylegan2"))
    got = _flags(common.base_parser("", model="stylegan2"))
    assert got == want | {"device"}


@pytest.fixture
def tiny_ffhq(monkeypatch):
    monkeypatch.setitem(S.StyleGAN2.MODELS, "ffhq", 64)
    monkeypatch.setattr(S, "channels_for", lambda res, cm=2: 8)


@pytest.mark.parametrize("flag", ["--fp=x.png", "--mask_fp=m.png",
                                  "--make_video"])
def test_codec_options_are_not_ported_yet(tiny_ffhq, flag):
    with pytest.raises(NotImplementedError, match="not ported yet"):
        ffhq.main(["--device", "cpu", "--smoke", "--no_recipe", flag])


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
