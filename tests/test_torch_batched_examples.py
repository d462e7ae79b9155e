"""The port's two batched entry points
(``pix2latent_tpu_torch/examples/invert_biggan_batched.py`` and
``invert_biggan_transform_batched.py``) against the JAX package's examples:
the JAX examples' flags plus ``--device`` and their schedules, and a run of
each at ``--smoke`` on the CPU at a tiny size (the BigGAN-deep-256 wrapper
with the 32 px layout of ``tests/test_torch_example_inputs.py`` and 4
channels a layer, bfloat16 as the examples build it), the first on PNG
targets read with ``--fps``."""

import argparse
import re
from pathlib import Path

import numpy as np

from pix2latent_tpu_torch.examples import invert_biggan_batched as batched
from pix2latent_tpu_torch.examples import \
    invert_biggan_transform_batched as tf_batched
from tests.test_torch_example_inputs import _png, small_biggan  # noqa: F401
from tests.test_torch_examples import _flags, one_thread  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]


def _jax_flags(name):
    src = (ROOT / "examples" / name).read_text()
    return set(re.findall(r'add_argument\(\s*"--(\w+)"', src))


def test_batched_flags_and_schedules_are_the_jax_examples():
    assert _flags(batched.parser()) == _jax_flags(
        "invert_biggan_batched.py") | {"device"}
    assert _flags(tf_batched.parser()) == _jax_flags(
        "invert_biggan_transform_batched.py") | {"device"}
    assert batched.schedule(argparse.Namespace(smoke=True)) == (2, 5, 10)
    assert batched.schedule(argparse.Namespace(smoke=False)) == (30, 30, 300)
    assert tf_batched.schedule(argparse.Namespace(smoke=True)) == (
        (3, 3), (2, 3, 5))
    assert tf_batched.schedule(argparse.Namespace(smoke=False)) == (
        (50, 10), (30, 30, 300))


def test_batched_example_runs_on_png_targets(small_biggan, tmp_path):
    fps = [_png(tmp_path / f"t{i}.png", 32, seed=10 + i) for i in range(2)]
    save = tmp_path / "out"
    run = batched.main(["--device", "cpu", "--smoke", "--fps", *fps,
                        "--class_lbls", "1", "2", "--max_batch_size", "18",
                        "--save_dir", str(save)])
    res = run["result"]
    assert tuple(res["z"].shape) == (2, 128)
    assert tuple(res["out"].shape) == (2, 32, 32, 3)
    assert res["loss_curves"].shape == (2, 2)
    assert np.isfinite(res["loss_curves"]).all()
    for i in range(2):
        assert (save / f"out_{i}.jpg").exists()
        assert (save / f"target_{i}.jpg").exists()
    saved = np.load(save / "results.npy", allow_pickle=True).item()
    assert saved["loss"].shape == (2,)


def test_transform_batched_example_runs_both_phases(small_biggan, tmp_path,
                                                    capsys):
    save = tmp_path / "out"
    run = tf_batched.main(["--device", "cpu", "--smoke", "--save_dir",
                           str(save)])
    assert "best transforms:" in capsys.readouterr().out
    search, res = run["search"], run["result"]
    assert search["candidate"].shape == (2, 3)
    assert search["loss_curves"].shape == (3, 2)
    assert np.isfinite(search["best_loss"]).all()
    assert res["loss_curves"].shape == (2, 2)
    assert np.isfinite(res["loss_curves"]).all()
    assert tuple(res["out"].shape) == (2, 32, 32, 3)
    assert (save / "aligned_target_1.jpg").exists()
