"""The port's nine Adam, CMA and strategy-registry entry points against the
JAX package's examples:

- ``invert_biggan_{adam,cma,nevergrad,hybrid_nevergrad}.py``,
- ``invert_stylegan2_cars_{basincma,adam,cma,ng,hybrid_ng}.py``.

Each has the JAX example's flags plus ``--device`` and the JAX example's
schedules (full and ``--smoke``, read from the JAX example's source), and
the cars ones its ``log_resize_factor`` of 0.5. Each runs ``--smoke`` on the
CPU at a tiny size (BigGAN-deep-256's wrapper with the 128 px layout and 4
channels a layer; StyleGAN2-cars at 32 px with 8 channels a layer), with
and without ``--fused`` where it has one, the fused run resumed from its
checkpoint; one cars driver in both ``--search`` modes. Without ``--device
cpu`` each raises when no GPU is present."""

import argparse
import re
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from pix2latent_tpu_torch.examples import (
    common, invert_biggan_adam, invert_biggan_cma,
    invert_biggan_hybrid_nevergrad, invert_biggan_nevergrad,
    invert_stylegan2_cars_adam, invert_stylegan2_cars_basincma,
    invert_stylegan2_cars_cma, invert_stylegan2_cars_hybrid_ng,
    invert_stylegan2_cars_ng)
from pix2latent_tpu_torch.models import stylegan2 as S
from tests.test_torch_examples import one_thread, tiny_biggan  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]

EXAMPLES = {
    "invert_biggan_adam": invert_biggan_adam,
    "invert_biggan_cma": invert_biggan_cma,
    "invert_biggan_nevergrad": invert_biggan_nevergrad,
    "invert_biggan_hybrid_nevergrad": invert_biggan_hybrid_nevergrad,
    "invert_stylegan2_cars_basincma": invert_stylegan2_cars_basincma,
    "invert_stylegan2_cars_adam": invert_stylegan2_cars_adam,
    "invert_stylegan2_cars_cma": invert_stylegan2_cars_cma,
    "invert_stylegan2_cars_ng": invert_stylegan2_cars_ng,
    "invert_stylegan2_cars_hybrid_ng": invert_stylegan2_cars_hybrid_ng,
}


def _jax_src(name):
    return (ROOT / "examples" / f"{name}.py").read_text()


def _flags(parser):
    return {a.dest for a in parser._actions} - {"help"}


def _jax_common():
    jax_common = sys.modules.get("examples.common")
    if jax_common is None:
        sys.path.insert(0, str(ROOT))
        import examples.common as jax_common
    return jax_common


@pytest.mark.parametrize("name", sorted(EXAMPLES))
def test_flags_are_the_jax_examples_plus_device(name):
    # the JAX examples build their parsers inside main(): base_parser plus
    # the flags their own sources add
    src = _jax_src(name)
    own = set(re.findall(r'add_argument\(\s*"--(\w+)"', src))
    kind = "stylegan2" if 'model="stylegan2"' in src else "biggan"
    want = _flags(_jax_common().base_parser("", model=kind)) | own
    assert _flags(EXAMPLES[name].parser()) == want | {"device"}


def _jax_schedule(src, smoke):
    """The JAX example's budgets, read from its source: ``(population,
    steps)`` for Adam, ``(generations, steps)`` for the eval-only drivers,
    ``(generations, inner, final)`` for the hybrid ones."""
    pick = 0 if smoke else 1
    m = re.search(r"meta, grad = \((\d+), (\d+)\) if args\.smoke else "
                  r"\((\d+), (\d+)\)", src)
    if m:
        nums = tuple(map(int, m.groups()))
        return nums[2 * pick:2 * pick + 2]
    m = re.search(r"if args\.smoke:\s*meta, grad, last = (\d+), (\d+), (\d+)"
                  r"\s*else:\s*meta, grad, last = (\d+), (\d+), (\d+)", src)
    if m:
        nums = tuple(map(int, m.groups()))
        return nums[3 * pick:3 * pick + 3]
    pop = re.search(r"num_samples\s*=\s*(\d+) if args\.smoke else "
                    r"args\.num_samples", src)
    steps = re.search(r"grad_steps\s*=\s*(\d+) if args\.smoke else (\d+)", src)
    return (int(pop.group(1)) if smoke else 9, int(steps.group(1 + pick)))


@pytest.mark.parametrize("name", sorted(EXAMPLES))
def test_schedules_are_the_jax_examples(name):
    src = _jax_src(name)
    for smoke in (False, True):
        ns = argparse.Namespace(smoke=smoke, num_samples=9)
        assert EXAMPLES[name].schedule(ns) == _jax_schedule(src, smoke), smoke
    port_src = Path(EXAMPLES[name].__file__).read_text()
    assert ("log_resize_factor = 0.5" in port_src) == (
        "log_resize_factor = 0.5" in src)


def test_schedules_are_the_reference_budgets():
    full = {n: m.schedule(argparse.Namespace(smoke=False, num_samples=9))
            for n, m in EXAMPLES.items()}
    assert full["invert_biggan_hybrid_nevergrad"] == (30, 50, 300)
    assert full["invert_biggan_nevergrad"] == (1000, 300)
    assert full["invert_biggan_cma"] == (200, 300)
    assert full["invert_biggan_adam"] == (9, 500)
    assert full["invert_stylegan2_cars_basincma"] == (30, 30, 300)


@pytest.mark.parametrize("name", sorted(EXAMPLES))
def test_entry_points_need_a_device_without_cuda(name, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        EXAMPLES[name].main(["--smoke"])


@pytest.fixture
def tiny_cars(monkeypatch):
    monkeypatch.setitem(S.StyleGAN2.MODELS, "cars", 32)
    monkeypatch.setattr(S, "channels_for", lambda res, cm=2: 8)


def _result(path):
    return dict(np.load(path / "result.npz"))


# (example, extra flags, population, steps of the result, generations)
BIGGAN_RUNS = [
    ("invert_biggan_adam", [], 4, 20, None),
    ("invert_biggan_cma", ["--active_cma"], 18, 5 + 10, 5),
    ("invert_biggan_nevergrad", ["--ng_method", "TBPSA"], 9, 5 + 10, 5),
    ("invert_biggan_hybrid_nevergrad", [], 9, 2 * 5 + 10, 2),
    ("invert_biggan_hybrid_nevergrad", ["--ng_method", "DiagonalCMA",
                                        "--num_samples", "6"], 6, 2 * 5 + 10,
     2),
]


@pytest.mark.parametrize("name,extra,pop,steps,gens", BIGGAN_RUNS)
def test_biggan_smoke_runs(tiny_biggan, tmp_path, name, extra, pop, steps,
                           gens):
    EXAMPLES[name].main(["--device", "cpu", "--smoke", "--save_dir",
                         str(tmp_path)] + extra)
    result = _result(tmp_path)
    assert result["variables/input/z"].shape == (pop, 128)
    assert result["variables/output/target"].shape[-3:] == (128, 128, 3)
    assert result["loss"].shape == (pop,) and np.isfinite(result["loss"]).all()
    assert result["loss_step"] == steps
    if gens is not None:
        assert result["tell_min"].shape == (gens,)
        assert np.isfinite(result["tell_min"]).all()
    # the host loops keep the variables of every inner step
    assert result["tracked/z"].shape[1:] == (pop, 128)


# (example, extra flags, population, steps, generations, resume labels)
FUSED_RUNS = [
    ("invert_biggan_cma", [], 18, 5 + 10, 5, "cma fused"),
    ("invert_biggan_nevergrad", ["--ng_method", "TBPSA"], 9, 5 + 10, 5,
     "fused eval-only TBPSA"),
    ("invert_biggan_hybrid_nevergrad", [], 9, 2 * 5 + 10, 2,
     "fused hybrid-CMA"),
]


def _fused_and_resumed(main, args, tmp_path, capsys, label, final_steps):
    main(args)
    first = _result(tmp_path)
    assert (tmp_path / "run.npz.final").exists()
    capsys.readouterr()
    main(args)                      # everything is on disk: no step runs
    out = capsys.readouterr().out
    assert f"resumed {label} at generation" in out
    assert f"resumed gradient run at step {final_steps}/{final_steps}" in out
    again = _result(tmp_path)
    np.testing.assert_array_equal(again["variables/input/z"],
                                  first["variables/input/z"])
    return first


@pytest.mark.parametrize("name,extra,pop,steps,gens,label", FUSED_RUNS)
def test_biggan_fused_runs_resume(tiny_biggan, tmp_path, capsys, name, extra,
                                  pop, steps, gens, label):
    args = ["--device", "cpu", "--smoke", "--fused", "--save_dir",
            str(tmp_path), "--resume", str(tmp_path / "run.npz")] + extra
    final = EXAMPLES[name].schedule(argparse.Namespace(smoke=True))[-1]
    first = _fused_and_resumed(EXAMPLES[name].main, args, tmp_path, capsys,
                               label, final)
    assert first["variables/input/z"].shape == (pop, 128)
    assert first["loss_step"] == steps
    assert first["tell_min"].shape == (gens,)
    assert np.isfinite(first["loss"]).all()


CARS_RUNS = [
    ("invert_stylegan2_cars_basincma", [], 22, 2 * 4 + 8, 2),
    ("invert_stylegan2_cars_adam", [], 4, 10, None),
    ("invert_stylegan2_cars_cma", [], 22, 3 + 8, 3),
    ("invert_stylegan2_cars_ng", ["--ng_method", "DiagonalCMA"], 9, 3 + 8, 3),
    ("invert_stylegan2_cars_hybrid_ng", ["--ng_method", "LMMAES"], 9,
     2 * 4 + 8, 2),
    ("invert_stylegan2_cars_hybrid_ng", ["--ng_method", "LMMAES", "--search",
                                         "w+"], 9, 2 * 4 + 8, 2),
]


@pytest.mark.parametrize("name,extra,pop,steps,gens", CARS_RUNS)
def test_cars_smoke_runs(tiny_cars, tmp_path, name, extra, pop, steps, gens):
    EXAMPLES[name].main(["--device", "cpu", "--smoke", "--save_dir",
                         str(tmp_path)] + extra)
    result = _result(tmp_path)
    assert result["variables/input/z"].shape == (pop, 512)
    assert result["variables/output/loss_mask"].shape[-3:] == (32, 32, 3)
    assert result["loss"].shape == (pop,) and np.isfinite(result["loss"]).all()
    assert result["loss_step"] == steps
    if gens is not None:
        assert result["tell_min"].shape == (gens,)
    if "w+" in extra:
        # the w search also refines the noise maps by Adam
        assert "variables/input/noises" in result


@pytest.mark.parametrize("name,extra,label", [
    ("invert_stylegan2_cars_basincma", [], "basin-cma fused"),
    ("invert_stylegan2_cars_cma", [], "cma fused"),
    ("invert_stylegan2_cars_ng", ["--ng_method", "DiagonalCMA"],
     "fused eval-only DiagonalCMA"),
    ("invert_stylegan2_cars_hybrid_ng", ["--ng_method", "TBPSA", "--search",
                                         "w+"], "fused hybrid-TBPSA"),
])
def test_cars_fused_runs_resume(tiny_cars, tmp_path, capsys, name, extra,
                                label):
    args = ["--device", "cpu", "--smoke", "--fused", "--save_dir",
            str(tmp_path), "--resume", str(tmp_path / "run.npz")] + extra
    final = EXAMPLES[name].schedule(argparse.Namespace(smoke=True))[-1]
    first = _fused_and_resumed(EXAMPLES[name].main, args, tmp_path, capsys,
                               label, final)
    assert np.isfinite(first["loss"]).all()
    assert np.isfinite(first["tell_min"]).all()


def test_stylegan2_problem_registers_the_cars_mask(tiny_cars):
    args = common.base_parser("", model="stylegan2").parse_args(
        ["--device", "cpu"])
    args.grad_free = True
    model, vm = common.stylegan2_problem(args)
    mask = vm.variable_info["loss_mask"]["default"].numpy()
    np.testing.assert_array_equal(mask, common.cars_loss_mask(32))
    assert model.im_res == 32 and vm.grad_free_variables()[0][1] == "z"
