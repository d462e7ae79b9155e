"""The FFHQ configuration (``configs/stylegan2-ffhq-1024.json``, family
``problems/stylegan2_ffhq.py``) at 32 px on the CPU: the port's model
patched to 32 px with ``tiny.SG2_CHANNELS`` and ``remat_from_res`` 16, so
the blocks at 16 and 32 px are recomputed in the backward as those from
256 px are at full size. Against the plain reference: the images and the
loss, then the first two generations; the cell end to end, traced and not,
and with a fault planted; and the family's module loads no JAX."""

import subprocess
import sys
import time

import pytest
import torch

from p2l_bench import run as run_cli
from p2l_bench.calibrate import judged
from p2l_bench.harness import cell as cell_mod
from p2l_bench.harness import env, spec
from p2l_bench.harness.faults import planted
from p2l_bench.harness.spec import ROOT
from p2l_bench.tests import tiny

CPU = torch.device("cpu")
BENCH = spec.benchmark()
CELL = "ffhq1024-basincma"


@pytest.fixture(autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def ffhq(monkeypatch):
    """``(workload, config)`` of the cell at 32 px: 3 generations of 4
    steps, then 2 final steps; the cell's checks at ``tiny``'s limits."""
    import pix2latent_tpu_torch.models.stylegan2 as sg2
    wl = spec.workload(CELL)
    cfg = spec.config(wl["config"])
    cfg.update(im_res=32, channels=tiny.SG2_CHANNELS, remat_from_res=16)
    monkeypatch.setattr(sg2, "channels_for",
                        lambda res, cm=2: tiny.SG2_CHANNELS[str(res)])
    monkeypatch.setattr(sg2.StyleGAN2, "MODELS", {"ffhq": 32})
    wl["optimize"] = {"meta_steps": 3, "grad_steps": 4,
                      "last_grad_steps": 2}
    wl["trace_generations"] = 1
    wl["checks"] = {n: tiny.LIMITS.get(n, 1e-4) for n in wl["checks"]}
    return wl, cfg


def test_the_model_is_built_as_the_entry_point_builds_it(ffhq):
    _, cfg = ffhq
    problem = spec.problem(cfg["problem"])
    inputs = problem.make_inputs(cfg, 3, CPU, 2)
    assert "loss_mask" not in inputs
    model, vm, _ = problem.build(cfg, inputs, CPU)
    assert model.generator.remat_from_res == 16
    assert model.im_res == 32 and model.search == "z"
    assert "loss_mask" not in vm.defaults("output")
    assert next(model.parameters()).dtype == torch.float32


def test_images_and_loss(ffhq):
    _, cfg = ffhq
    problem = spec.problem(cfg["problem"])
    inputs = problem.make_inputs(cfg, 5, CPU, 3)
    model, vm, loss_fn = problem.build(cfg, inputs, CPU)
    ref = problem.Reference(cfg, inputs)
    leaves = problem.start(cfg, inputs, range(3))
    with torch.no_grad():
        got = model(**leaves)
        want = ref.images(leaves)
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
        outputs = {n: t[None] for n, t in vm.defaults("output").items()}
        torch.testing.assert_close(loss_fn(got, **outputs),
                                   ref.loss_fn(want), rtol=1e-5, atol=1e-6)
    # the gradient through the recomputed blocks against the reference's
    z = leaves["z"].clone().requires_grad_(True)
    model(z=z).square().sum().backward()
    zr = leaves["z"].clone().requires_grad_(True)
    ref.images({"z": zr}).square().sum().backward()
    torch.testing.assert_close(z.grad, zr.grad, rtol=1e-4,
                               atol=1e-5 * float(zr.grad.abs().max()))


def test_two_generations(ffhq):
    wl, cfg = ffhq
    run = judged(wl, cfg, 11, CPU, None)
    readings = run.readings()
    assert set(readings) == set(wl["checks"])
    for name, value in readings.items():
        assert value < tiny.LIMITS.get(name, 1e-4), (name, value)


def _line(wl, cfg, traced, fault=None):
    with planted(fault):
        out = cell_mod.measure(wl, cfg, 2 ** 31 + 17,
                               15.0 if traced else 10.0, traced, CPU,
                               time.time(), BENCH)
    return run_cli.result_line(wl, cfg, BENCH, out, traced,
                               {"name": "cpu"}, 1)


@pytest.mark.parametrize("traced", [False, True])
def test_cell_end_to_end(ffhq, traced):
    wl, cfg = ffhq
    line = _line(wl, cfg, traced)
    assert line["correct"], (line["attempted"], line["checks"])
    assert line["attempted"] >= 1 and line["failed"] == 0
    names = {m["name"] for m in spec.cell_metrics(BENCH, CELL, traced)}
    if traced:
        assert set(line["metrics"]) <= names
        assert line["metrics"]["recompute_ms.basincma"]["value"] > 0
        assert {"step_ms.basincma", "blur_roofline.basincma",
                "modconv_roofline.basincma"} <= set(line["metrics"])
    else:
        assert set(line["metrics"]) == names == {"images_per_s", "setup_s"}


@pytest.mark.parametrize("fault", ["half_batch", "answer"])
def test_fault_is_not_correct(ffhq, fault):
    wl, cfg = ffhq
    line = _line(wl, cfg, False, fault)
    assert any(c["value"] is None or c["value"] > c["limit"]
               for c in line["checks"].values()), line["checks"]
    assert not line["correct"]


def test_the_family_loads_no_jax_and_nothing_of_the_port():
    code = ("import sys, p2l_bench.problems.stylegan2_ffhq; "
            "print(sorted({n.split('.')[0] for n in sys.modules}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, text=True,
                         capture_output=True, check=True)
    loaded = set(eval(out.stdout.strip().splitlines()[-1]))
    assert "p2l_bench" in loaded
    assert not loaded & (set(env.FORBIDDEN) | {"pix2latent_tpu_torch"})
