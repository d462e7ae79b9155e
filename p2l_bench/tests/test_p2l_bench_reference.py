"""The plain reference agrees with ``pix2latent_tpu_torch`` at a small
width on the CPU: the generators' images and the loss on the same weights,
then the first two generations of each configuration's driver (each's
first inner steps and tell, and the second's CMA update from the program's
state) against the reference. The test imports both; the
reference imports nothing of the port."""

import pytest
import torch

from p2l_bench.calibrate import judged
from p2l_bench.harness import spec
from p2l_bench.tests import tiny

CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("cell", ["biggan256-basincma", "cars512-basincma"])
def test_images_and_loss(cell, monkeypatch):
    _, cfg = tiny.cell(cell, monkeypatch)
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


@pytest.mark.parametrize("cell", ["biggan256-basincma", "cars512-basincma",
                                  "biggan256-cma-evalonly"])
def test_one_generation(cell, monkeypatch):
    wl, cfg = tiny.cell(cell, monkeypatch)
    run = judged(wl, cfg, 11, CPU, None)
    readings = run.readings()
    assert set(readings) >= set(wl["checks"]) - {"noise_gap"}
    for name, value in readings.items():
        assert value < tiny.LIMITS.get(name, 1e-4), (name, value)
