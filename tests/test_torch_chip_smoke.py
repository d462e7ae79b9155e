"""The problems ``chip_smoke.py``'s phases build, on the CPU in float32.

``main_path`` and ``whole_step`` drive the BigGAN problem, ``sg2_path`` and
``sg2_whole_step`` the cars one, ``ffhq_path`` and ``ffhq_whole_step`` the
FFHQ one: each must register the variables those phases read, with the
ramp target, the cars border mask of the entry points for cars alone, and
FFHQ's recompute from 256 px.
"""

import numpy as np
import pytest
import torch

import chip_smoke as CS
from pix2latent_tpu_torch.examples.common import cars_loss_mask

# name: (builder, image size, searched inputs and their sizes)
PROBLEMS = {"biggan": (CS._build_biggan, 256, {"z": 128, "c": 128}),
            "cars": (CS._build_stylegan2, 512, {"z": 512}),
            "ffhq": (CS._build_ffhq, 1024, {"z": 512})}


@pytest.mark.parametrize("name", sorted(PROBLEMS))
def test_smoke_problem_registers_what_its_phases_read(name):
    builder, res, inputs = PROBLEMS[name]
    model, loss_fn, vm = builder(torch.float32, "cpu")
    variables = vm.initialize(2)
    assert {k: v.shape[1:] for k, v in variables["input"].items()} == {
        k: (d,) for k, d in inputs.items()}
    outputs = {k: v.numpy() for k, v in variables["output"].items()}
    want = {"target": CS._ramp_target(res),
            "weight": np.ones((res, res, 3), np.float32)}
    if name == "cars":
        want["loss_mask"] = cars_loss_mask(512)
    assert sorted(outputs) == sorted(want)
    for key, value in want.items():
        assert outputs[key].shape == (2, res, res, 3), key
        np.testing.assert_array_equal(outputs[key][0], value, err_msg=key)
    assert float(want["target"].min()) == -1.0
    assert float(want["target"].max()) == 1.0
    if name == "biggan":
        assert np.all(np.abs(variables["input"]["z"].numpy()) <= 2.0)
        np.testing.assert_array_equal(variables["input"]["c"].numpy(), 0.0)
    else:
        assert model.im_res == res
        assert model.generator.remat_from_res == (
            CS.FFHQ_RECIPE["remat_from_res"] if name == "ffhq" else 0)
    assert next(model.parameters()).dtype == torch.float32
