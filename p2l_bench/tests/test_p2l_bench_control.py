"""On the card: at each one-card cell's own size, the program's readings
pass the cell's limits and the control's (the reference computed in TF32
in the program's place) fail at least one. Marked ``cuda``; skips without
a card. Run on the card with
``python -m pytest --noconftest -p no:cacheprovider p2l_bench/tests``."""

import pytest
import torch

from p2l_bench.calibrate import judged
from p2l_bench.harness import env, spec


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    env.prepare_caches()
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["biggan256-basincma", "cars512-basincma",
                                  "biggan256-cma-evalonly"])
def test_control_fails_where_the_program_passes(cell, card):
    wl = spec.workload(cell)
    cfg = spec.config(wl["config"])
    run = judged(wl, cfg, 3_000_000_019, card, None)
    program, control = run.readings(), run.readings("control")
    limits = wl["checks"]
    assert all(program[n] <= lim for n, lim in limits.items()), program
    assert any(control[n] > lim for n, lim in limits.items()
               if n in control), control
