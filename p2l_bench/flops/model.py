"""Model FLOPs of a configuration's work, counted by
``torch.utils.flop_counter.FlopCounterMode`` over the plain reference on
the meta device (nothing is computed).

The weights are frozen, so a backward counts the gradients to the inputs
only; nothing is recomputed. The target's LPIPS taps are computed once a
generation and counted apart.
"""

from __future__ import annotations

import torch
from torch.utils.flop_counter import FlopCounterMode

from p2l_bench.harness import spec


def _count(fn) -> int:
    with FlopCounterMode(display=False) as counter:
        fn()
    return int(counter.get_total_flops())


def per_row(cfg, rows: int = 2) -> dict:
    """``{"step", "forward", "target"}``: FLOPs of one row's inner step
    (forward, loss and backward), of one row's forward with its loss, and
    of the target's LPIPS taps."""
    problem = spec.problem(cfg["problem"])
    inputs = problem.meta_inputs(cfg)
    target_flops = _count(lambda: problem.Reference(cfg, inputs))
    ref = problem.Reference(cfg, inputs)

    def step():
        leaves = {n: t.requires_grad_(True) for n, t in
                  problem.meta_leaves(cfg, rows).items()}
        ref.loss(leaves).sum().backward()

    def forward():
        with torch.no_grad():
            ref.loss(problem.meta_leaves(cfg, rows))

    return {"step": _count(step) / rows, "forward": _count(forward) / rows,
            "target": target_flops}
