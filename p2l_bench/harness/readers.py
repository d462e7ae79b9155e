"""Arithmetic the per-layer readers share. A reader takes the traced run's
``trace`` (``cell._trace``) and returns one number, or None when the run
gives it nothing to read."""

from __future__ import annotations

import statistics
from collections import defaultdict


def span_ms_by_generation(trace, name) -> dict:
    """``{generation: summed device ms}`` of span ``name``."""
    out = defaultdict(float)
    for rec in trace["spans"].get(name, []):
        out[rec["gen"]] += rec["ms"]
    return dict(out)


def per_step_ms(trace, name):
    recs = trace["spans"].get(name, [])
    steps = sum(r["info"]["steps"] for r in recs if r["info"])
    return sum(r["ms"] for r in recs) / steps if steps else None


def per_generation_ms(trace, name):
    by_gen = span_ms_by_generation(trace, name)
    if not by_gen or not trace["generations"]:
        return None
    return sum(by_gen.values()) / trace["generations"]


def outside_ms(trace, name):
    """A generation's wall time less the device span of ``name`` in it,
    the mean over the counted generations."""
    by_gen = span_ms_by_generation(trace, name)
    walls = trace["generation_s"]
    if not walls or not by_gen:
        return None
    return statistics.mean(1e3 * w - by_gen.get(i + 1, 0.0)
                           for i, w in enumerate(walls))


def roofline(trace, cls, least_ms):
    """100 x the least time of every traced forward and backward of the
    modules of class ``cls`` over their measured device time;
    ``least_ms(call, backward)`` gives a call's least time."""
    calls = trace["modules"].get(cls, [])
    bound = spent = 0.0
    for c in calls:
        bound += least_ms(c, False)
        spent += c["fwd_ms"]
        if c["bwd_ms"] is not None:
            bound += least_ms(c, True) - least_ms(c, False)
            spent += c["bwd_ms"]
    return 100.0 * bound / spent if spent > 0 else None


def mfu(trace, backward: bool):
    """100 x the model FLOPs of the counted generations over the window's
    time at the cards' peak: each generation's inner steps (forward, loss
    and backward) on the population's own rows, or with no inner steps
    its evaluations, plus its tell forwards and the target's taps."""
    if not trace["generations"] or trace["window_s"] <= 0:
        return None
    f, rows = trace["flops"], trace["rows"]
    if backward:
        per_gen = trace["grad_steps"] * rows * f["step"] + rows * f[
            "forward"] + f["target"]
    else:
        # an eval-only generation evaluates the population and computes a
        # fresh tell loss, each with the target's taps
        per_gen = 2 * (rows * f["forward"] + f["target"])
    work = per_gen * trace["generations"]
    return 100.0 * work / (trace["window_s"] * trace["peak_flops"]
                           * trace["chips"])


def device_idle(trace):
    d = trace["device"]
    if not d["window_s"]:
        return None
    return 100.0 * (1.0 - d["busy_s"] / d["window_s"])
