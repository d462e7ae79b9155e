"""The readers of the program's spans (``harness/program.py``) on synthetic
traces whose answers are known, on a real profiled toy run found through
the harness's ``DeviceTrace``, and on a program that records no spans."""

import pytest
import torch

from p2l_bench.harness import program, spec
from p2l_bench.harness.trace import DeviceTrace

MS = 1_000_000


def rec(i, parent, name, start, end, device=None, **attrs):
    return {"id": i, "parent": parent, "name": name, "attrs": attrs,
            "start_ns": start * MS, "end_ns": end * MS,
            "host_ms": float(end - start), "device_ms": device}


def basincma(offset=0, first_id=0):
    """One BasinCMA generation from ``offset`` ms: times in ms."""
    o, n = offset, first_id

    def r(i, parent, *args, **kw):
        return rec(n + i, None if parent is None else n + parent,
                   args[0], o + args[1], o + args[2], *args[3:], **kw)
    return [r(1, None, "generation", 0, 1000, None, gen=0),
            r(2, 1, "ask", 0, 50, 5.0),
            r(3, 1, "inner", 50, 800, 740.0, steps=2, rows=18),
            r(4, 3, "step", 50, 400, 345.0),
            r(5, 4, "loss", 100, 150, 40.0),
            r(6, 3, "step", 400, 800, 395.0),
            r(7, 6, "loss", 450, 500, 45.0),
            r(8, 1, "tell_loss", 800, 900, 90.0),
            r(9, 8, "loss", 850, 880, 20.0),
            r(10, 1, "strategy_tell", 900, 950, 30.0),
            r(11, 10, "sync", 910, 940, 25.0, site="eigh"),
            r(12, 1, "sync", 960, 970, 0.1, site="tell_min")]


# idle gaps, ms: in the ask, two inside the inner run, after the tell read,
# and past the last span (no span of the program open)
GAPS = [[10, 20], [200, 260], [700, 880], [960, 1000], [1000, 1100]]


def trace(recs=None, gaps=GAPS, busy_s=0.71, window_s=1.1, kind="basincma"):
    return {"kind": kind, "program": basincma() if recs is None else recs,
            "device": {"busy_s": busy_s, "window_s": window_s,
                       "gaps": [[s * MS, e * MS] for s, e in gaps]}}


def read(name, t):
    return spec.reader(name).read(t)


def test_per_generation_spans_and_counts():
    t = trace()
    assert read("tell_forward_ms.basincma", t) == pytest.approx(90.0)
    assert read("strategy_tell_ms.basincma", t) == pytest.approx(30.0)
    assert read("strategy_tell_ms.evalonly", t) == pytest.approx(30.0)
    assert read("host_syncs.basincma", t) == 2
    assert read("host_syncs.evalonly", t) == 2
    # the tell loss's own loss span is not an inner step's
    assert read("loss_ms.basincma", t) == pytest.approx((40 + 45) / 2)


def test_two_generations_divide_by_the_tells():
    recs = basincma() + basincma(offset=2000, first_id=100)
    t = trace(recs, gaps=GAPS + [[g[0] + 2000, g[1] + 2000] for g in GAPS],
              busy_s=1.42, window_s=2.2)
    assert read("tell_forward_ms.basincma", t) == pytest.approx(90.0)
    assert read("host_syncs.basincma", t) == 2
    assert read("idle_inner_ms.basincma", t) == pytest.approx(240.0)
    assert read("idle_outer_ms.basincma", t) == pytest.approx(150.0)


def test_idle_split_by_the_inner_run_sums_to_the_idle_time():
    t = trace()
    inner = read("idle_inner_ms.basincma", t)
    outer = read("idle_outer_ms.basincma", t)
    assert inner == pytest.approx(60 + 180)
    assert outer == pytest.approx(10 + 40 + 100)
    idle_ms = read("device_idle.basincma", t) / 100 * 1e3 * \
        t["device"]["window_s"]
    assert inner + outer == pytest.approx(idle_ms)


def test_evalonly_idle_outside_the_forwards():
    recs = [rec(1, None, "generation", 0, 500, None, gen=0),
            rec(2, 1, "ask", 0, 50, 4.0),
            rec(3, 1, "eval", 50, 200, 140.0),
            rec(4, 1, "tell_loss", 200, 350, 140.0),
            rec(5, 1, "strategy_tell", 350, 400, 30.0),
            rec(6, 5, "sync", 360, 390, 20.0, site="eigh"),
            rec(7, 1, "sync", 400, 410, 0.1, site="tell_min")]
    t = trace(recs, gaps=[[20, 40], [100, 140], [300, 320], [420, 500]],
              kind="evalonly")
    assert read("idle_outer_ms.evalonly", t) == pytest.approx(20 + 80)
    assert read("strategy_tell_ms.evalonly", t) == pytest.approx(30.0)
    assert read("host_syncs.evalonly", t) == 2


def test_host_time_stands_in_without_a_card():
    recs = [dict(r, device_ms=None) for r in basincma()]
    assert read("tell_forward_ms.basincma", trace(recs)) == pytest.approx(
        100.0)
    assert read("loss_ms.basincma", trace(recs)) == pytest.approx(50.0)


def test_idle_gaps_are_the_complement_of_the_busy_union():
    dev = [(5, 10), (8, 12), (20, 30), (29, 31), (40, 60)]
    assert program.idle_gaps(dev, 0, 50) == [[0, 5], [12, 20], [31, 40]]
    assert program.idle_gaps([], 3, 9) == [[3, 9]]


NEW = ["tell_forward_ms.basincma", "strategy_tell_ms.basincma",
       "strategy_tell_ms.evalonly", "host_syncs.basincma",
       "host_syncs.evalonly", "loss_ms.basincma", "idle_inner_ms.basincma",
       "idle_outer_ms.basincma", "idle_outer_ms.evalonly"]


@pytest.mark.parametrize("name", NEW)
def test_nothing_to_read_gives_none(name, monkeypatch):
    # no tell and no step recorded
    assert read(name, trace([r for r in basincma() if r["name"]
                             not in ("strategy_tell", "step")])) is None
    # a program without spans (the parent of the tracer), outside any
    # traced run of the harness
    from pix2latent_tpu_torch.utils import profiling
    monkeypatch.delattr(profiling, "spans")
    assert read(name, {"kind": "basincma",
                       "device": {"busy_s": 1.0, "window_s": 2.0}}) is None


def _toy_optimizer():
    import pix2latent_tpu_torch.loss_functions as LF
    from pix2latent_tpu_torch import VariableManager
    from pix2latent_tpu_torch.models.toy import make_toy_model
    from pix2latent_tpu_torch.optimizers import BasinCMAOptimizer
    model = make_toy_model(z_dim=8, res=8, width=4, seed=0, device="cpu")
    vm = VariableManager(seed=0, device="cpu")
    vm.register("z", shape=(8,), grad_free=True, learning_rate=0.05)
    vm.register("target", shape=(8, 8, 3), var_type="output",
                requires_grad=False, default=torch.zeros(8, 8, 3))
    return BasinCMAOptimizer(model, vm, LF.l1_loss, seed=1, device="cpu")


def test_a_traced_run_is_read_through_the_harness_trace():
    from pix2latent_tpu_torch.utils import profiling
    profiling.clear_spans()
    _toy_optimizer().optimize(1, 2, last_grad_steps=1)   # not traced
    dtrace = DeviceTrace(cuda=False)
    dtrace.start()
    try:
        _toy_optimizer().optimize(2, 3, last_grad_steps=1)
    finally:
        dtrace.stop()
    device = dtrace.read()
    t = {"kind": "basincma", "device": {"busy_s": device["busy_s"],
                                        "window_s": device["window_s"]}}
    values = {name: read(name, t) for name in NEW}
    # no card: the whole window is one idle gap, and each generation
    # reads its tell minimum and syncs in its tell's eigh
    assert values["host_syncs.basincma"] == 2
    total = values["idle_inner_ms.basincma"] + values[
        "idle_outer_ms.basincma"]
    assert total * 2 == pytest.approx(device["window_s"] * 1e3, rel=1e-6)
    assert all(values[n] > 0 for n in ("tell_forward_ms.basincma",
                                       "strategy_tell_ms.basincma",
                                       "loss_ms.basincma"))
    assert {r["name"] for r in t["program"]} >= {"inner", "strategy_tell"}
    profiling.clear_spans()
