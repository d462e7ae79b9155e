"""Each per-layer reader on a synthetic trace whose answer is known."""

import pytest

from p2l_bench.flops import roofline
from p2l_bench.harness import spec


def trace(**over):
    t = {"cell": "c", "kind": "basincma", "config": {"blur_kernel": [1, 3, 3, 1]},
         "chips": 1, "rows": 18, "grad_steps": 30, "generations": 2,
         "window_s": 10.0, "generation_s": [5.0, 5.0],
         "spans": {"grad_steps": [{"gen": 1, "ms": 4500.0,
                                   "info": {"steps": 30}},
                                  {"gen": 2, "ms": 4800.0,
                                   "info": {"steps": 30}}],
                   "eval": [{"gen": 1, "ms": 100.0, "info": None},
                            {"gen": 2, "ms": 120.0, "info": None}],
                   "gather": [{"gen": 1, "ms": 2.0, "info": None},
                              {"gen": 1, "ms": 1.0, "info": None},
                              {"gen": 2, "ms": 3.0, "info": None}]},
         "modules": {}, "device": {"busy_s": 7.5, "window_s": 10.0},
         "peak_bytes": 3 * 2 ** 30,
         "flops": {"step": 1e11, "forward": 4e10, "target": 1e9},
         "peak_flops": 495e12}
    t.update(over)
    return t


def read(name, t):
    return spec.reader(name).read(t)


def test_step_and_tell_ms():
    assert read("step_ms.basincma", trace()) == pytest.approx(9300 / 60)
    assert read("tell_ms.basincma", trace()) == pytest.approx(
        ((5000 - 4500) + (5000 - 4800)) / 2)


def test_eval_and_tell_ms_evalonly():
    t = trace(kind="evalonly")
    assert read("eval_ms.evalonly", t) == pytest.approx(110.0)
    assert read("tell_ms.evalonly", t) == pytest.approx(
        ((5000 - 100) + (5000 - 120)) / 2)


def test_generation_p95_needs_twenty():
    assert read("generation_ms_p95.evalonly", trace()) is None
    walls = [0.1] * 19 + [0.3]
    assert read("generation_ms_p95.evalonly",
                trace(generation_s=walls, generations=20)) == pytest.approx(
        290.0)


def test_mfu():
    t = trace()
    per_gen = 30 * 18 * 1e11 + 18 * 4e10 + 1e9
    assert read("mfu.basincma", t) == pytest.approx(
        100 * 2 * per_gen / (10.0 * 495e12))
    e = trace(kind="evalonly", grad_steps=0)
    assert read("mfu.evalonly", e) == pytest.approx(
        100 * 2 * 2 * (18 * 4e10 + 1e9) / (10.0 * 495e12))
    assert read("mfu.basincma", trace(generations=0)) is None


def test_idle_peak_gather():
    assert read("device_idle.basincma", trace()) == pytest.approx(25.0)
    assert read("device_idle.evalonly", trace()) == pytest.approx(25.0)
    assert read("peak_mem_gib.basincma", trace()) == pytest.approx(3.0)
    assert read("gather_ms.x4", trace()) == pytest.approx(3.0)
    assert read("gather_ms.x4", trace(spans={})) is None


def test_rooflines():
    x = [18, 512, 64, 64]
    attn = {"SelfAttn": [{"in": [x], "out": x, "params": {},
                          "fwd_ms": 1.0, "bwd_ms": 3.0},
                         {"in": [x], "out": x, "params": {},
                          "fwd_ms": 1.0, "bwd_ms": None}]}
    want = (2 * roofline.selfattn_ms(x, True)
            - (roofline.selfattn_ms(x, True) - roofline.selfattn_ms(x, False))
            ) / 5.0 * 100
    assert read("attn_roofline.basincma",
                trace(modules=attn)) == pytest.approx(want)
    blur = {"Blur": [{"in": [[22, 64, 513, 513]], "out": [22, 64, 512, 512],
                      "params": {}, "fwd_ms": 1.2, "bwd_ms": 1.2}]}
    assert read("blur_roofline.basincma",
                trace(modules=blur)) == pytest.approx(100 * 2 * 0.8832 / 2.4,
                                                      rel=1e-3)
    mod = {"ModulatedConv": [{"in": [[22, 64, 512, 512], [22, 512]],
                              "out": [22, 64, 512, 512],
                              "params": {"weight": [64, 64, 3, 3]},
                              "fwd_ms": 10.0, "bwd_ms": 20.0}]}
    share = read("modconv_roofline.basincma", trace(modules=mod))
    ops = roofline.conv_ops(22, 64, 64, 3, 512, 512)
    act = 4 * 22 * 64 * 512 * 512
    least = (roofline.least_ms(2 * act, ops)
             + roofline.least_ms(3 * act, ops + 3 * act // 4))
    assert share == pytest.approx(100 * least / 30.0, rel=1e-9)
    for name in ("attn_roofline.basincma", "blur_roofline.basincma",
                 "modconv_roofline.basincma"):
        assert read(name, trace()) is None
