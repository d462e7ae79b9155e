"""The frozen roofline arithmetic reproduces the bound column of the
port's kernel table (PERF.md), and the model FLOP count is the plain
reference's."""

import pytest

from p2l_bench.flops import model, roofline
from p2l_bench.tests import tiny

FLAGSHIP = (18, 4096, 1024, 64, 256)


@pytest.mark.parametrize("dtype,fwd,bwd", [("float32", 0.0976, 0.2147),
                                           ("bfloat16", 0.0489, 0.1075)])
def test_k1_bounds(dtype, fwd, bwd):
    fb, fo, bb, bo = roofline.k1_attention(*FLAGSHIP, dtype=dtype)
    assert roofline.least_ms(fb, fo, dtype) == pytest.approx(fwd, abs=1e-4)
    assert roofline.least_ms(bb, bo, dtype) == pytest.approx(bwd, abs=1e-4)


@pytest.mark.parametrize("shape,dtype,ms", [
    ((22, 64, 513, 513), "float32", 0.8832),
    ((22, 64, 513, 513), "bfloat16", 0.4416),
    ((2, 32, 1025, 1025), "float32", 0.1604),
    ((2, 32, 1025, 1025), "bfloat16", 0.0802)])
def test_k2_bounds(shape, dtype, ms):
    bytes_, fwd, bwd = roofline.k2_fir(shape, 4, (1, 1), dtype)
    assert roofline.least_ms(bytes_, fwd, dtype) == pytest.approx(ms,
                                                                  abs=1e-4)
    assert roofline.least_ms(bytes_, bwd, dtype) == pytest.approx(ms,
                                                                  abs=1e-4)


@pytest.mark.parametrize("shape,dtype,ms", [
    ((22, 64, 512, 512), "float32", 1.3221),
    ((22, 64, 512, 512), "bfloat16", 0.6611),
    ((2, 32, 1024, 1024), "float32", 0.2404)])
def test_k3_bounds(shape, dtype, ms):
    bytes_, ops = roofline.k3_mod_backward(shape, dtype)
    assert roofline.least_ms(bytes_, ops, dtype) == pytest.approx(ms,
                                                                  abs=1e-4)


def test_module_bounds_hold_their_kernel():
    x = (18, 512, 64, 64)
    fb, fo, bb, bo = roofline.k1_attention(18, 4096, 1024, 64, 256)
    assert roofline.selfattn_ms(x, False) > roofline.least_ms(fb, fo)
    assert roofline.selfattn_ms(x, True) > roofline.selfattn_ms(x, False)


@pytest.mark.parametrize("cell", ["biggan256-basincma", "cars512-basincma"])
def test_model_flops(cell, monkeypatch):
    _, cfg = tiny.cell(cell, monkeypatch)
    f = model.per_row(cfg)
    # a backward to the inputs costs about twice its forward
    assert 1.9 < f["step"] / f["forward"] < 4.0
    assert f["target"] > 0
