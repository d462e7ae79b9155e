"""BigGAN-deep's block convolutions (``ops/block_conv.py``).

On the CPU: the packed weights (tf32 hi + lo, taps outermost, the input
gradient's weight flipped and transposed) through the kernel's GEMM in
plain PyTorch against ``F.conv2d`` in float64; the weight packs kept and
rebuilt; the arguments the kernel refuses; CPU and bfloat16 inputs on
``F.conv2d``, bit for bit, with the kernel's counters at 0; ``GenBlock``
unchanged through ``block_conv2d``; and the GenBlock shapes read from the
model against those a forward runs.

On the card (``cuda``-marked, so skipped here): the kernel's forward and
input gradient against float64 ``F.conv2d`` at every ``GenBlock`` shape at
18 rows, 5 (a four-card rank's share) and 7, with and without bias, two
calls bitwise equal, the kernel's split of K at every GenBlock shape and on
ragged shapes (uneven splits too), a weight or bias that asks for a
gradient refused, a float32 convolution the kernel cannot take refused
(never sent to ``F.conv2d``), and the counts of one BigGAN-deep step: 4
forward and 4 input-gradient calls a block, none on ``F.conv2d``.

The file imports neither JAX nor the JAX package:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_block_conv.py
"""

import pytest
import torch
import torch.nn.functional as F

from pix2latent_tpu_torch.models import biggan as B
from pix2latent_tpu_torch.ops import block_conv as BC

VERSION = "biggan-deep-256"
with torch.device("meta"):
    GENERATOR = B.BigGANDeepGenerator(VERSION)
SHAPES = B.genblock_conv_shapes(GENERATOR, rows=18)
# (atol, rtol) on outputs of unit scale: K1's float32 tolerances
TOL = (1e-5, 2e-4)


def _conv_case(x_shape, w_shape, dtype=torch.float64, device="cpu",
               bias=True, seed=0):
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    cout, cin, k, _ = w_shape
    x = torch.randn(x_shape, generator=gen, device=device, dtype=dtype)
    w = (torch.randn(w_shape, generator=gen, device=device)
         / (cin * k * k) ** 0.5)
    b = torch.randn(cout, generator=gen, device=device) if bias else None
    g = torch.randn((x_shape[0], cout) + tuple(x_shape[2:]), generator=gen,
                    device=device, dtype=dtype)
    return x, w, b, g


def _conv_and_input_grad(x, w, b, g):
    """float64 ``F.conv2d`` and the gradient of <conv, g> to its input."""
    k = w.shape[-1]
    xd = x.double().requires_grad_(True)
    y = F.conv2d(xd, w.double(), None if b is None else b.double(),
                 padding=k // 2)
    y.backward(g.double())
    return y.detach(), xd.grad


@pytest.fixture
def counts():
    BC.reset_launch_counts()
    yield BC.launch_counts
    BC.reset_launch_counts()


# ------------------------------------------------------------------ CPU --

def test_tf32_split_parts():
    a = torch.randn(4096) * torch.logspace(-20, 20, 4096)
    hi, lo = BC.tf32_split(a)
    for part in (hi, lo):
        assert not (part.view(torch.int32) & 0x1fff).any()
    assert torch.equal(hi, a.view(torch.int32).add(0x1000).bitwise_and(
        -0x2000).view(torch.float32))
    rel = ((hi.double() + lo.double() - a.double()).abs() / a.double().abs())
    assert rel.max() <= 2.0 ** -21


@pytest.mark.parametrize("x_shape,w_shape", [
    ((2, 40, 5, 7), (24, 40, 3, 3)),     # channels past one K tile, ragged
    ((1, 33, 4, 4), (17, 33, 3, 3)),     # a 4x4 plane: every tap masked
    ((3, 64, 4, 4), (96, 64, 1, 1)),
    ((2, 70, 3, 5), (9, 70, 1, 1)),      # a plane of 15: not 16-byte runs
    ((2, 64, 8, 8), (64, 64, 3, 3)),
])
@pytest.mark.parametrize("bias", [True, False])
def test_packed_gemm_is_the_conv_and_its_input_grad(x_shape, w_shape, bias):
    x, w, b, g = _conv_case(x_shape, w_shape, bias=bias)
    k = w_shape[-1]
    y_ref, dx_ref = _conv_and_input_grad(x, w, b, g)
    fwd, bwd = BC.pack_weight(w), BC.pack_grad_weight(w)
    cin_pad = -(-w_shape[1] // BC.BK) * BC.BK
    assert fwd.shape == (2, w_shape[0], k * k, cin_pad)
    y = BC.packed_conv_reference(x, fwd, b, k)
    dx = BC.packed_conv_reference(g, bwd, None, k)
    # hi + lo carries the weight to 2^-22 of its size
    scale = 2.0 ** -21 * (x.abs().amax() * w.abs().sum((1, 2, 3)).amax())
    assert (y - y_ref).abs().max() <= scale + 1e-12
    assert (dx - dx_ref).abs().max() <= 2.0 ** -21 * (
        g.abs().amax() * w.abs().sum((0, 2, 3)).amax()) + 1e-12


def _bad_args(device="cpu"):
    """Float32 convolutions the kernel does not take, by what is wrong."""
    def zeros(*shape):
        return torch.zeros(shape, device=device)
    x, w3, b = zeros(2, 16, 6, 6), zeros(8, 16, 3, 3), zeros(8)
    return {
        "5x5": (x, zeros(8, 16, 5, 5), b, 2),
        "3x3_pad_0": (x, w3, b, 0),
        "1x1_pad_1": (x, zeros(8, 16, 1, 1), b, 1),
        "3x1": (x, zeros(8, 16, 3, 1), b, 1),
        "channels": (x, zeros(8, 12, 3, 3), b, 1),
        "weight_f64": (x, w3.double(), b, 1),
        "bias_shape": (x, w3, zeros(9), 1),
        "bias_strided": (x, w3, zeros(16)[::2], 1),
        "bias_bf16": (x, w3, b.bfloat16(), 1),
        "not_4d": (x[0], w3, b, 1),
    }


@pytest.mark.parametrize("case", sorted(_bad_args()))
def test_kernel_args_refused(case):
    with pytest.raises(ValueError, match="block_conv"):
        BC.check_kernel_args(*_bad_args()[case])


@pytest.mark.parametrize("k", [1, 3])
@pytest.mark.parametrize("bias", [True, False])
def test_kernel_args_taken(k, bias):
    x, w, b, _ = _conv_case((2, 16, 6, 6), (8, 16, k, k), dtype=torch.float32,
                            bias=bias)
    BC.check_kernel_args(x, w, b, k // 2)


def test_packed_weights_are_kept_and_rebuilt():
    w = torch.randn(8, 6, 3, 3)
    fwd, bwd = BC.packed_weights(w)
    again = BC.packed_weights(w)
    assert again[0] is fwd and again[1] is bwd
    assert torch.equal(bwd, BC.pack_weight(w.flip(2, 3).transpose(0, 1)))
    with torch.no_grad():
        w.mul_(2.0)
    fwd2, _ = BC.packed_weights(w)
    assert fwd2 is not fwd
    assert torch.equal(fwd2, BC.pack_weight(w))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("k", [1, 3])
def test_cpu_and_bf16_reach_conv2d(counts, dtype, k):
    x, w, b, _ = _conv_case((2, 16, 6, 6), (8, 16, k, k), dtype=dtype)
    got = BC.block_conv2d(x, w, b, padding=k // 2)
    want = F.conv2d(x, w.to(dtype), b.to(dtype), padding=k // 2)
    assert got.dtype == dtype and torch.equal(got, want)
    assert counts() == {"fwd": 0, "bwd": 0, "plain": 1}


def test_cpu_path_keeps_weight_gradients(counts):
    x, w, b, g = _conv_case((2, 16, 6, 6), (8, 16, 3, 3), dtype=torch.float32)
    w.requires_grad_(True)
    BC.block_conv2d(x, w, b, padding=1).backward(g)
    wr = w.detach().clone().requires_grad_(True)
    F.conv2d(x, wr, b, padding=1).backward(g)
    assert torch.equal(w.grad, wr.grad)
    assert counts()["fwd"] == 0


def _genblock_by_conv2d(block, x, truncation, cond):
    """GenBlock.forward with each convolution as ``F.conv2d`` in x's type."""
    def conv(h, layer, padding=0):
        return F.conv2d(h, layer.weight.to(h.dtype), layer.bias.to(h.dtype),
                        padding=padding)
    h = F.relu(block.bn_0(x, truncation, cond))
    h = conv(h, block.conv_0)
    h = F.relu(block.bn_1(h, truncation, cond))
    if block.up_sample:
        h = F.interpolate(h, scale_factor=2, mode="nearest")
    h = conv(h, block.conv_1, 1)
    h = F.relu(block.bn_2(h, truncation, cond))
    h = conv(h, block.conv_2, 1)
    h = F.relu(block.bn_3(h, truncation, cond))
    h = conv(h, block.conv_3)
    skip = x[:, :block.out_size]
    if block.up_sample:
        skip = F.interpolate(skip, scale_factor=2, mode="nearest")
    return skip + h


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("up", [False, True])
def test_genblock_unchanged_on_cpu(counts, up, dtype):
    torch.manual_seed(0)
    block = B.GenBlock(32, 16, up_sample=up)
    with torch.no_grad():
        for p in block.parameters():
            p.normal_(0.0, 0.1)
        for name, p in block.named_parameters():
            if name.endswith("running_vars"):
                p.abs_().add_(1.0)
    x = torch.randn(3, 32, 4, 4).to(dtype)
    cond = torch.randn(3, B.Z_DIM + B.EMBED_DIM).to(dtype)
    got = block(x, 0.4, cond)
    assert torch.equal(got, _genblock_by_conv2d(block, x, 0.4, cond))
    assert counts() == {"fwd": 0, "bwd": 0, "plain": 4}


def test_biggan_forward_on_cpu_counts_plain_calls(counts):
    model = B.BigGAN("biggan-deep-128", channel_width=4, device="cpu")
    z = torch.zeros(2, B.Z_DIM)
    model(z, model.get_class_embedding(1).expand(2, -1), 0.5)
    blocks = len(B.BIGGAN_CONFIGS["biggan-deep-128"]["layers"])
    assert counts() == {"fwd": 0, "bwd": 0, "plain": 4 * blocks}


def test_genblock_conv_shapes_cover_the_model(monkeypatch):
    seen = []

    def record(x, weight, bias=None, padding=0):
        seen.append((tuple(x.shape), tuple(weight.shape)))
        return F.conv2d(x, weight, bias, padding=padding)

    monkeypatch.setattr(B, "block_conv2d", record)
    model = B.BigGAN("biggan-deep-128", channel_width=4, device="cpu")
    with torch.no_grad():
        model(torch.zeros(3, B.Z_DIM),
              model.get_class_embedding(1).expand(3, -1), 0.5)
    shapes = B.genblock_conv_shapes(model.generator, rows=3)
    assert seen == [(x, w) for _, _, x, w in shapes]
    assert len(SHAPES) == 48
    macs = sum(n * cout * cin * k * k * h * w for _, _, (n, cin, h, w),
               (cout, _, k, _) in SHAPES) / 18
    assert macs == pytest.approx(26.47e9, rel=1e-3)


# ----------------------------------------------------------------- card --

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _close(got, want):
    scale = want.abs().max().item()
    err = (got.double() - want).abs()
    ok = bool((err <= TOL[0] * max(scale, 1.0) + TOL[1] * want.abs()).all())
    return ok, err.max().item()


def _kernel_matches(x_shape, w_shape, device, bias=True, seed=0):
    x, w, b, g = _conv_case(x_shape, w_shape, dtype=torch.float32,
                            device=device, bias=bias, seed=seed)
    k = w_shape[-1]
    y_ref, dx_ref = _conv_and_input_grad(x, w, b, g)
    xk = x.clone().requires_grad_(True)
    y = BC.block_conv2d(xk, w, b, padding=k // 2)
    y.backward(g)
    ok_y, err_y = _close(y.detach(), y_ref)
    ok_x, err_x = _close(xk.grad, dx_ref)
    assert ok_y and ok_x, (x_shape, w_shape, err_y, err_x)
    return y.detach(), xk.grad


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [18, 5, 7])
@pytest.mark.parametrize("index", range(len(SHAPES)))
def test_kernel_matches_conv2d_at_genblock_shapes(cuda, counts, rows, index):
    blk, layer, x_shape, w_shape = SHAPES[index]
    x_shape = (rows,) + tuple(x_shape[1:])
    _kernel_matches(x_shape, w_shape, cuda, bias=index % 2 == 0)
    assert counts() == {"fwd": 1, "bwd": 1, "plain": 0}


@pytest.mark.cuda
@pytest.mark.parametrize("bias", [True, False])
@pytest.mark.parametrize("x_shape,w_shape", [
    ((2, 40, 5, 7), (24, 40, 3, 3)), ((1, 33, 4, 4), (17, 33, 3, 3)),
    ((2, 70, 3, 5), (9, 70, 1, 1)), ((3, 64, 9, 9), (130, 64, 1, 1)),
    ((5, 520, 4, 4), (512, 520, 3, 3))])
def test_kernel_matches_conv2d_at_ragged_shapes(cuda, x_shape, w_shape, bias):
    _kernel_matches(x_shape, w_shape, cuda, bias=bias)


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [18, 5, 7])
def test_plan_at_every_genblock_shape(cuda, rows):
    for _, _, (n, cin, h, w), (cout, _, k, _) in B.genblock_conv_shapes(
            GENERATOR, rows):
        for m, c in ((cout, cin), (cin, cout)):     # forward, input grad
            splits = BC.kernel_splits(n, -(-c // BC.BK) * BC.BK, h, w, m, k)
            assert 1 <= splits <= 16
            if k == 3 and rows == 18:     # 32x32 and below split, not above
                assert (splits > 1) == (h <= 32), (h, m, c, splits)


@pytest.mark.cuda
def test_plan_depends_on_the_shape_alone(cuda):
    assert BC.kernel_splits(18, 512, 4, 4, 512, 3) == 16
    assert BC.kernel_splits(18, 64, 256, 256, 64, 3) == 1
    assert BC.kernel_splits(5, 544, 4, 4, 512, 3) == 16    # 153 K tiles
    assert BC.kernel_splits(2, 96, 10, 12, 72, 3) == 2     # 27 K tiles
    assert BC.kernel_splits(18, 2048, 4, 4, 512, 1) == 8


@pytest.mark.cuda
@pytest.mark.parametrize("x_shape,w_shape,splits", [
    ((3, 64, 9, 9), (130, 64, 1, 1), 1),
    ((2, 40, 5, 7), (24, 40, 3, 3), 2),
    ((2, 96, 10, 12), (72, 96, 3, 3), 2),        # 14 and 13 K tiles
    ((5, 512, 4, 4), (512, 512, 3, 3), 16),
    ((5, 520, 4, 4), (512, 520, 3, 3), 16)])     # 15 of 10, one of 3
def test_every_split(cuda, x_shape, w_shape, splits):
    n, cin, h, w = x_shape
    cout, _, k, _ = w_shape
    assert BC.kernel_splits(n, -(-cin // BC.BK) * BC.BK, h, w, cout,
                            k) == splits
    x, wt, b, _ = _conv_case(x_shape, w_shape, dtype=torch.float32,
                             device=cuda)
    y = BC.kernel_conv(x, BC.pack_weight(wt), b, k)
    ok, err = _close(y, F.conv2d(x.double(), wt.double(), b.double(),
                                 padding=k // 2))
    assert ok, (splits, x_shape, err)


@pytest.mark.cuda
@pytest.mark.parametrize("index", [1, 3, 29, 45])
def test_kernel_is_deterministic(cuda, index):
    _, _, x_shape, w_shape = SHAPES[index]
    first = _kernel_matches(x_shape, w_shape, cuda)
    second = _kernel_matches(x_shape, w_shape, cuda)
    assert all(torch.equal(a, b) for a, b in zip(first, second))


@pytest.mark.cuda
def test_weight_that_asks_for_a_gradient_raises(cuda, counts):
    x, w, b, _ = _conv_case((2, 64, 8, 8), (64, 64, 3, 3),
                            dtype=torch.float32, device=cuda)
    with pytest.raises(RuntimeError, match="no weight or bias gradient"):
        BC.block_conv2d(x, w.clone().requires_grad_(True), b, padding=1)
    with pytest.raises(RuntimeError, match="no weight or bias gradient"):
        BC.block_conv2d(x, w, b.clone().requires_grad_(True), padding=1)
    assert counts() == {"fwd": 0, "bwd": 0, "plain": 0}
    with torch.no_grad():                  # nothing asks for a gradient
        y = BC.block_conv2d(x, w.clone().requires_grad_(True), b, padding=1)
    assert torch.equal(y, BC.block_conv2d(x, w, b, padding=1))
    assert counts() == {"fwd": 2, "bwd": 0, "plain": 0}


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 3])
def test_bf16_on_the_card_reaches_conv2d(cuda, counts, k):
    x, w, b, _ = _conv_case((2, 64, 8, 8), (32, 64, k, k),
                            dtype=torch.bfloat16, device=cuda)
    got = BC.block_conv2d(x, w, b, padding=k // 2)
    assert torch.equal(got, F.conv2d(x, w.bfloat16(), b.bfloat16(),
                                     padding=k // 2))
    assert counts() == {"fwd": 0, "bwd": 0, "plain": 1}


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(_bad_args()))
def test_float32_on_the_card_never_reaches_conv2d(cuda, counts, case):
    x, w, b, padding = _bad_args(cuda)[case]
    with pytest.raises(ValueError, match="block_conv"):
        BC.block_conv2d(x, w, b, padding=padding)
    assert counts() == {"fwd": 0, "bwd": 0, "plain": 0}


@pytest.mark.cuda
def test_one_biggan_step_runs_every_genblock_conv_on_the_kernel(cuda, counts):
    model = B.BigGAN(VERSION, device=cuda)
    z = torch.randn(2, B.Z_DIM, device=cuda, requires_grad=True)
    c = model.get_class_embedding(153).expand(2, -1)
    BC.reset_launch_counts()
    model(z, c, 1.0).square().mean().backward()
    torch.cuda.synchronize()
    blocks = len(B.BIGGAN_CONFIGS[VERSION]["layers"])
    assert counts() == {"fwd": 4 * blocks, "bwd": 4 * blocks, "plain": 0}
    assert 4 * blocks == 48
    assert torch.isfinite(z.grad).all()
