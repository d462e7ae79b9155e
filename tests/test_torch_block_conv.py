"""The port's block convolutions (``ops/block_conv.py``): BigGAN-deep's
``GenBlock`` convolutions and StyleGAN2's modulated 3x3 convolutions and
up-convolutions.

On the CPU: the packed weights (tf32 hi + lo, taps outermost, the input
gradient's weight flipped and transposed) through the kernel's GEMM in
plain PyTorch against ``F.conv2d`` in float64; the up-convolution's four
phase GEMMs against ``F.conv_transpose2d`` and its stride-2 gather against
autograd's input gradient, in float64; the weight packs, plain and scaled,
kept and rebuilt; the arguments the kernel refuses; CPU and bfloat16 inputs
on ``F.conv2d``, bit for bit, with the kernel's counters at 0; ``GenBlock``
and ``ModulatedConv`` (float32, bfloat16, packed pairs) unchanged on the
CPU; and the shapes read from the models against those a forward runs.

On the card (``cuda``-marked, so skipped here): the kernel's forward and
input gradient against float64 ``F.conv2d`` at every ``GenBlock`` shape at
18 rows, 5 (a four-card rank's share) and 7, with and without bias, and at
every StyleGAN2 cars-512 and FFHQ-1024 modulated 3x3 and up-convolution
shape at 22 rows; two calls bitwise equal, the kernel's split of K at every
GenBlock shape and on ragged shapes (uneven splits too), a weight or bias
that asks for a gradient refused, a float32 convolution the kernel cannot
take refused (never sent to ``F.conv2d``), and the counts of one BigGAN-deep
step (4 forward and 4 input-gradient calls a block), one cars step and one
FFHQ step with its recompute, none of their 3x3s on ``F.conv2d``.

The file imports neither JAX nor the JAX package:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_block_conv.py
"""

import pytest
import torch
import torch.nn.functional as F

from pix2latent_tpu_torch.models import biggan as B
from pix2latent_tpu_torch.models import stylegan2 as S
from pix2latent_tpu_torch.ops import block_conv as BC

VERSION = "biggan-deep-256"
with torch.device("meta"):
    GENERATOR = B.BigGANDeepGenerator(VERSION)
SHAPES = B.genblock_conv_shapes(GENERATOR, rows=18)
with torch.device("meta"):
    SG2_SHAPES = S.modulated_conv_shapes(S.StyleGAN2Generator(1024), rows=22)
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


def _counts(**calls):
    """``launch_counts()`` with ``calls`` and every other count 0."""
    return dict(dict.fromkeys(BC.launch_counts(), 0), **calls)


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
    assert counts() == _counts(plain=1)


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
    assert counts() == _counts(plain=4)


def test_biggan_forward_on_cpu_counts_plain_calls(counts):
    model = B.BigGAN("biggan-deep-128", channel_width=4, device="cpu")
    z = torch.zeros(2, B.Z_DIM)
    model(z, model.get_class_embedding(1).expand(2, -1), 0.5)
    blocks = len(B.BIGGAN_CONFIGS["biggan-deep-128"]["layers"])
    assert counts() == _counts(plain=4 * blocks)


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


def _up_case(x_shape, cout, dtype=torch.float64, device="cpu", seed=0):
    """An up-convolution's input, 3x3 weight and output gradient."""
    n, cin, h, w = x_shape
    x, wt, _, _ = _conv_case(x_shape, (cout, cin, 3, 3), dtype=dtype,
                             device=device, bias=False, seed=seed)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed + 1)
    g = torch.randn((n, cout, 2 * h + 1, 2 * w + 1), generator=gen,
                    device=device, dtype=dtype)
    return x, wt, g


def _transposed_conv_and_input_grad(x, w, g):
    """float64 ``F.conv_transpose2d`` by the unflipped ``w`` at stride 2 and
    the gradient of <it, g> to its input."""
    xd = x.double().requires_grad_(True)
    y = F.conv_transpose2d(xd, w.double().transpose(0, 1), stride=2)
    y.backward(g.double())
    return y.detach(), xd.grad


def test_up_taps_are_the_phases():
    assert sorted(BC.UP_TAPS) == [(ky, kx) for ky in range(3)
                                  for kx in range(3)]
    tap = 0
    for a, b in BC.UP_PHASES:
        taps = BC.UP_TAPS[tap:tap + (2 - a) * (2 - b)]
        assert all(ky % 2 == a and kx % 2 == b for ky, kx in taps)
        tap += len(taps)
    assert tap == 9


@pytest.mark.parametrize("x_shape,cout", [
    ((2, 40, 5, 7), 24),      # channels past one K tile, a ragged plane
    ((1, 33, 1, 1), 17),      # a 1x1 plane: every phase but (0, 0) one pixel
    ((3, 64, 4, 4), 96),
    ((2, 8, 3, 2), 5),
])
def test_packed_up_gemm_is_the_transposed_conv_and_its_input_grad(
        x_shape, cout):
    x, w, g = _up_case(x_shape, cout)
    y_ref, dx_ref = _transposed_conv_and_input_grad(x, w, g)
    fwd, bwd = BC.pack_up_weight(w), BC.pack_up_grad_weight(w)
    assert fwd.shape == (2, cout, 9, -(-x_shape[1] // BC.BK) * BC.BK)
    assert bwd.shape == (2, x_shape[1], 9, -(-cout // BC.BK) * BC.BK)
    y = BC.packed_conv_reference(x, fwd, None, 3, BC.UP)
    dx = BC.packed_conv_reference(g, bwd, None, 3, BC.UP_GRAD)
    assert y.shape == y_ref.shape and dx.shape == dx_ref.shape
    assert (y - y_ref).abs().max() <= 2.0 ** -21 * (
        x.abs().amax() * w.abs().sum((1, 2, 3)).amax()) + 1e-12
    assert (dx - dx_ref).abs().max() <= 2.0 ** -21 * (
        g.abs().amax() * w.abs().sum((0, 2, 3)).amax()) + 1e-12


@pytest.mark.parametrize("up", [False, True])
def test_scaled_packs_are_kept_and_rebuilt(up):
    weight = torch.nn.Parameter(torch.randn(8, 6, 3, 3), requires_grad=False)
    scale = 1.0 / (6 * 9) ** 0.5
    fwd, bwd = BC.scaled_packs(weight, scale, up)
    again = BC.scaled_packs(weight, scale, up)
    assert again[0] is fwd and again[1] is bwd
    # bit for bit the packs of the product ModulatedConv makes, the up
    # route's taps in phase order and its input gradient's weight unflipped
    w = weight * scale
    if up:
        order = [3 * ky + kx for ky, kx in BC.UP_TAPS]
        want = (BC.pack_weight(w)[:, :, order],
                BC.pack_weight(w.transpose(0, 1)))
    else:
        want = (BC.pack_weight(w), BC.pack_weight(w.flip(2, 3).transpose(0, 1)))
    assert torch.equal(fwd, want[0]) and torch.equal(bwd, want[1])
    with torch.no_grad():
        weight.mul_(2.0)
    fwd2, _ = BC.scaled_packs(weight, scale, up)
    assert fwd2 is not fwd
    pack = BC.pack_up_weight if up else BC.pack_weight
    assert torch.equal(fwd2, pack(weight * scale))


def _modconv_by_f_conv(conv, x, style, packed):
    """ModulatedConv.forward with its convolution as the F.conv call the
    layer made before the kernel took it."""
    s = conv.modulation(style)
    w = (conv.weight * conv.scale).to(conv.dtype)
    groups = 2 if packed else 1
    x_mod = x.to(conv.dtype) * (S.pack_rows(s) if packed else s)[:, :, None,
                                                                 None]
    if conv.up:
        y = conv.blur(F.conv_transpose2d(
            x_mod, w.transpose(0, 1).repeat(groups, 1, 1, 1), stride=2,
            groups=groups))
    else:
        y = F.conv2d(x_mod, w.repeat(groups, 1, 1, 1),
                     padding=conv.kernel_size // 2, groups=groups)
    if conv.demodulate:
        d = torch.rsqrt(s.float() ** 2 @ (w.float() ** 2).sum(dim=(2, 3)).t()
                        + 1e-8)
        y = y * (S.pack_rows(d) if packed else d)[:, :, None, None].to(y.dtype)
    return y


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("up,k", [(False, 3), (True, 3), (False, 1)])
def test_modulated_conv_unchanged_on_cpu(counts, dtype, packed, up, k):
    torch.manual_seed(0)
    conv = S.ModulatedConv(8, 6, k, up=up, dtype=dtype, packed=packed,
                           demodulate=k == 3)
    with torch.no_grad():
        for p in conv.parameters():
            p.normal_()
    conv.requires_grad_(False)
    rows = 4
    x = torch.randn(rows // 2 if packed else rows, 16 if packed else 8, 5, 5)
    style = torch.randn(rows, S.STYLE_DIM)
    got = conv(x, style, packed)
    assert got.dtype == dtype
    assert torch.equal(got, _modconv_by_f_conv(conv, x, style, packed))
    assert counts() == _counts(plain=1)


def test_stylegan2_forward_on_cpu_counts_plain_calls(counts):
    generator = S.StyleGAN2Generator(32, channel_multiplier=1)
    generator(torch.zeros(2, S.STYLE_DIM))
    convs = len(S.modulated_conv_shapes(generator, 2))
    assert convs == 7
    assert counts() == _counts(plain=convs + 4)      # and the 4 ToRGBs


def test_modulated_conv_shapes_cover_the_model(monkeypatch):
    seen = []

    def record(x, weight, scale, w, up=False, groups=1):
        if w.shape[-1] == 3:
            seen.append((up, tuple(x.shape), tuple(w.shape)))
        if up:
            return F.conv_transpose2d(x, w.transpose(0, 1), stride=2)
        return F.conv2d(x, w, padding=w.shape[-1] // 2)

    monkeypatch.setattr(S, "modulated_conv2d", record)
    generator = S.StyleGAN2Generator(32, channel_multiplier=1)
    with torch.no_grad():
        generator(torch.zeros(3, S.STYLE_DIM))
    shapes = S.modulated_conv_shapes(generator, rows=3)
    assert seen == [(up, x, w) for _, up, x, w in shapes]
    assert len(SG2_SHAPES) == 17
    macs = {512: 0, 1024: 0}
    for i, (_, up, (n, cin, h, w), (cout, _, k, _)) in enumerate(SG2_SHAPES):
        for res in macs:
            if i < 2 * (res.bit_length() - 3) + 1:
                macs[res] += cout * cin * k * k * h * w
    # cars-512's 15 convs (conv1 and 7 levels), then FFHQ's two at 1024 px
    assert macs[512] == pytest.approx(59.57e9, rel=1e-3)
    assert macs[1024] - macs[512] == pytest.approx(14.50e9, rel=1e-3)


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
    assert counts() == _counts(fwd=1, bwd=1)


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
    assert counts() == _counts()
    with torch.no_grad():                  # nothing asks for a gradient
        y = BC.block_conv2d(x, w.clone().requires_grad_(True), b, padding=1)
    assert torch.equal(y, BC.block_conv2d(x, w, b, padding=1))
    assert counts() == _counts(fwd=2)


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 3])
def test_bf16_on_the_card_reaches_conv2d(cuda, counts, k):
    x, w, b, _ = _conv_case((2, 64, 8, 8), (32, 64, k, k),
                            dtype=torch.bfloat16, device=cuda)
    got = BC.block_conv2d(x, w, b, padding=k // 2)
    assert torch.equal(got, F.conv2d(x, w.bfloat16(), b.bfloat16(),
                                     padding=k // 2))
    assert counts() == _counts(plain=1)


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(_bad_args()))
def test_float32_on_the_card_never_reaches_conv2d(cuda, counts, case):
    x, w, b, padding = _bad_args(cuda)[case]
    with pytest.raises(ValueError, match="block_conv"):
        BC.block_conv2d(x, w, b, padding=padding)
    assert counts() == _counts()


@pytest.mark.cuda
def test_one_biggan_step_runs_every_genblock_conv_on_the_kernel(cuda, counts):
    model = B.BigGAN(VERSION, device=cuda)
    z = torch.randn(2, B.Z_DIM, device=cuda, requires_grad=True)
    c = model.get_class_embedding(153).expand(2, -1)
    BC.reset_launch_counts()
    model(z, c, 1.0).square().mean().backward()
    torch.cuda.synchronize()
    blocks = len(B.BIGGAN_CONFIGS[VERSION]["layers"])
    assert counts() == _counts(fwd=4 * blocks, bwd=4 * blocks)
    assert 4 * blocks == 48
    assert torch.isfinite(z.grad).all()


def _check_by_rows(got, want_rows, rows):
    """``got`` against float64 references computed ``rows`` images at a
    time (``want_rows(i, j)``), at the kernel's tolerance: (ok, max error)."""
    ok, worst = True, 0.0
    for i in range(0, got.shape[0], rows):
        chunk_ok, err = _close(got[i:i + rows], want_rows(i, i + rows))
        ok, worst = ok and chunk_ok, max(worst, err)
    return ok, worst


def _modulated_matches(up, x_shape, w_shape, device, seed=0):
    """``modulated_conv2d`` on the kernel, forward and input gradient,
    against float64 ``F.conv2d`` or ``F.conv_transpose2d`` (rows in chunks
    that keep the float64 copies small)."""
    n, cin, h, w = x_shape
    if up:
        x, wt, g = _up_case(x_shape, w_shape[0], dtype=torch.float32,
                            device=device, seed=seed)
    else:
        x, wt, _, g = _conv_case(x_shape, w_shape, dtype=torch.float32,
                                 device=device, bias=False, seed=seed)
    weight = torch.nn.Parameter(wt * (cin * 9) ** 0.5, requires_grad=False)
    scale = 1.0 / (cin * 9) ** 0.5
    xk = x.clone().requires_grad_(True)
    y = BC.modulated_conv2d(xk, weight, scale, weight * scale, up=up)
    y.backward(g)
    w64 = (weight * scale).double()
    rows = max(1, (1 << 27) // max(y[0].numel(), x[0].numel()))

    def reference(i, j):
        xd = x[i:j].double().requires_grad_(True)
        yd = (F.conv_transpose2d(xd, w64.transpose(0, 1), stride=2) if up
              else F.conv2d(xd, w64, padding=1))
        yd.backward(g[i:j].double())
        return yd.detach(), xd.grad

    ok_y, err_y = _check_by_rows(y.detach(), lambda i, j: reference(i, j)[0],
                                 rows)
    ok_x, err_x = _check_by_rows(xk.grad, lambda i, j: reference(i, j)[1],
                                 rows)
    assert ok_y and ok_x, (up, x_shape, w_shape, err_y, err_x)
    return y.detach(), xk.grad


@pytest.mark.cuda
@pytest.mark.parametrize("index", range(len(SG2_SHAPES)))
def test_kernel_matches_at_stylegan2_shapes(cuda, counts, index):
    """Every modulated 3x3 and up-convolution of cars-512 (the first 15)
    and FFHQ-1024 at 22 rows."""
    _, up, x_shape, w_shape = SG2_SHAPES[index]
    _modulated_matches(up, x_shape, w_shape, cuda)
    key = "up_" if up else ""
    assert counts() == _counts(**{key + "fwd": 1, key + "bwd": 1})


@pytest.mark.cuda
@pytest.mark.parametrize("x_shape,cout", [
    ((2, 40, 5, 7), 24), ((1, 33, 1, 1), 17), ((3, 96, 9, 6), 72),
    ((5, 520, 4, 4), 512),                # K split 8 (up) and 16 ways
    ((2, 130, 5, 7), 24),                 # the tall tile, M ragged (130)
    ((4, 64, 20, 20), 32), ((2, 32, 33, 17), 32),     # the thin tile
    ((2, 8, 3, 2), 5)])
@pytest.mark.parametrize("up", [False, True])
def test_modulated_kernel_matches_at_ragged_shapes(cuda, x_shape, cout, up):
    _modulated_matches(up, x_shape, (cout, x_shape[1], 3, 3), cuda)


@pytest.mark.cuda
@pytest.mark.parametrize("index", [0, 1, 6, 12, 14, 15])
def test_modulated_kernel_is_deterministic(cuda, index):
    _, up, x_shape, w_shape = SG2_SHAPES[index]
    x_shape = (min(x_shape[0], 4),) + tuple(x_shape[1:])
    first = _modulated_matches(up, x_shape, w_shape, cuda)
    second = _modulated_matches(up, x_shape, w_shape, cuda)
    assert all(torch.equal(a, b) for a, b in zip(first, second))


@pytest.mark.cuda
@pytest.mark.parametrize("up", [False, True])
def test_modulated_weight_that_asks_for_a_gradient_raises(cuda, counts, up):
    x = torch.zeros(2, 16, 6, 6, device=cuda)
    weight = torch.nn.Parameter(torch.zeros(8, 16, 3, 3, device=cuda))
    with pytest.raises(RuntimeError, match="no weight or bias gradient"):
        BC.modulated_conv2d(x, weight, 0.1, weight * 0.1, up=up)
    with pytest.raises(ValueError, match="block_conv"):
        BC.modulated_conv2d(x, weight, 0.1, (weight * 0.1).double(), up=up)
    assert counts() == _counts()


@pytest.mark.cuda
@pytest.mark.parametrize("up", [False, True])
def test_modulated_bf16_and_pairs_on_the_card_reach_f_conv(cuda, counts, up):
    for dtype, packed in ((torch.bfloat16, False), (torch.float32, True)):
        conv = S.ModulatedConv(8, 6, up=up, dtype=dtype, packed=packed).to(cuda)
        conv.requires_grad_(False)
        with torch.no_grad():
            conv.weight.normal_()
        x = torch.randn(2 if packed else 4, 16 if packed else 8, 5, 5,
                        device=cuda)
        style = torch.randn(4, S.STYLE_DIM, device=cuda)
        BC.reset_launch_counts()
        got = conv(x, style, packed)
        assert torch.equal(got, _modconv_by_f_conv(conv, x, style, packed))
        assert counts() == _counts(plain=1)


@pytest.mark.cuda
@pytest.mark.parametrize("model,remat,want", [
    ("cars", 0, _counts(fwd=8, bwd=8, up_fwd=7, up_bwd=7, plain=8)),
    # the recompute from 256 px runs the 256, 512 and 1024 px up-convs,
    # convs and ToRGBs forward once more
    ("ffhq", 256, _counts(fwd=9 + 3, bwd=9, up_fwd=8 + 3, up_bwd=8,
                          plain=9 + 3))])
def test_one_stylegan2_step_runs_every_3x3_on_the_kernel(cuda, counts, model,
                                                         remat, want):
    """One float32 step (forward and backward) of the generators as the
    benchmark's problems build them (K2 and K3 on): every modulated 3x3 and
    up-convolution on the kernel, only the ToRGBs' 1x1s on ``F.conv2d``."""
    m = S.StyleGAN2(model, init="equalized", fused_mod_bwd=True,
                    fir_kernel=True, remat_from_res=remat, device=cuda)
    z = torch.randn(2, S.STYLE_DIM, device=cuda, requires_grad=True)
    BC.reset_launch_counts()
    m(z).square().mean().backward()
    torch.cuda.synchronize()
    assert counts() == want
    assert torch.isfinite(z.grad).all()
