"""The port's CUDA kernels against their plain PyTorch versions, on the card:
the SA-GAN attention (K1), the separable FIR blur (K2) and the fused
modulation backward (K3), in float32 and bfloat16, at the largest shapes
their paths give them and at ragged ones. K2 is also held at every level of
the StyleGAN2 up path (cars-512 and FFHQ-1024), at plane sides around its
16-byte runs, at the row widths about FFHQ's 1024 (1024, 1025, 1026: in
float32 the 1025-wide rows take the column-segment mode), at 1 to 8 taps
with asymmetric pads, on inputs that start one element past a 16-byte
boundary, and for bitwise repeatability. K3 is also held at the FFHQ-1024
chunk's largest level, [2, 32, 1024, 1024], at all 26 of the chunk's
modulated-conv inputs, at ragged planes and on inputs one element past a
16-byte boundary, with g_x bitwise equal to the plain version, g_s within
one f32 ulp and two calls bitwise equal. Recompute in the backward
(``torch.utils.checkpoint``) around blocks that launch K2 and K3, and around
K1, relaunches their forwards and keeps the gradients. K1's bfloat16 route (the
tensor-core kernels) is also held at every head width it takes, on peaked
logits that pin the masking of padded keys, for bitwise repeatability, and
for the precision of its dS products against a float64 computation; its
float32 route (3xTF32) at every head width, at the BigGAN and ragged
shapes, for bitwise repeatability (five calls in a row at the transform
search's population 7) and for NaN propagation, and both
routes' work counts against the source note. The transform search's warps
(the two-product warp, its inverse and ``grid_sample``) and its un-warped
tell are held against the CPU.

Every test here is marked ``cuda`` and skips without an NVIDIA GPU. The file
imports neither JAX nor the JAX package, so it also runs where JAX is not
installed; there the JAX test harness is bypassed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from pix2latent_tpu_torch.ops import attention as A
from pix2latent_tpu_torch.ops import fir_blur as FB
from pix2latent_tpu_torch.ops import mod_backward as MB
from pix2latent_tpu_torch.models.stylegan2 import (channels_for,
                                                   modulated_conv_inputs)

pytestmark = pytest.mark.cuda

# (atol=rtol) for the output and for the gradients, as tests/test_attention.py
TOL = {torch.float32: (1e-5, 2e-4), torch.bfloat16: (2e-2, 5e-2)}

SHAPES = [
    (2, 256, 64, 8, 16),       # the CPU parity tests' shape
    (3, 100, 37, 5, 20),       # ragged q and k, odd d
    (2, 4096, 1024, 32, 128),  # biggan-deep-128 attention
    (18, 4096, 1024, 64, 256), # biggan-deep-256 at pop 18
]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _inputs(shape, dtype, device, seed=0):
    n, q, k, d, dv = shape
    rng = np.random.RandomState(seed)
    mk = lambda *s: torch.tensor(rng.randn(*s).astype(np.float32) * 0.5,
                                 device=device).to(dtype)
    return mk(n, q, d), mk(n, k, d), mk(n, k, dv), mk(n, q, dv)


def _fwd_bwd(fn, inputs):
    theta, phi, g, cot = inputs
    ins = [t.clone().requires_grad_(True) for t in (theta, phi, g)]
    out = fn(*ins)
    return [out.detach()] + list(torch.autograd.grad(out, ins, cot))


def _matches_plain(shape, dtype, device):
    theta, phi, g, cot = _inputs(shape, dtype, device)
    tol_o, tol_g = TOL[dtype]
    A.reset_launch_counts()

    ins_k = [t.clone().requires_grad_(True) for t in (theta, phi, g)]
    out_k = A.sagan_attention(*ins_k)
    (out_k.float() * cot.float()).sum().backward()

    ins_r = [t.clone().requires_grad_(True) for t in (theta, phi, g)]
    out_r = A.sagan_attention_reference(*ins_r)
    (out_r.float() * cot.float()).sum().backward()
    torch.cuda.synchronize()

    assert A.launch_counts() == {"fwd": 1, "bwd": 1}
    assert out_k.dtype == dtype and out_k.shape == out_r.shape
    torch.testing.assert_close(out_k.float(), out_r.float(), rtol=tol_o,
                               atol=tol_o)
    for a, b, name in zip(ins_k, ins_r, ("dtheta", "dphi", "dg")):
        assert a.grad.dtype == dtype, name
        torch.testing.assert_close(a.grad.float(), b.grad.float(), rtol=tol_g,
                                   atol=tol_g, msg=name)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", SHAPES)
def test_kernel_matches_plain(cuda, shape, dtype):
    _matches_plain(shape, dtype, cuda)


@pytest.mark.parametrize("dv", [16, 128, 256, 512])
@pytest.mark.parametrize("d", [8, 16, 32, 64, 128])
def test_bf16_head_widths_match_plain(cuda, d, dv):
    # q and k ragged against the 64-row tiles, every padded width of d and dv
    _matches_plain((2, 200, 150, d, dv), torch.bfloat16, cuda)


@pytest.mark.parametrize("shape", [(2, 4100, 1030, 64, 256),
                                   (1, 4096, 1024, 64, 256)])
def test_bf16_ragged_path_shapes_match_plain(cuda, shape):
    _matches_plain(shape, torch.bfloat16, cuda)


@pytest.mark.parametrize("d", [2, 64])
def test_bf16_peaked_logits_mask_padded_keys(cuda, d):
    # key 0 dominates (logit -2 against -16): p rounds to 1.0 in bf16 and the
    # output is exactly g's row 0; if the 61 padded keys of the tile counted
    # with logit 0, they would take almost all of the probability
    theta = torch.ones((1, 100, d), device=cuda, dtype=torch.bfloat16)
    phi = torch.tensor([[-2.0], [-16.0], [-16.0]], device=cuda).div(d)
    phi = phi.expand(3, d)[None].contiguous().to(torch.bfloat16)
    g = torch.tensor([[[1.5, -2.0], [7.0, 3.0], [-5.0, 4.0]]], device=cuda,
                     dtype=torch.bfloat16)
    cot = torch.ones((1, 100, 2), device=cuda, dtype=torch.bfloat16)
    got = _fwd_bwd(A.sagan_attention, (theta, phi, g, cot))
    want = _fwd_bwd(A.sagan_attention_reference, (theta, phi, g, cot))
    torch.cuda.synchronize()
    np.testing.assert_array_equal(got[0].float().cpu().numpy(),
                                  np.tile([[1.5, -2.0]], (1, 100, 1)))
    np.testing.assert_array_equal(got[0].float().cpu().numpy(),
                                  want[0].float().cpu().numpy())
    tol = TOL[torch.bfloat16][1]
    for a, b in zip(got[1:], want[1:]):
        torch.testing.assert_close(a.float(), b.float(), rtol=tol, atol=tol)


def test_bf16_kernel_is_deterministic(cuda):
    inputs = _inputs((2, 4100, 1030, 64, 256), torch.bfloat16, cuda)
    first = _fwd_bwd(A.sagan_attention, inputs)
    second = _fwd_bwd(A.sagan_attention, inputs)
    torch.cuda.synchronize()
    for a, b, name in zip(first, second, ("out", "dtheta", "dphi", "dg")):
        assert torch.equal(a, b), name


def test_bf16_ds_products_keep_f32_precision(cuda):
    # dS enters dtheta and dphi as bf16 hi + lo: the kernel's gradients are
    # no further from a float64 computation than the plain version's (whose
    # autograd rounds dP to bf16); with dS rounded once to bf16, dtheta's
    # error would be 1.27x the plain version's on an H100 (PERF.md, section 6)
    shape = (18, 4096, 1024, 64, 256)
    inputs = _inputs(shape, torch.bfloat16, cuda)
    got = _fwd_bwd(A.sagan_attention, inputs)[1:3]
    plain = _fwd_bwd(A.sagan_attention_reference, inputs)[1:3]
    theta, phi, g, cot = (t.double() for t in inputs)
    p = torch.softmax(theta @ phi.transpose(1, 2), dim=-1)
    dp = cot @ g.transpose(1, 2)
    ds = p * (dp - (p * dp).sum(-1, keepdim=True))
    del p, dp
    exact = (ds @ phi, ds.transpose(1, 2) @ theta)
    for name, a, b, x in zip(("dtheta", "dphi"), got, plain, exact):
        err_kernel = float((a.double() - x).abs().max())
        err_plain = float((b.double() - x).abs().max())
        assert err_kernel <= err_plain, (name, err_kernel, err_plain)


@pytest.mark.parametrize("shape", [(18, 4096, 1024, 64, 256),
                                   (18, 4096, 1024, 32, 128)])
def test_bf16_work_count_matches_the_source_note(cuda, shape):
    # no tile padding at the BigGAN shapes: U (2d + dv) forward, U (7d + 4dv)
    # backward, U = 2 n q k
    n, q, k, d, dv = shape
    u = 2 * n * q * k
    assert A.kernel_work(*shape, torch.bfloat16) == (u * (2 * d + dv),
                                                     u * (7 * d + 4 * dv))
    # the float32 route (3xTF32): three tensor-core products each, every
    # product formed once, U (d + dv) forward and U (3d + 2dv) backward
    assert A.kernel_work(*shape, torch.float32) == (3 * u * (d + dv),
                                                    3 * u * (3 * d + 2 * dv))
    # padding only adds work: ragged q, k, d and dv
    u = 2 * 2 * 100 * 37
    fwd, bwd = A.kernel_work(2, 100, 37, 5, 20, torch.bfloat16)
    assert fwd > u * (5 + 20) and bwd > u * (3 * 5 + 2 * 20)
    fwd, bwd = A.kernel_work(2, 100, 37, 5, 20, torch.float32)
    assert fwd > 3 * u * (5 + 20) and bwd > 3 * u * (3 * 5 + 2 * 20)


@pytest.mark.parametrize("dv", [16, 128, 256, 512])
@pytest.mark.parametrize("d", [8, 16, 32, 64, 128])
def test_f32_head_widths_match_plain(cuda, d, dv):
    # the float32 route (3xTF32) at every padded width of d and dv, q and k
    # ragged against the tiles
    _matches_plain((2, 200, 150, d, dv), torch.float32, cuda)


@pytest.mark.parametrize("shape", [(18, 4096, 1024, 32, 128),
                                   (2, 4100, 1030, 64, 256),
                                   (1, 4096, 1024, 64, 256),
                                   (3, 100, 37, 5, 20)])
def test_f32_path_and_ragged_shapes_match_plain(cuda, shape):
    _matches_plain(shape, torch.float32, cuda)


@pytest.mark.parametrize("shape", [(18, 4096, 1024, 64, 256),
                                   (2, 4100, 1030, 64, 256)])
def test_f32_kernel_is_deterministic(cuda, shape):
    inputs = _inputs(shape, torch.float32, cuda)
    first = _fwd_bwd(A.sagan_attention, inputs)
    second = _fwd_bwd(A.sagan_attention, inputs)
    torch.cuda.synchronize()
    for a, b, name in zip(first, second, ("out", "dtheta", "dphi", "dg")):
        assert torch.equal(a, b), name



def test_f32_search_population_repeats_within_tolerance(cuda):
    # the transform search's shape, pop 7: five forward + backward calls in
    # a row, the first within tolerance of the plain version, every one
    # bitwise equal to it
    names = ("out", "dtheta", "dphi", "dg")
    inputs = _inputs((7, 4096, 1024, 64, 256), torch.float32, cuda)
    want = _fwd_bwd(A.sagan_attention_reference, inputs)
    first = _fwd_bwd(A.sagan_attention, inputs)
    tol_o, tol_g = TOL[torch.float32]
    for a, b, name, tol in zip(first, want, names, (tol_o,) + (tol_g,) * 3):
        assert bool(torch.isfinite(a).all()), name
        torch.testing.assert_close(a, b, rtol=tol, atol=tol, msg=name)
    for _ in range(4):
        again = _fwd_bwd(A.sagan_attention, inputs)
        torch.cuda.synchronize()
        for a, b, name in zip(first, again, names):
            assert torch.equal(a, b), name

def test_f32_nan_input_stays_nan(cuda):
    # CUDA's own NaN (0x7fffffff) carries out of the tf32 rounding's add:
    # the split keeps it in lo, so the row that reads it stays NaN
    theta, phi, g, _ = _inputs((1, 64, 32, 16, 16), torch.float32, cuda)
    theta[0, 5, 3] = torch.tensor(0x7FFFFFFF, dtype=torch.int32).view(
        torch.float32)
    theta[0, 9, 1] = float("nan")
    out = A.sagan_attention(theta, phi, g)
    torch.cuda.synchronize()
    nan_rows = torch.isnan(out[0]).any(-1).nonzero().flatten().tolist()
    assert nan_rows == [5, 9]


def test_kernel_rejects_what_it_does_not_take(cuda):
    theta, phi, g, _ = _inputs((1, 64, 16, 8, 16), torch.float32, cuda)
    with pytest.raises(TypeError):
        A.sagan_attention(theta.half(), phi.half(), g.half())
    with pytest.raises(ValueError):
        A.sagan_attention(theta.transpose(1, 2).contiguous().transpose(1, 2),
                          phi, g)
    with pytest.raises(ValueError):
        A.sagan_attention(theta, phi, g.cpu())
    big = torch.zeros((1, 16, 1024), device=cuda)
    with pytest.raises(ValueError):
        A.sagan_attention(theta, phi, big)


# --------------------------------------------------------------------- #
# K2: separable FIR blur                                                 #
# --------------------------------------------------------------------- #

TAPS = (0.25, 0.75, 0.75, 0.25)   # [1, 3, 3, 1] / 8 * sqrt(4), the up-path blur
# (rtol, atol) of the output and the gradient: the f32 tolerances of
# tests/test_pallas_fir.py; in bf16 one rounding step, since kernel and plain
# version round one f32 sum once and the sums differ only in operation order
FIR_TOL = {torch.float32: ((0.0, 1e-5), (0.0, 1e-4)),
           torch.bfloat16: ((2.0 ** -7, 1e-5), (2.0 ** -7, 1e-5))}
# the up-path blurs of StyleGAN2 at n = 2: [2, ch(r), r+1, r+1], seven
# levels for cars-512 and an eighth, r = 1024, for FFHQ-1024
FIR_LEVELS = [((2, channels_for(r), r + 1, r + 1), (1, 1))
              for r in (8, 16, 32, 64, 128, 256, 512, 1024)]
# widths about the 1024-wide FFHQ rows: in float32 a 1025-wide row is 257
# sixteen-byte runs, one more than a tile row holds, so the adjoint's
# 1025-wide output takes the column-segment mode
FIR_WIDE = [((2, 3, 9, w), (1, 1)) for w in (1024, 1025, 1026)] + [
    ((2, 3, 9, w), (2, 1)) for w in (1024, 1025, 1026)]
# plane sides against the 16-byte runs and the strips: each as the height
# and as the width, with pad (2, 1) so that the output keeps the size
FIR_SIDES = (1, 2, 7, 8, 9, 15, 16, 17, 63, 64, 65, 511, 512, 513)
FIR_CASES = [
    ((3, 5, 37, 41), (2, 1)),      # ragged planes, asymmetric pad
    ((2, 4, 9, 9), (1, 1)),        # the smallest path level (r = 8)
    ((22, 64, 513, 513), (1, 1)),  # the largest path level (r = 512)
] + FIR_LEVELS + [((2, 3, s, 17), (2, 1)) for s in FIR_SIDES] + [
    ((2, 3, 9, s), (2, 1)) for s in FIR_SIDES]


def _taps(k):
    return TAPS if k == 4 else tuple(float(v) for v in np.linspace(0.1, 0.9, k))


def _fir_inputs(shape, k, pad, dtype, device, offset=0, seed=1):
    """x and the output gradient, made with numpy; with ``offset``, each a
    contiguous view that starts ``offset`` elements into its buffer."""
    rng = np.random.RandomState(seed)
    n, c, h, w = shape
    out = (n, c, h + sum(pad) - k + 1, w + sum(pad) - k + 1)

    def mk(s):
        buf = torch.tensor(rng.randn(int(np.prod(s)) + offset).astype(np.float32),
                           device=device).to(dtype)
        return buf[offset:].view(s)
    return mk(shape), mk(out)


def _fir_matches_plain(shape, pad, dtype, device, k=4, offset=0):
    taps = _taps(k)
    x, cot = _fir_inputs(shape, k, pad, dtype, device, offset)
    assert x.is_contiguous() and cot.is_contiguous()
    FB.reset_launch_counts()
    x_k = x.clone() if offset == 0 else x.detach()
    x_k.requires_grad_(True)
    y_k = FB.fir_blur(x_k, taps, pad)
    y_k.backward(cot)
    x_r = x.clone().requires_grad_(True)
    y_r = FB.fir_blur_reference(x_r, taps, pad)
    y_r.backward(cot)
    torch.cuda.synchronize()

    assert FB.launch_counts() == {"fwd": 1, "bwd": 1}
    assert y_k.dtype == dtype and y_k.shape == cot.shape
    assert x_k.grad.dtype == dtype
    (rt_o, at_o), (rt_g, at_g) = FIR_TOL[dtype]
    torch.testing.assert_close(y_k.float(), y_r.float(), rtol=rt_o, atol=at_o)
    torch.testing.assert_close(x_k.grad.float(), x_r.grad.float(), rtol=rt_g,
                               atol=at_g)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,pad", FIR_CASES)
def test_fir_blur_kernel_matches_plain(cuda, shape, pad, dtype):
    _fir_matches_plain(shape, pad, dtype, cuda)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,pad", FIR_WIDE)
def test_fir_blur_ffhq_row_widths_match_plain(cuda, shape, pad, dtype):
    _fir_matches_plain(shape, pad, dtype, cuda)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("pad", [(0, 0), (2, 1), (0, 3), (3, 0)])
@pytest.mark.parametrize("k", [1, 2, 3, 5, 8])
def test_fir_blur_taps_and_pads_match_plain(cuda, k, pad, dtype):
    _fir_matches_plain((2, 3, 19, 23), pad, dtype, cuda, k=k)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,pad", [((2, 3, 37, 41), (2, 1)),
                                       ((2, 64, 513, 513), (1, 1))])
def test_fir_blur_unaligned_input_matches_plain(cuda, shape, pad, dtype):
    # x and the output gradient start one element past a 16-byte boundary
    _fir_matches_plain(shape, pad, dtype, cuda, offset=1)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fir_blur_kernel_is_deterministic(cuda, dtype):
    x, cot = _fir_inputs((22, 64, 513, 513), 4, (1, 1), dtype, cuda)
    runs = [(FB.kernel_forward(x, TAPS, (1, 1)),
             FB.kernel_backward(cot, TAPS, (1, 1))) for _ in range(2)]
    torch.cuda.synchronize()
    for a, b, name in zip(*runs, ("forward", "adjoint")):
        assert torch.equal(a, b), name


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,pad", FIR_LEVELS + [((3, 5, 37, 41), (2, 1))])
def test_fir_blur_work_covers_the_minimum(cuda, shape, pad, dtype):
    # each input read once and each output written once at the least
    n, c, h, w = shape
    size = 2 if dtype == torch.bfloat16 else 4
    for s, p in ((shape, pad), ((n, c, h + sum(pad) - 3, w + sum(pad) - 3),
                                (3 - pad[0], 3 - pad[1]))):
        ho, wo = s[2] + sum(p) - 3, s[3] + sum(p) - 3
        work = FB.kernel_work(s, 4, p, dtype)
        assert work >= size * n * c * (s[2] * s[3] + ho * wo)
        # the halo rows read again stay a small share at the path levels
        assert work <= 1.25 * size * n * c * (s[2] * s[3] + ho * wo)


def test_fir_blur_rejects_what_it_does_not_take(cuda):
    x = torch.zeros((1, 2, 8, 8), device=cuda)
    with pytest.raises(TypeError):
        FB.fir_blur(x.half(), TAPS, (1, 1))
    with pytest.raises(ValueError):
        FB.fir_blur(x.transpose(2, 3), TAPS, (1, 1))
    with pytest.raises(ValueError):
        FB.fir_blur(x[0], TAPS, (1, 1))
    with pytest.raises(ValueError):
        FB.fir_blur(x, [0.1] * 9, (1, 1))


# --------------------------------------------------------------------- #
# K3: fused modulation backward                                          #
# --------------------------------------------------------------------- #

# (rtol, atol) of g_x and of g_s, tests/test_mod_backward.py
MOD_TOL = {torch.float32: ((1e-6, 0.0), (5e-5, 1e-5)),
           torch.bfloat16: ((2e-2, 1e-2), (2e-2, 1e-2))}
MOD_SHAPES = [
    (3, 5, 7, 9),          # ragged plane: one element a thread
    (22, 512, 4, 4),       # the smallest path level
    (22, 64, 512, 512),    # the largest cars-512 level
    (2, 32, 1024, 1024),   # the largest FFHQ-1024 level, one 2-sample chunk
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", MOD_SHAPES)
def test_mod_backward_kernel_matches_plain(cuda, shape, dtype):
    rng = np.random.RandomState(2)
    n, c = shape[:2]
    g = torch.tensor(rng.randn(*shape).astype(np.float32), device=cuda).to(dtype)
    x = torch.tensor(rng.randn(*shape).astype(np.float32), device=cuda).to(dtype)
    s = torch.tensor(rng.rand(n, c).astype(np.float32) + 0.5,
                     device=cuda).to(dtype)
    MB.reset_launch_counts()
    gx, gs = MB.fused_mod_backward(g, x, s)
    gx_r, gs_r = MB.mod_backward_reference(g, x, s)
    torch.cuda.synchronize()

    assert MB.launch_counts() == {"bwd": 1}
    assert gx.dtype == dtype and gs.dtype == torch.float32
    (rt_x, at_x), (rt_s, at_s) = MOD_TOL[dtype]
    torch.testing.assert_close(gx.float(), gx_r.float(), rtol=rt_x, atol=at_x)
    torch.testing.assert_close(gs, gs_r, rtol=rt_s, atol=at_s)


def _mod_exact(shape, dtype, device, offset=0, seed=4):
    """K3 against the plain version: g_x bitwise equal, g_s within one f32
    ulp (an f64 sum of exact products rounded once, in another order), and
    two calls bitwise equal. ``offset`` starts g, x (and so g_x's reads)
    that many elements past a 16-byte boundary."""
    rng = np.random.RandomState(seed)
    n, c, h, w = shape

    def mk():
        flat = torch.tensor(rng.randn(n * c * h * w + offset).astype(
            np.float32), device=device).to(dtype)
        return flat[offset:].view(shape)

    g, x = mk(), mk()
    s = torch.tensor(rng.rand(n, c).astype(np.float32) + 0.5,
                     device=device).to(dtype)
    MB.reset_launch_counts()
    gx, gs = MB.fused_mod_backward(g, x, s)
    again = MB.fused_mod_backward(g, x, s)
    gx_r, gs_r = MB.mod_backward_reference(g, x, s)
    torch.cuda.synchronize()
    assert MB.launch_counts() == {"bwd": 2}
    assert torch.equal(gx, gx_r)
    ulps = (gs.view(torch.int32).long() - gs_r.view(torch.int32).long()).abs()
    assert int(ulps.max()) <= 1
    assert torch.equal(again[0], gx) and torch.equal(again[1], gs)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", sorted({shape for _, shape in
                                          modulated_conv_inputs(1024, 2)}))
def test_mod_backward_ffhq_levels_exact(cuda, shape, dtype):
    _mod_exact(shape, dtype, cuda)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("shape", [(3, 5, 7, 9), (2, 16, 33, 31),
                                   (2, 8, 300, 301), (2, 32, 1024, 1024),
                                   (22, 64, 512, 512)])
def test_mod_backward_ragged_and_unaligned_exact(cuda, shape, offset, dtype):
    # (2, 8, 300, 301): a ragged plane split 4 ways; offset 1: element-wise
    # loads on every shape
    _mod_exact(shape, dtype, cuda, offset)


def test_modulate_vjp_runs_the_kernel(cuda):
    rng = np.random.RandomState(3)
    x = torch.tensor(rng.randn(2, 8, 16, 16).astype(np.float32), device=cuda)
    s = torch.tensor(rng.rand(2, 8).astype(np.float32) + 0.5, device=cuda)
    tgt = torch.tensor(rng.randn(2, 8, 16, 16).astype(np.float32), device=cuda)
    grads = []
    for fused in (False, True):
        xs = [x.clone().requires_grad_(True), s.clone().requires_grad_(True)]
        (torch.sin(MB.modulate(*xs, fused=fused)) * tgt).sum().backward()
        grads.append([t.grad for t in xs])
    MB.reset_launch_counts()
    xs = [x.clone().requires_grad_(True), s.clone().requires_grad_(True)]
    MB.modulate(*xs, fused=True).sum().backward()
    assert MB.launch_counts() == {"bwd": 1}
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, rtol=5e-5, atol=1e-5)


def test_mod_backward_rejects_what_it_does_not_take(cuda):
    g = torch.zeros((2, 3, 4, 4), device=cuda)
    s = torch.ones((2, 3), device=cuda)
    with pytest.raises(TypeError):
        MB.fused_mod_backward(g.half(), g.half(), s.half())
    with pytest.raises(ValueError):
        MB.fused_mod_backward(g.transpose(2, 3), g, s)
    with pytest.raises(ValueError):
        MB.fused_mod_backward(g, g, s[:, :2].contiguous())
    with pytest.raises(ValueError):
        MB.fused_mod_backward(g, g.cpu(), s)


# --------------------------------------------------------------------- #
# remat with the kernels inside the recomputed blocks                    #
# --------------------------------------------------------------------- #

def _sg2_grads(dtype, remat_from_res, device):
    """z-gradient and loss of a StyleGAN2 at im_res 64 (channel multiplier
    1, equalized weights from a seed), both kernel flags on."""
    import warnings

    from pix2latent_tpu_torch.models import stylegan2 as S

    saved = S.StyleGAN2.MODELS
    S.StyleGAN2.MODELS = dict(saved, t64=64)
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            model = S.StyleGAN2("t64", channel_multiplier=1, dtype=dtype,
                                fused_mod_bwd=True, fir_kernel=True,
                                remat_from_res=remat_from_res,
                                init="equalized", seed=3, device=device)
    finally:
        S.StyleGAN2.MODELS = saved
    rng = np.random.RandomState(4)
    z = torch.tensor(rng.randn(2, 512).astype(np.float32), device=device,
                     requires_grad=True)
    cot = torch.tensor(rng.randn(2, 64, 64, 3).astype(np.float32),
                       device=device)
    FB.reset_launch_counts()
    MB.reset_launch_counts()
    out = model(z=z)
    (out * cot).sum().backward()
    torch.cuda.synchronize()
    return out.detach(), z.grad, FB.launch_counts(), MB.launch_counts()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_remat_runs_the_kernels_and_keeps_the_gradients(cuda, dtype):
    # cuDNN's default f32 algorithms are not repeatable: two runs of the
    # same model, without remat, give z-gradients up to 1e-4 apart
    # (relative). Deterministic algorithms isolate what remat changes.
    with torch.backends.cudnn.flags(enabled=True, benchmark=False,
                                    deterministic=True, allow_tf32=False):
        out, grad, fb, mb = _sg2_grads(dtype, 0, cuda)
        out_r, grad_r, fb_r, mb_r = _sg2_grads(dtype, 32, cuda)
    # four up-path blurs (r = 8 .. 64) and 14 modulated convs; remat from
    # 32 recomputes the up-convs of levels 32 and 64 in the backward
    assert fb == {"fwd": 4, "bwd": 4} and mb == {"bwd": 14}
    assert fb_r == {"fwd": 6, "bwd": 4} and mb_r == {"bwd": 14}
    # images and gradients held by their relative error |a - b| / |b|:
    # f32 1e-5, bf16 2e-2
    tol = 1e-5 if dtype == torch.float32 else 2e-2
    for name, got, want in (("image", out_r, out), ("z-grad", grad_r, grad)):
        rel = float((got - want).norm() / want.norm())
        assert rel <= tol, (name, rel)
    assert float(grad.abs().max()) > 0


def test_remat_around_the_attention_kernel(cuda):
    from torch.utils.checkpoint import checkpoint

    theta, phi, g, cot = _inputs((2, 256, 64, 8, 16), torch.bfloat16, cuda)
    grads = []
    for remat in (False, True):
        ins = [t.clone().requires_grad_(True) for t in (theta, phi, g)]
        A.reset_launch_counts()
        if remat:
            out = checkpoint(A.sagan_attention, *ins, use_reentrant=False)
        else:
            out = A.sagan_attention(*ins)
        (out.float() * cot.float()).sum().backward()
        torch.cuda.synchronize()
        assert A.launch_counts() == {"fwd": 1 + remat, "bwd": 1}
        grads.append([t.grad for t in ins])
    for a, b in zip(*grads):
        assert torch.equal(a, b)


# --------------------------------------------------------------------- #
# the transform search's warp and un-warped tell                          #
# --------------------------------------------------------------------- #

def _tell_problem(device):
    from pix2latent_tpu_torch import VariableManager
    from pix2latent_tpu_torch import loss_functions as LF
    from pix2latent_tpu_torch.core.step import ExecutionCore
    from pix2latent_tpu_torch.models.toy import make_toy_model
    from pix2latent_tpu_torch.transform import SpatialOnly, setup_transform_fn

    rng = np.random.RandomState(5)
    model = make_toy_model(z_dim=8, res=64, width=16, seed=0, device=device)
    vm = VariableManager(seed=0, device=device)
    vm.register("z", shape=(8,), var_type="input")
    vm.register("target", shape=(64, 64, 3), var_type="output",
                requires_grad=False,
                default=rng.uniform(-1, 1, (64, 64, 3)).astype(np.float32))
    vm.register("weight", shape=(64, 64, 3), var_type="output",
                requires_grad=False,
                default=(rng.rand(64, 64, 3) > 0.2).astype(np.float32))
    vm.register("t", shape=(5,), var_type="transform", requires_grad=False,
                default=np.zeros(5, np.float32))
    fn, _ = setup_transform_fn(spatial_transform=True,
                               color_transform=("hue", "brightness"),
                               device=device)
    core = ExecutionCore(model, vm, lambda out, target, weight:
                         LF.masked_l1_loss(out, target, weight),
                         max_batch_size=3)
    core.register_transform(fn, "t", "target")
    core.register_transform(SpatialOnly(fn), "t", "weight")
    variables = vm.initialize(7)
    variables["input"]["z"] = torch.tensor(
        rng.randn(7, 8).astype(np.float32), device=device)
    variables["transform"]["t"] = torch.tensor(
        (rng.randn(7, 5) + [0, 0, 0, 0, 1]).astype(np.float32), device=device)
    return core, variables


def test_transform_warp_and_unwarped_tell_match_the_cpu(cuda):
    from pix2latent_tpu_torch.ops import affine_matmul as AM
    from pix2latent_tpu_torch.ops import grid_sample as GS

    rng = np.random.RandomState(4)
    im = rng.uniform(-1, 1, (7, 256, 256, 3)).astype(np.float32)
    t = np.stack([rng.uniform(0.8, 1.25, 7), rng.uniform(-0.3, 0.3, 7),
                  rng.uniform(-0.3, 0.3, 7)], 1).astype(np.float32)
    theta = np.zeros((7, 2, 3), np.float32)
    theta[:, 0, 0] = theta[:, 1, 1] = t[:, 0]
    theta[:, :, 2] = t[:, 1:]
    for fn, arg in ((AM.affine_warp_matmul_t, t),
                    (AM.inverse_affine_warp_matmul_t, t),
                    (GS.affine_warp, theta)):
        want = fn(torch.tensor(im), torch.tensor(arg))
        got = fn(torch.tensor(im, device=cuda), torch.tensor(arg, device=cuda))
        torch.testing.assert_close(got.cpu(), want, rtol=1e-5, atol=1e-5)

    losses = []
    for device in ("cpu", cuda):
        core, variables = _tell_problem(device)
        gen = torch.Generator(device=device).manual_seed(0)
        warped = core._dedupe_outputs(core.apply_transforms(variables))
        assert warped["output"]["target"].shape == (7, 64, 64, 3)
        losses.append([core.tell_loss(warped, gen, 0).cpu(),
                       core.tell_loss(warped, gen, 0, inverted=False).cpu()])
    (tell_cpu, warped_cpu), (tell, warped_loss) = losses
    torch.testing.assert_close(tell, tell_cpu, rtol=1e-4, atol=1e-6)
    torch.testing.assert_close(warped_loss, warped_cpu, rtol=1e-4, atol=1e-6)
    assert not torch.allclose(tell, warped_loss, rtol=0.05)
