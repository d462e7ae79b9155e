"""The port's fused modulation backward (K3) against the JAX package's.

On the CPU ``fused_mod_backward`` runs its plain version, and
``modulate(fused=True)`` runs it as the custom backward (with the cast of
``g_s`` to s's type). The JAX side runs the Pallas kernel with
``interpret=True``. Tolerances are those of ``tests/test_mod_backward.py``:
float32 ``g_x`` rtol 1e-6 and ``g_s`` rtol 5e-5, atol 1e-5; bfloat16 rtol
2e-2, atol 1e-2; the VJP rtol 5e-5, atol 1e-5. JAX is NHWC, the port NCHW.
The Pallas kernel tiles h*w in blocks of 8 rows, so its shapes here keep
h*w a multiple of 8 (the port's plain version and kernel take any shape).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pix2latent_tpu.ops import mod_backward as J
from pix2latent_tpu_torch.ops import mod_backward as MB


def _nhwc(a):
    return jnp.asarray(a.transpose(0, 2, 3, 1))


def _nchw(a):
    return np.asarray(a, np.float32).transpose(0, 3, 1, 2)


def _inputs(shape, seed):
    rng = np.random.RandomState(seed)
    n, c = shape[:2]
    g = rng.randn(*shape).astype(np.float32)
    x = rng.randn(*shape).astype(np.float32)
    s = (rng.rand(n, c) + 0.5).astype(np.float32)
    return g, x, s


@pytest.mark.parametrize("shape", [(3, 8, 4, 4), (2, 16, 6, 4)])
def test_matches_pallas_kernel(shape):
    g, x, s = _inputs(shape, 0)
    jgx, jgs = J.fused_mod_backward(_nhwc(g), _nhwc(x), jnp.asarray(s),
                                    interpret=True)
    MB.reset_launch_counts()
    gx, gs = MB.fused_mod_backward(torch.tensor(g), torch.tensor(x),
                                   torch.tensor(s))
    assert gs.dtype == torch.float32 and gx.dtype == torch.float32
    np.testing.assert_allclose(gx.numpy(), _nchw(jgx), rtol=1e-6)
    np.testing.assert_allclose(gs.numpy(), np.asarray(jgs), rtol=5e-5,
                               atol=1e-5)
    assert MB.launch_counts() == {"bwd": 0}              # CPU: plain version


def test_bf16_matches_pallas_kernel():
    g, x, s = _inputs((2, 16, 8, 8), 1)
    bf = jnp.bfloat16
    jgx, jgs = J.fused_mod_backward(_nhwc(g).astype(bf), _nhwc(x).astype(bf),
                                    jnp.asarray(s, bf), interpret=True)
    tb = lambda a: torch.tensor(a).bfloat16()
    gx, gs = MB.fused_mod_backward(tb(g), tb(x), tb(s))
    assert gx.dtype == torch.bfloat16 and gs.dtype == torch.float32
    np.testing.assert_allclose(gx.float().numpy(), _nchw(jgx), rtol=2e-2,
                               atol=1e-2)
    np.testing.assert_allclose(gs.numpy(), np.asarray(jgs), rtol=2e-2,
                               atol=1e-2)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_modulate_vjp_matches_jax(dtype):
    rng = np.random.RandomState(2)
    x = rng.randn(2, 8, 8, 6).astype(np.float32)
    s = (rng.rand(2, 8) + 0.5).astype(np.float32)
    tgt = rng.randn(2, 8, 8, 6).astype(np.float32)
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16

    def jloss(xj, sj):
        y = J.modulate(xj, sj, fused=True, interpret=True)
        return jnp.sum(jnp.sin(y.astype(jnp.float32)) * _nhwc(tgt))

    jdx, jds = jax.grad(jloss, argnums=(0, 1))(_nhwc(x).astype(jdt),
                                               jnp.asarray(s, jdt))
    tol = (dict(rtol=5e-5, atol=1e-5) if dtype == torch.float32
           else dict(rtol=2e-2, atol=1e-2))
    for fused in (True, False):
        xt = torch.tensor(x).to(dtype).requires_grad_(True)
        st = torch.tensor(s).to(dtype).requires_grad_(True)
        y = MB.modulate(xt, st, fused=fused)
        (torch.sin(y.float()) * torch.tensor(tgt)).sum().backward()
        assert xt.grad.dtype == dtype and st.grad.dtype == dtype
        np.testing.assert_allclose(xt.grad.float().numpy(), _nchw(jdx), **tol)
        np.testing.assert_allclose(st.grad.float().numpy(),
                                   np.asarray(jds, np.float32), **tol)


def test_tensors_off_the_cpu_never_reach_the_plain_version():
    g = torch.empty((2, 3, 4, 4), device="meta")
    s = torch.empty((2, 3), device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        MB.fused_mod_backward(g, g, s)
    # a mix of devices is refused too, not split between the two versions
    with pytest.raises(ValueError):
        MB.fused_mod_backward(torch.zeros(2, 3, 4, 4), g, s)


# --------------------------------------------------------------------- #
# The kernel's plan: planes cut into ranges, one block (and cluster) each #
# --------------------------------------------------------------------- #

PLAN_SHAPES = [(22, 64, 512, 512), (2, 32, 1024, 1024), (2, 64, 512, 512),
               (2, 128, 256, 256), (2, 512, 4, 4), (3, 5, 7, 9),
               (2, 3, 1000, 999)]


@pytest.mark.parametrize("itemsize", [2, 4])
@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("shape", PLAN_SHAPES)
def test_plan_covers_every_element_once(shape, aligned, itemsize):
    n, c, h, w = shape
    splits, threads, vec = MB.mod_backward_plan(n * c, h * w,
                                                itemsize=itemsize,
                                                aligned=aligned)
    assert 1 <= splits <= 8 and splits & (splits - 1) == 0
    assert 32 <= threads <= 256 and threads % 32 == 0
    whole = (h * w) % (16 // itemsize) == 0
    assert vec == (16 // itemsize if aligned and whole else 1)
    ranges = MB.plan_ranges(h * w, splits, vec)
    assert len(ranges) == splits
    covered = np.zeros(h * w, np.int64)
    for start, end in ranges:
        covered[start:end] += 1
        if vec > 1 and start < end:
            assert (start * itemsize) % 16 == 0 and (end - start) % vec == 0
    np.testing.assert_array_equal(covered, 1)


def test_plan_keeps_one_block_a_plane_where_planes_fill_the_card():
    for itemsize in (2, 4):
        assert MB.mod_backward_plan(22 * 64, 512 * 512,
                                    itemsize=itemsize) == (1, 256, 16 // itemsize)


@pytest.mark.parametrize("itemsize", [2, 4])
def test_plan_splits_the_planes_of_a_two_sample_chunk(itemsize):
    # [2, 64, 512, 512]: 128 planes x 8 = 1024 blocks, at least 4 an SM
    splits, _, _ = MB.mod_backward_plan(2 * 64, 512 * 512, itemsize=itemsize)
    assert 2 * 64 * splits >= 4 * MB.SMS
    # [2, 32, 1024, 1024]: 64 planes take the largest portable cluster, 8,
    # for 512 blocks (3.9 an SM; 4 an SM would take clusters of 16)
    splits, _, _ = MB.mod_backward_plan(2 * 32, 1024 * 1024,
                                        itemsize=itemsize)
    assert splits == MB.MAX_SPLITS == 8 and 2 * 32 * splits >= 3.8 * MB.SMS
    # at least 16 K elements a block
    for n, c, r in ((2, 32, 1024), (2, 64, 512), (2, 128, 256)):
        splits, _, _ = MB.mod_backward_plan(n * c, r * r, itemsize=itemsize)
        assert r * r // splits >= MB.MIN_BLOCK_ELEMENTS


def _split_sum(g, x, splits, vec):
    """g_s as the kernel forms it: per range, an f64 sum of exact products;
    the ranges' sums added in rank order; rounded once to f32."""
    n, c = g.shape[:2]
    gf = g.double().reshape(n * c, -1)
    xf = x.double().reshape(n * c, -1)
    total = torch.zeros(n * c, dtype=torch.float64)
    for start, end in MB.plan_ranges(gf.shape[1], splits, vec):
        total = total + (gf[:, start:end] * xf[:, start:end]).sum(1)
    return total.float().reshape(n, c)


@pytest.mark.parametrize("splits", [1, 2, 4, 8])
@pytest.mark.parametrize("shape", [(3, 5, 7, 9), (2, 4, 33, 17),
                                   (1, 3, 64, 64)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_split_reduction_equals_the_plain_version(shape, splits, dtype):
    g, x, s = (torch.tensor(a).to(dtype) for a in _inputs(shape, 7))
    vec = 16 // g.element_size() if (shape[2] * shape[3]) % 8 == 0 else 1
    _, gs = MB.mod_backward_reference(g, x, s)
    assert torch.equal(_split_sum(g, x, splits, vec), gs)


@pytest.mark.parametrize("im_res", [32, 64])
def test_modulated_conv_inputs_are_what_the_generator_modulates(
        monkeypatch, im_res):
    # the shapes K3 is measured at (chip_smoke.py ffhq_mod_levels) are the
    # shapes the generator hands modulate(), in its order (8 channels a
    # layer, as the tests' tiny configurations have)
    from pix2latent_tpu_torch.models import stylegan2 as S
    monkeypatch.setattr(S, "channels_for", lambda res, cm=2: 8 + res // 8)
    seen = []
    real = S.modulate

    def record(x, s, fused=False):
        seen.append(tuple(x.shape))
        return real(x, s, fused=fused)

    monkeypatch.setattr(S, "modulate", record)
    gen = S.StyleGAN2Generator(im_res=im_res, n_mlp=2)
    with torch.no_grad():
        gen(torch.zeros(3, S.STYLE_DIM))
    want = S.modulated_conv_inputs(im_res, 3)
    assert seen == [shape for _, shape in want]
    assert len(S.modulated_conv_inputs(1024, 2)) == 26
