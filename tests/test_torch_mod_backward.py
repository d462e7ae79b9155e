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
