"""The port's SA-GAN attention (plain version, the CPU path of the wrapper)
against the JAX package: the Pallas kernel in interpret mode and the plain
einsum reference, forward and gradients, at the tolerances of
tests/test_attention.py. The CUDA kernel itself is held against the same
plain version on the card (tests/test_torch_cuda.py, chip_smoke.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pix2latent_tpu.ops.attention import (sagan_attention,
                                          sagan_attention_reference)
from pix2latent_tpu_torch.ops import attention as TA

N, Q, K, D, DV = 2, 256, 64, 8, 16
# (atol = rtol) for the output and for the gradients
TOL = {"float32": (1e-5, 2e-4), "bfloat16": (2e-2, 5e-2)}
JAX_FNS = {"pallas_interpret": lambda t, p, g: sagan_attention(t, p, g, True),
           "reference": sagan_attention_reference}


def _inputs(seed=0):
    rng = np.random.RandomState(seed)
    return [rng.randn(*s).astype(np.float32) for s in
            ((N, Q, D), (N, K, D), (N, K, DV), (N, Q, DV))]


def _jax(fn, arrays, dtype):
    theta, phi, g, cot = (jnp.asarray(a).astype(dtype) for a in arrays)

    def loss(t, p, v):
        return jnp.sum((fn(t, p, v) * cot).astype(jnp.float32))

    out = fn(theta, phi, g)
    grads = jax.grad(loss, argnums=(0, 1, 2))(theta, phi, g)
    return [np.asarray(a.astype(jnp.float32)) for a in (out, *grads)]


def _torch(fn, arrays, dtype):
    theta, phi, g, cot = (torch.tensor(a).to(dtype) for a in arrays)
    ins = [t.requires_grad_(True) for t in (theta, phi, g)]
    out = fn(*ins)
    (out.float() * cot.float()).sum().backward()
    return [t.detach().float().numpy() for t in (out, *(i.grad for i in ins))]


@pytest.mark.parametrize("jax_fn", sorted(JAX_FNS))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_version_matches_jax(jax_fn, dtype):
    arrays = _inputs()
    want = _jax(JAX_FNS[jax_fn], arrays, getattr(jnp, dtype))
    got = _torch(TA.sagan_attention_reference, arrays, getattr(torch, dtype))
    tol_o, tol_g = TOL[dtype]
    np.testing.assert_allclose(got[0], want[0], rtol=tol_o, atol=tol_o,
                               err_msg="output")
    for a, b, name in zip(got[1:], want[1:], ("dtheta", "dphi", "dg")):
        np.testing.assert_allclose(a, b, rtol=tol_g, atol=tol_g, err_msg=name)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_wrapper_runs_the_plain_version_on_cpu(dtype):
    arrays = _inputs(1)
    TA.reset_launch_counts()
    got = _torch(TA.sagan_attention, arrays, dtype)
    want = _torch(TA.sagan_attention_reference, arrays, dtype)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    assert TA.launch_counts() == {"fwd": 0, "bwd": 0}
    assert TA.sagan_attention(*(torch.tensor(a).to(dtype)
                                for a in arrays[:3])).dtype == dtype


def test_plain_version_rounds_probabilities_to_g_dtype():
    # one key dominating everywhere: p rounds to 1.0 in bf16, so the output
    # is exactly that key's value row
    theta = torch.ones(1, 4, 2, dtype=torch.bfloat16)
    phi = torch.tensor([[[8.0, 8.0], [0.0, 0.0]]], dtype=torch.bfloat16)
    g = torch.tensor([[[1.5, -2.0], [7.0, 3.0]]], dtype=torch.bfloat16)
    out = TA.sagan_attention_reference(theta, phi, g)
    assert out.dtype == torch.bfloat16
    np.testing.assert_array_equal(out.float().numpy(),
                                  np.tile([[1.5, -2.0]], (1, 4, 1)))
