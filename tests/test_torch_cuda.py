"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here is marked ``cuda`` and skips without an NVIDIA GPU. The file
imports neither JAX nor the JAX package, so it also runs where JAX is not
installed; there the JAX test harness is bypassed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from pix2latent_tpu_torch.ops import attention as A

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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", SHAPES)
def test_kernel_matches_plain(cuda, shape, dtype):
    theta, phi, g, cot = _inputs(shape, dtype, cuda)
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
