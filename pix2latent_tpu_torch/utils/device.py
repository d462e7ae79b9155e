"""Device selection for the port's entry points.

Every entry point takes ``device=`` and defaults to ``"cuda"``. Without a GPU
it raises unless the caller asks for the CPU: nothing falls back silently.
"""

from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "plain PyTorch paths on the CPU")
        # float32 must mean float32: cuDNN convolutions default to TF32
        # (about three decimal digits), which breaks f32 parity with the
        # reference; matmuls are set the same way to be explicit. bf16 GEMMs
        # keep f32 reductions, as the reference's accumulation does.
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    elif device.type != "cpu":
        raise ValueError(f"unsupported device {device}")
    return device
