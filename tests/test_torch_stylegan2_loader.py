"""``examples/common.py:load_stylegan2`` picks the hand-written kernels by
device: on a CUDA device the FIR blur (K2) and the fused modulation
backward (K3) are on, on the CPU both are off, and ``pack_pairs_max_ch``
stays 0. The model's constructor is replaced by a recorder, so no card is
needed."""

import argparse

import pytest
import torch

from pix2latent_tpu_torch.examples import common
from pix2latent_tpu_torch.models import stylegan2 as S


@pytest.fixture
def built(monkeypatch):
    calls = []

    class Recorder:
        def __init__(self, model, **kwargs):
            calls.append((model, kwargs))

    monkeypatch.setattr(S, "StyleGAN2", Recorder)
    return calls


def _args(device, **kw):
    ns = dict(model="cars", search="z", bf16=False, remat_from_res=0,
              checkpoint=None, device=device)
    ns.update(kw)
    return argparse.Namespace(**ns)


@pytest.mark.parametrize("device,on", [("cuda", True), ("cuda:0", True),
                                       ("cpu", False)])
@pytest.mark.parametrize("checkpoint", [None, "weights.npz"])
def test_kernel_flags_follow_the_device(built, device, on, checkpoint):
    common.load_stylegan2(_args(device, checkpoint=checkpoint, bf16=True,
                                remat_from_res=256, model="ffhq"))
    (model, kwargs), = built
    assert model == "ffhq"
    assert kwargs["fused_mod_bwd"] is on and kwargs["fir_kernel"] is on
    assert kwargs.get("pack_pairs_max_ch", 0) == 0
    assert kwargs["dtype"] == torch.bfloat16
    assert kwargs["remat_from_res"] == 256
    assert kwargs["device"] == device
    assert kwargs.get("pretrained_path") == checkpoint
