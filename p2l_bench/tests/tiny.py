"""The cells at a size the CPU runs in seconds: BigGAN-deep's 128 px layout
at channel width 4, StyleGAN2 at 32 px with 16 and 8 channels (the port's
channel map and model size patched to match), a few generations of a few
steps. Only the tests use these."""

from __future__ import annotations

from p2l_bench.harness import spec

BIGGAN_128 = [[False, 16, 16], [True, 16, 16], [False, 16, 16],
              [True, 16, 8], [False, 8, 8], [True, 8, 4], [False, 4, 4],
              [True, 4, 2], [False, 2, 2], [True, 2, 1]]
SG2_CHANNELS = {"4": 16, "8": 16, "16": 8, "32": 8}
# limits at this size where not 1e-4, over the largest of 20 seeds'
# readings of both judged generations on the CPU (cars: grad_gap 2.3e-4,
# delta_gap 7.2e-5, noise_gap 8.1e-3; every other number under 6e-6); the
# faults read 0.01 and more
LIMITS = {"noise_gap": 0.02, "grad_gap": 1e-3, "delta_gap": 1e-3}


def cell(name, monkeypatch=None):
    """``(workload, config)`` of cell ``name`` at the tiny size; a
    StyleGAN2 cell needs ``monkeypatch`` for the port's channel map."""
    wl = spec.workload(name)
    cfg = spec.config(wl["config"])
    if cfg["problem"] == "biggan":
        cfg.update(model_version="biggan-deep-128", output_dim=128,
                   channel_width=4, layers=BIGGAN_128)
    else:
        import pix2latent_tpu_torch.models.stylegan2 as sg2
        cfg.update(im_res=32, channels=SG2_CHANNELS)
        monkeypatch.setattr(sg2, "channels_for",
                            lambda res, cm=2: SG2_CHANNELS[str(res)])
        monkeypatch.setattr(sg2.StyleGAN2, "MODELS", {"cars": 32})
    if wl["kind"] == "basincma":
        wl["optimize"] = {"meta_steps": 3, "grad_steps": 4,
                          "last_grad_steps": 2}
    else:
        wl["optimize"] = {"meta_steps": 4, "grad_steps": 2}
    wl["trace_generations"] = 1
    return wl, cfg
