"""Quality metrics of an inversion's outputs (counterpart of
``pix2latent_tpu/utils/benchmark.py``): masked L1 and L2 and the spatial
LPIPS distances (alex, squeeze, vgg) against the target, each metric's net
built at its first use. An optimizer reports them through
``register_benchmark`` in ``log_result``.
"""

from __future__ import annotations

import pix2latent_tpu_torch.loss_functions as LF
from pix2latent_tpu_torch.utils.device import resolve_device
from pix2latent_tpu_torch.utils.misc import to_numpy


class Benchmark:
    VALID = ("l1", "l2", "alex", "squeeze", "vgg")

    def __init__(self, metrics=("l1", "l2", "alex"), lpips_params=None,
                 device="cuda"):
        for m in metrics:
            if m not in self.VALID:
                raise ValueError(f"unknown metric {m}; valid: {self.VALID}")
        self.metrics = tuple(metrics)
        self.device = resolve_device(device)
        self._lpips_params = lpips_params or {}
        self._fns = {}

    def _get(self, name):
        if name in self._fns:
            return self._fns[name]
        if name == "l1":
            fn = LF.masked_l1_loss
        elif name == "l2":
            fn = LF.masked_l2_loss
        else:
            from pix2latent_tpu_torch.losses.lpips import LPIPS
            lp = LPIPS(net=name, spatial=True,
                       params=self._lpips_params.get(name),
                       device=self.device)

            def fn(out, target, mask, _lp=lp):
                m = _lp(out, target.expand(out.shape))        # [n, H, W, 1]
                w = mask.mean(dim=-1, keepdim=True)
                return (m * w).sum(dim=(1, 2, 3)) / w.sum(dim=(1, 2, 3))
        self._fns[name] = fn
        return fn

    def evaluate(self, out, target, mask):
        """Per-sample metrics as numpy arrays ``{name: [n]}``: ``out``
        ``[n, H, W, 3]``, ``target`` and ``mask`` ``[1, H, W, 3]``, on the
        benchmark's device."""
        return {name: to_numpy(self._get(name)(out, target, mask))
                for name in self.metrics}
