"""Editing of a saved BigGAN inversion (counterpart of
``pix2latent_tpu/edit/editor.py``): load a ``vars.npy``, keep the sample
with the lowest final loss, and re-render it, move its class embedding
toward another class or walk it along a GANSpace direction in z.
"""

from __future__ import annotations

import numpy as np
import torch

from pix2latent_tpu_torch.edit.ganspace import biggan_components
from pix2latent_tpu_torch.variables import load_variables


class BigGANLatentEditor:
    """Edits of one inverted sample through ``model`` (the port's
    ``BigGAN``; built at its defaults on ``device`` when None). Renders
    are ``[H, W, 3]`` tensors on the model's device."""

    def __init__(self, model=None, device="cuda"):
        if model is None:
            from pix2latent_tpu_torch.models.biggan import BigGAN
            model = BigGAN(device=device)
        self.model = model

    def load_result(self, var_path):
        """Load a payload of either package's ``save_variables`` (plain
        numpy) and select the sample with the lowest final ``loss``."""
        payload = load_variables(var_path)
        if payload.get("loss") is None:
            raise ValueError(f"{var_path}: the saved payload has no 'loss'")
        loss = np.asarray(payload["loss"])
        self._idx = int(np.argmin(loss.reshape(-1)))
        inputs = payload["variables"]["input"]
        self._z = self._row(inputs["z"])
        self._c = self._row(inputs["c"])
        return self

    def _row(self, arr):
        return torch.as_tensor(np.asarray(arr[self._idx], np.float32),
                               device=self.model.device)[None]

    def _render(self, z, c):
        with torch.no_grad():
            return self.model(z, c)[0]

    def edit_class(self, cls_idx, alpha=1.0):
        """``c' = alpha * embed(cls_idx) + (1 - alpha) * c``, rendered."""
        c_edit = self.model.get_class_embedding(cls_idx)
        return self._render(self._z, alpha * c_edit + (1.0 - alpha) * self._c)

    def edit_z(self, component, sigma):
        """z moved by ``sigma`` along the ``component``-th GANSpace
        direction (computed at the defaults on first use), rendered."""
        if not hasattr(self, "components"):
            self.components = biggan_components(self.model, self._c)
        u = self.components[component:component + 1]
        return self._render(self._z + sigma * u, self._c)

    def default(self):
        """The selected sample re-rendered."""
        return self._render(self._z, self._c)
