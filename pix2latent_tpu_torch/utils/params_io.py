"""Weights in the flat ``.npz`` layout of the JAX package, for the port.

``pix2latent_tpu/utils/params_io.py:save_params_npz`` writes a nested
parameter tree as ``/``-joined key paths ("generator/block_0/conv_0/kernel").
This module reads that layout and maps it onto the port's modules, whose
parameter names follow the same paths with ``.`` for ``/`` and ``weight``
for ``kernel``:

- Flax conv kernels ``[kh, kw, in, out]`` (HWIO) become ``[out, in, kh, kw]``
  (OIHW);
- Flax Dense kernels ``[in, out]`` become Linear weights ``[out, in]``;
- every other leaf (biases, BigGAN's standing statistics, ``gamma``) keeps
  its shape.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

_SEP = "/"


def _flatten(tree, prefix=""):
    """Nested dict -> {"a/b/c": np.ndarray} (the layout save_params_npz writes)."""
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            assert _SEP not in str(k), (
                f"key {k!r} contains the separator {_SEP!r}")
            out.update(_flatten(v, f"{prefix}{k}{_SEP}"))
        return out
    out[prefix[:-1]] = np.asarray(tree)
    return out


def load_params_npz(path: str) -> Dict[str, np.ndarray]:
    """The flat {key path: array} dict stored in a ``save_params_npz`` file."""
    with np.load(path, allow_pickle=False) as z:
        return {key: np.asarray(z[key]) for key in z.files}


def jax_to_torch_name(path: str) -> str:
    parts = path.split(_SEP)
    if parts[-1] == "kernel":
        parts[-1] = "weight"
    return ".".join(parts)


def torch_to_jax_name(name: str, ndim: int) -> str:
    """Inverse of :func:`jax_to_torch_name`. A 1-D ``weight`` is a JAX
    ``weight`` (BigGAN's unconditional BatchNorm); conv and linear weights
    are ``kernel``s."""
    parts = name.split(".")
    if parts[-1] == "weight" and ndim >= 2:
        parts[-1] = "kernel"
    return _SEP.join(parts)


def jax_to_torch_array(path: str, arr: np.ndarray) -> np.ndarray:
    arr = np.asarray(arr, np.float32)
    if path.split(_SEP)[-1] == "kernel":
        if arr.ndim == 4:
            return arr.transpose(3, 2, 0, 1)
        if arr.ndim == 2:
            return arr.T
    return arr


def jax_shape(name: str, shape: Tuple[int, ...]) -> Tuple[int, ...]:
    """The JAX-layout shape of the port's parameter ``name``."""
    if name.split(".")[-1] == "weight":
        if len(shape) == 4:
            o, i, kh, kw = shape
            return (kh, kw, i, o)
        if len(shape) == 2:
            return (shape[1], shape[0])
    return tuple(shape)


def from_jax_params(flat: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    """A flat JAX parameter dict as a state_dict for the port's module with
    the same tree (see the module docstring for the layout rules)."""
    return {jax_to_torch_name(k): torch.tensor(jax_to_torch_array(k, v))
            for k, v in flat.items()}


def sorted_jax_leaves(module: torch.nn.Module):
    """[(jax path, jax shape, torch name)] of ``module``'s parameters in the
    order JAX flattens the equivalent nested dict (keys sorted per level) —
    the order the JAX package's host-RNG random inits draw in."""
    leaves = [(torch_to_jax_name(n, p.dim()), jax_shape(n, tuple(p.shape)), n)
              for n, p in module.named_parameters()]
    return sorted(leaves, key=lambda t: tuple(t[0].split(_SEP)))
