"""Weights in the flat ``.npz`` layout of the JAX package, for the port.

``pix2latent_tpu/utils/params_io.py:save_params_npz`` writes a nested
parameter tree as ``/``-joined key paths ("generator/block_0/conv_0/kernel").
This module writes that layout (:func:`save_params_npz`), reads it and
maps it onto the port's modules, whose
parameter names follow the same paths with ``.`` for ``/``. How names and
arrays change depends on the model's Flax conventions, so each convention is
a :class:`Layout`:

- :data:`FLAX_KERNELS` (BigGAN, LPIPS, the toy model: ``nn.Conv`` /
  ``nn.Dense`` leaves called ``kernel``): ``kernel`` becomes ``weight``;
  conv kernels ``[kh, kw, in, out]`` (HWIO) become ``[out, in, kh, kw]``
  (OIHW), Dense kernels ``[in, out]`` become Linear weights ``[out, in]``;
  every other leaf (biases, BigGAN's standing statistics, ``gamma``) keeps
  its shape.
- :data:`STYLEGAN2` (hand-written ``self.param`` leaves, every weight called
  ``weight``): names are unchanged; 2-D weights ``[in, out]`` become
  ``[out, in]``, 4-D ``weight`` leaves (modulated convs, HWIO) become OIHW,
  and the other 4-D leaves (the constant ``input`` and the ``noise_i``
  buffers, NHWC) become NCHW; biases and 0-d noise gains keep their shape.
"""

from __future__ import annotations

import os
import tempfile
from typing import Callable, Dict, NamedTuple, Tuple

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
    if isinstance(tree, torch.Tensor):
        tree = tree.detach().cpu().numpy()
    out[prefix[:-1]] = np.asarray(tree)
    return out


def save_params_npz(path: str, params) -> Dict[str, Tuple[int, ...]]:
    """Atomically write a parameter tree (nested dict, or flat with ``/``
    paths) of numpy arrays to ``path`` in the layout of the JAX package's
    ``save_params_npz``, which either package's ``load_params_npz`` reads.
    Returns ``{key path: shape}``, the report the convert CLI prints."""
    if any(isinstance(v, dict) for v in params.values()):
        flat = _flatten(params)
    else:
        flat = {k: np.asarray(v.detach().cpu().numpy()
                              if isinstance(v, torch.Tensor) else v)
                for k, v in params.items()}
    d = os.path.dirname(os.path.abspath(path)) or "."
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp")
    os.close(fd)
    try:
        with open(tmp, "wb") as f:
            np.savez(f, **flat)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return {k: v.shape for k, v in flat.items()}


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


def _sg2_torch_name(path: str) -> str:
    return path.replace(_SEP, ".")


def _sg2_jax_name(name: str, ndim: int) -> str:
    del ndim
    return name.replace(".", _SEP)


def _sg2_to_torch_array(path: str, arr: np.ndarray) -> np.ndarray:
    arr = np.asarray(arr, np.float32)
    if arr.ndim == 2:
        return arr.T
    if arr.ndim == 4:
        if path.split(_SEP)[-1] == "weight":
            return arr.transpose(3, 2, 0, 1)          # HWIO -> OIHW
        return arr.transpose(0, 3, 1, 2)              # NHWC -> NCHW
    return arr


def _sg2_jax_shape(name: str, shape: Tuple[int, ...]) -> Tuple[int, ...]:
    if len(shape) == 2:
        return (shape[1], shape[0])
    if len(shape) == 4:
        a, b, c, d = shape
        if name.split(".")[-1] == "weight":
            return (c, d, b, a)                       # OIHW -> HWIO
        return (a, c, d, b)                           # NCHW -> NHWC
    return tuple(shape)


class Layout(NamedTuple):
    """How one model family's JAX leaves map onto the port's parameters."""
    to_torch_name: Callable[[str], str]
    to_jax_name: Callable[[str, int], str]
    to_torch_array: Callable[[str, np.ndarray], np.ndarray]
    jax_shape: Callable[[str, Tuple[int, ...]], Tuple[int, ...]]


FLAX_KERNELS = Layout(jax_to_torch_name, torch_to_jax_name,
                      jax_to_torch_array, jax_shape)
STYLEGAN2 = Layout(_sg2_torch_name, _sg2_jax_name, _sg2_to_torch_array,
                   _sg2_jax_shape)


def from_jax_params(flat: Dict[str, np.ndarray],
                    layout: Layout = FLAX_KERNELS) -> Dict[str, torch.Tensor]:
    """A flat JAX parameter dict as a state_dict for the port's module with
    the same tree (see the module docstring for the layout rules)."""
    return {layout.to_torch_name(k): torch.tensor(layout.to_torch_array(k, v))
            for k, v in flat.items()}


def sorted_jax_leaves(module: torch.nn.Module, layout: Layout = FLAX_KERNELS):
    """[(jax path, jax shape, torch name)] of ``module``'s parameters in the
    order JAX flattens the equivalent nested dict (keys sorted per level) —
    the order the JAX package's host-RNG random inits draw in."""
    leaves = [(layout.to_jax_name(n, p.dim()),
               layout.jax_shape(n, tuple(p.shape)), n)
              for n, p in module.named_parameters()]
    return sorted(leaves, key=lambda t: tuple(t[0].split(_SEP)))
