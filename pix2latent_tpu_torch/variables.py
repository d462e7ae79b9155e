"""Variable registry and population state (counterpart of
``pix2latent_tpu/variables.py``).

The materialized state is a plain nested dict of tensors on the manager's
device:

    Variables = {var_type: {var_name: f32 tensor [num_samples, *shape]}}

The optimizer is built separately (:meth:`VariableManager.make_optimizer`):
one ``torch.optim.Adam`` whose parameter groups carry each variable's
learning rate, so BasinCMA can start fresh Adam state every generation.
"""

from __future__ import annotations

import pprint
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from pix2latent_tpu_torch import distribution as dist
from pix2latent_tpu_torch.utils.device import resolve_device

Variables = Dict[str, Dict[str, torch.Tensor]]

# optimizer name -> (torch class, constructor keywords); the values match
# the reference's optax transforms (optax.adamw's default weight decay 1e-4)
_OPTIMIZERS = {
    "adam": (torch.optim.Adam, {"betas": (0.9, 0.999), "eps": 1e-8}),
    "adamw": (torch.optim.AdamW, {"betas": (0.9, 0.999), "eps": 1e-8,
                                  "weight_decay": 1e-4}),
    "sgd": (torch.optim.SGD, {}),
}


def num_samples(variables: Variables) -> int:
    """Population size of a Variables dict."""
    for var_dict in variables.values():
        for arr in var_dict.values():
            return int(arr.shape[0])
    raise ValueError("empty Variables")


def save_variables(save_path, variables, extras: Optional[dict] = None):
    """Write a Variables dict (plus optional extras) as a pickled ``.npy``
    payload, at exactly ``save_path`` (``np.save`` given a path would append
    ``.npy`` to a foreign extension)."""
    def to_np(tree):
        if isinstance(tree, dict):
            return {k: to_np(v) for k, v in tree.items()}
        if isinstance(tree, torch.Tensor):
            return tree.detach().cpu().numpy()
        return np.asarray(tree)

    payload = {"variables": to_np(variables)}
    if extras:
        payload.update(to_np(extras))
    with open(save_path, "wb") as f:
        np.save(f, payload, allow_pickle=True)


def load_variables(path):
    """Load a payload saved by :func:`save_variables` (numpy arrays).
    Unpickles: load only files this program wrote."""
    return np.load(path, allow_pickle=True).item()


class VariableOptimizer:
    """The per-variable optimizers of one population: one torch optimizer
    per optimizer kind, with a parameter group (and learning rate) per
    variable. Frozen variables are in no group."""

    def __init__(self, optimizers):
        self.optimizers = optimizers

    def zero_grad(self):
        for opt in self.optimizers:
            opt.zero_grad(set_to_none=True)

    def step(self):
        for opt in self.optimizers:
            opt.step()


class VariableManager:
    """Registry of named optimization variables.

    A variable has a shape, a ``var_type`` (``input`` feeds the model,
    ``output`` feeds the loss), a gradient flag, an init distribution or a
    default, an optimizer and learning rate, an optional per-step hook and a
    gradient-free flag for the CMA outer loop.
    """

    def __init__(self, seed: int = 0, device="cuda"):
        self.device = resolve_device(device)
        self.variable_info: Dict[str, Dict[str, Any]] = {}
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(seed)

    def __str__(self):
        return "<VariableManager>\n{}".format(pprint.pformat(self.variable_info))

    # ------------------------------------------------------------------ #
    # registry                                                           #
    # ------------------------------------------------------------------ #

    def _as_default(self, value):
        if isinstance(value, torch.Tensor):
            return value.detach().to(device=self.device, dtype=torch.float32)
        return torch.tensor(np.asarray(value, np.float32), device=self.device)

    def register(self, variable_name: str, shape, var_type: str = "input",
                 requires_grad: bool = True, default=None, distribution=None,
                 optimizer="adam", learning_rate: float = 0.05,
                 hook_fn: Optional[Callable] = None, grad_free=False):
        """Register a variable spec; see the JAX package's ``register`` for
        the arguments. ``hook_fn`` is ``(generator, x, step) -> x`` and
        ``distribution`` is ``(generator, num_samples, shape) -> tensor``.
        ``optimizer`` is 'adam', 'adamw', 'sgd' or a callable
        ``(params, lr) -> torch.optim.Optimizer``. Returns False if the name
        is taken."""
        if variable_name in self.variable_info:
            print(f"variable `{variable_name}` already exists.")
            return False

        shape = tuple(shape)
        if default is not None:
            default = self._as_default(default)
            if tuple(default.shape) != shape:
                raise ValueError(f"default and shape must match but got "
                                 f"{tuple(default.shape)} vs {shape}")

        if distribution is None:
            distribution = dist.TruncatedNormalModulo(sigma=1.0, trunc=2.0)

        self.variable_info[variable_name] = {
            "shape": shape,
            "var_type": var_type,
            "requires_grad": bool(requires_grad),
            "default": default,
            "distribution": distribution,
            "optimizer": optimizer,
            "learning_rate": float(learning_rate),
            "hook_fn": hook_fn,
            "grad_free": grad_free,
        }
        return True

    def unregister(self, *variable_names):
        for v in variable_names:
            if v in self.variable_info:
                del self.variable_info[v]
            else:
                print(f"no variable named {v}")

    def edit_variable(self, variable_name: str, replace_dict: dict):
        """Edit attributes of a registered variable; False on an unknown
        variable or attribute."""
        if variable_name not in self.variable_info:
            print(f"variable `{variable_name}` does not exist")
            return False
        for k, v in replace_dict.items():
            if k not in self.variable_info[variable_name]:
                print(f"variable `{variable_name}` has no attribute {k}")
                return False
            if k == "default" and v is not None:
                v = self._as_default(v)
            self.variable_info[variable_name][k] = v
        return True

    # ------------------------------------------------------------------ #
    # materialization                                                    #
    # ------------------------------------------------------------------ #

    def initialize(self, num_samples: int,
                   generator: Optional[torch.Generator] = None,
                   defaults: Optional[Dict[str, torch.Tensor]] = None
                   ) -> Variables:
        """A fresh population. Variables are drawn in sorted-name order
        from ``generator`` (default: the manager's own); ``defaults``
        overrides the registered defaults by name."""
        if generator is None:
            generator = self.generator
        defaults = defaults or {}
        variables: Variables = {}
        for name in sorted(self.variable_info):
            spec = self.variable_info[name]
            default = defaults.get(name, spec["default"])
            if default is not None:
                data = self._as_default(default)[None].expand(
                    num_samples, *spec["shape"]).clone()
            else:
                data = spec["distribution"](generator, num_samples,
                                            spec["shape"])
                data = data.to(device=self.device, dtype=torch.float32)
            variables.setdefault(spec["var_type"], {})[name] = data
        return variables

    def defaults(self, var_type: Optional[str] = None) -> Dict[str, torch.Tensor]:
        """{name: default} for every registered variable with a default
        (optionally restricted to one ``var_type``)."""
        return {
            name: spec["default"]
            for name, spec in self.variable_info.items()
            if spec["default"] is not None
            and (var_type is None or spec["var_type"] == var_type)}

    # ------------------------------------------------------------------ #
    # gradient plumbing                                                  #
    # ------------------------------------------------------------------ #

    def make_optimizer(self, variables: Variables) -> VariableOptimizer:
        """Per-variable optimizers over the trainable tensors of
        ``variables``, which must be leaf tensors with ``requires_grad``
        (see ``ExecutionCore.init_opt_state``). Frozen variables get none."""
        groups: Dict[str, list] = {}
        custom = []
        for vt, var_dict in variables.items():
            for name, tensor in var_dict.items():
                spec = self.variable_info[name]
                if not spec["requires_grad"]:
                    continue
                opt, lr = spec["optimizer"], spec["learning_rate"]
                if callable(opt) and not isinstance(opt, str):
                    custom.append(opt([tensor], lr))
                    continue
                kind = str(opt).lower()
                if kind not in _OPTIMIZERS:
                    raise ValueError(f"unknown optimizer spec: {opt!r}")
                groups.setdefault(kind, []).append(
                    {"params": [tensor], "lr": lr})
        optimizers = [_OPTIMIZERS[kind][0](g, **_OPTIMIZERS[kind][1])
                      for kind, g in sorted(groups.items())]
        return VariableOptimizer(optimizers + custom)

    def apply_hooks(self, generator, variables: Variables, step=0) -> Variables:
        """A new Variables dict with every registered hook applied (sorted
        name order); the tensors of ``variables`` are not modified."""
        out = {vt: dict(d) for vt, d in variables.items()}
        for name, spec in sorted(self.variable_info.items()):
            if spec["hook_fn"] is None:
                continue
            vt = spec["var_type"]
            if vt in out and name in out[vt]:
                out[vt][name] = spec["hook_fn"](generator, out[vt][name], step)
        return out

    # ------------------------------------------------------------------ #
    # grad-free bookkeeping                                              #
    # ------------------------------------------------------------------ #

    def grad_free_variables(self):
        """[(var_type, name, spec)] for variables searched gradient-free."""
        return [(spec["var_type"], name, spec)
                for name, spec in sorted(self.variable_info.items())
                if spec["grad_free"] is not False]
