"""The run's surroundings: its cache directories, the cards it needs, the
modules it must not load, and the card's description."""

from __future__ import annotations

import os
import subprocess
import sys

from p2l_bench.harness.spec import ROOT

# top-level module names that must not be loaded: JAX, its libraries and
# the JAX package the port was made from (compared whole, since the port's
# own name begins with the JAX package's)
FORBIDDEN = ("jax", "jaxlib", "flax", "pix2latent_tpu")


def prepare_caches():
    """Fixed cache directories inside the checkout, so that every run of a
    cell after the first finds what the first built. The port builds its
    kernels into ``pix2latent_tpu_torch/_build/`` in the checkout itself;
    Triton's cache is set here in case a library compiles with it. The
    libraries that could load JAX by themselves are told not to."""
    cache = ROOT / "p2l_bench" / "_cache"
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is forbidden."""
    return sorted({name for name in sys.modules
                   if name.split(".", 1)[0] in FORBIDDEN})


def cards_missing(chips: int):
    """Why this machine cannot run a cell of ``chips`` cards, or None."""
    import torch
    if not torch.cuda.is_available():
        return "torch.cuda.is_available() is false"
    if torch.cuda.device_count() < chips:
        return (f"the cell needs {chips} cards, torch.cuda.device_count() "
                f"is {torch.cuda.device_count()}")
    return None


def card(index: int = 0) -> dict:
    """The card's name and, from nvidia-smi, its power limit."""
    import torch
    out = {"name": torch.cuda.get_device_name(index)}
    try:
        smi = subprocess.run(
            ["nvidia-smi", f"--id={index}",
             "--query-gpu=power.limit,clocks.max.sm",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
        out["nvidia_smi"] = smi.stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        out["nvidia_smi"] = f"unavailable: {e}"
    return out
