"""Build the package's CUDA sources with ``nvcc`` and load them with ctypes.

Each source under ``pix2latent_tpu_torch/csrc/`` becomes one shared library
with a plain C interface, compiled for Hopper (``sm_90a``) at first use and
cached under ``pix2latent_tpu_torch/_build/`` by a hash of the source and the
flags. Nothing here runs at import time; the CPU paths never call it. Each
build is logged at INFO level on this module's logger
(``utils/profiling.log_compiles`` prints them).

Each ``ops/`` module that launches a kernel declares the C entries of its
source once, as ``SIGNATURES = {entry: (restype, argtypes)}`` beside its
``SOURCE``; :func:`load` applies them when it first loads the library, and
``tests/test_torch_kernel_bindings.py`` holds them against the source's
``extern "C"`` block. :func:`ptr` and :func:`stream` give a tensor's
address and its card's current stream as the entries take them.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Dict, Iterable, Sequence, Tuple

import torch

PACKAGE_DIR = Path(__file__).resolve().parents[1]
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_loaded: Dict[str, ctypes.CDLL] = {}
_log = logging.getLogger(__name__)


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def library_path(source: str) -> Path:
    """Cache path of the library built from ``csrc/<source>``."""
    src = CSRC_DIR / source
    h = hashlib.sha256(src.read_bytes())
    for header in sorted(CSRC_DIR.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{src.stem}-{h.hexdigest()[:16]}.so"


def _start(source: str):
    out = library_path(source)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=BUILD_DIR, suffix=".so.tmp")
    os.close(fd)
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp, str(CSRC_DIR / source)]
    _log.info("nvcc: building %s -> %s", source, out.name)
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out, time.perf_counter()


def _finish(source: str, started) -> str:
    proc, tmp, out, t0 = started
    log, _ = proc.communicate()
    try:
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {source} "
                               f"(exit {proc.returncode}):\n{log}")
        out.with_suffix(".log").write_text(log)
        os.replace(tmp, out)
        _log.info("nvcc: built %s in %.1f s", source,
                  time.perf_counter() - t0)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return log


def build(sources: Iterable[str]) -> Dict[str, dict]:
    """Compile every source not yet cached, one ``nvcc`` each, all at once.

    Returns ``{source: {"seconds": s, "cached": bool, "path": str}}``."""
    sources = list(sources)
    t0 = time.perf_counter()
    started = {s: _start(s) for s in sources}
    report = {}
    for s, st in started.items():
        if st is not None:
            _finish(s, st)
        report[s] = {"seconds": time.perf_counter() - t0,
                     "cached": st is None, "path": str(library_path(s))}
    return report


def load(source: str,
         signatures: Dict[str, Tuple[type, Sequence[type]]]) -> ctypes.CDLL:
    """The ctypes library for ``csrc/<source>``, built on first use, with
    ``signatures`` (``{entry: (restype, argtypes)}``) set on its entries."""
    lib = _loaded.get(source)
    if lib is None:
        build([source])
        lib = ctypes.CDLL(str(library_path(source)))
        for entry, (restype, argtypes) in signatures.items():
            fn = getattr(lib, entry)
            fn.restype, fn.argtypes = restype, argtypes
        _loaded[source] = lib
    return lib


def ptr(t: torch.Tensor) -> ctypes.c_void_p:
    """``t``'s device address, for a ``void*`` parameter."""
    return ctypes.c_void_p(t.data_ptr())


def stream(t: torch.Tensor) -> ctypes.c_void_p:
    """The current stream of ``t``'s card, the entries' last parameter."""
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def all_sources():
    return sorted(p.name for p in CSRC_DIR.glob("*.cu"))
