"""The Poisson (gradient-domain) compositing solver, in C++ behind ctypes
(a copy of the JAX package's ``native/poisson.cpp``, which imports nothing).

``poisson.cpp`` is compiled with ``g++`` at first use into
``pix2latent_tpu_torch/_build/`` (git-ignored), named by a hash of the source
and the flags, so a changed source is rebuilt and nothing is written beside
the source. The flags are the JAX package's (``-O3 -march=native``), so both
packages' solvers compute the same bits on one host.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
from pathlib import Path

import numpy as np

SOURCE = Path(__file__).resolve().parent / "poisson.cpp"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
CXX_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC")

_lib = None


def library_path() -> Path:
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join(CXX_FLAGS).encode())
    return BUILD_DIR / f"poisson-{h.hexdigest()[:16]}.so"


def build() -> Path:
    """The solver's shared library, compiled unless already there."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=BUILD_DIR, suffix=".so.tmp")
    os.close(fd)
    try:
        proc = subprocess.run(["g++", *CXX_FLAGS, "-o", tmp, str(SOURCE)],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed on {SOURCE}:\n{proc.stderr}")
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return out


def _load():
    global _lib
    if _lib is not None:
        return _lib
    lib = ctypes.CDLL(str(build()))
    lib.seamless_clone.restype = ctypes.c_int
    lib.seamless_clone.argtypes = [
        ctypes.POINTER(ctypes.c_uint8),  # src
        ctypes.POINTER(ctypes.c_uint8),  # dst
        ctypes.POINTER(ctypes.c_uint8),  # mask
        ctypes.c_int, ctypes.c_int,      # h, w
        ctypes.c_int, ctypes.c_int,      # center_x, center_y
        ctypes.c_int, ctypes.c_double,   # iters, omega
        ctypes.POINTER(ctypes.c_uint8),  # out
    ]
    _lib = lib
    return lib


def seamless_clone(src, dst, mask, center_xy, iters=500, omega=1.9):
    """Gradient-domain composite of ``src``'s masked region into ``dst``
    (``cv2.seamlessClone`` with ``NORMAL_CLONE``).

    Args:
        src, dst: uint8 RGB ``[H, W, 3]``.
        mask: uint8 ``[H, W]``; nonzero marks the region (``src``'s frame).
        center_xy: ``(x, y)`` in ``dst`` where the mask's centroid lands.
        iters: most SOR sweeps per channel.
        omega: SOR relaxation factor, in (1, 2).
    """
    lib = _load()
    src = np.ascontiguousarray(src, np.uint8)
    dst = np.ascontiguousarray(dst, np.uint8)
    mask = np.ascontiguousarray(mask, np.uint8)
    h, w = dst.shape[:2]
    if not src.shape == dst.shape == (h, w, 3):
        raise ValueError(f"src {src.shape} and dst {dst.shape} must both be "
                         "[H, W, 3]")
    if mask.shape != (h, w):
        raise ValueError(f"mask {mask.shape} must be [{h}, {w}]")
    out = np.empty_like(dst)

    def p(a):
        return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))

    rc = lib.seamless_clone(p(src), p(dst), p(mask), h, w,
                            int(center_xy[0]), int(center_xy[1]),
                            int(iters), float(omega), p(out))
    if rc != 0:
        raise RuntimeError(f"seamless_clone failed with code {rc}")
    return out
