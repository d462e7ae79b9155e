"""Profiling and debugging switches (counterpart of
``pix2latent_tpu/utils/profiling.py``): a ``torch.profiler`` trace of a
block, written as a Chrome trace (chrome://tracing or ui.perfetto.dev);
named annotations that show in the same trace; autograd's anomaly mode to
find the operation that made a NaN; and a report of each ``nvcc`` build of
``utils/cuda_build.py``, the port's only compilations.
"""

from __future__ import annotations

import contextlib
import logging
import os

import torch

from pix2latent_tpu_torch.utils import cuda_build

_BUILD_LOG = logging.getLogger(cuda_build.__name__)
_HANDLER_NAME = "log_compiles"


@contextlib.contextmanager
def trace(log_dir: str):
    """Trace everything inside the block, host and card, to
    ``log_dir/trace.json``:

        with profiling.trace("traces/run"):
            opt.optimize(...)
    """
    os.makedirs(log_dir, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    path = os.path.join(log_dir, "trace.json")
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(path)
    print(f"profiler trace written to {path} "
          "(view with chrome://tracing or ui.perfetto.dev)")


def annotate(name: str):
    """A named range in the profiler's timeline:

        with profiling.annotate("cma-generation"):
            ...
    """
    return torch.profiler.record_function(name)


def debug_nans(enable: bool = True):
    """Autograd's anomaly mode: a backward that makes a NaN raises and
    names the forward operation behind it."""
    torch.autograd.set_detect_anomaly(bool(enable))


def log_compiles(enable: bool = True):
    """Print each ``nvcc`` build of the package's CUDA sources (to standard
    error, through ``utils/cuda_build.py``'s logger)."""
    for handler in [h for h in _BUILD_LOG.handlers
                    if h.get_name() == _HANDLER_NAME]:
        _BUILD_LOG.removeHandler(handler)
    if enable:
        handler = logging.StreamHandler()
        handler.set_name(_HANDLER_NAME)
        _BUILD_LOG.addHandler(handler)
        _BUILD_LOG.setLevel(logging.INFO)
    else:
        _BUILD_LOG.setLevel(logging.NOTSET)
