"""Profiling and debugging switches (counterpart of
``pix2latent_tpu/utils/profiling.py``): a ``torch.profiler`` trace of a
block, written as a Chrome trace (chrome://tracing or ui.perfetto.dev);
the port's spans, which show in the same trace and keep records of their
own; autograd's anomaly mode to find the operation that made a NaN; and a
report of each ``nvcc`` build of ``utils/cuda_build.py``, the port's only
compilations.

Spans (:func:`span`) mark the layers of the hot path: the drivers'
``generation``, ``ask``, ``strategy_tell`` and ``sync``, the execution
core's ``ctx``, ``inner``, ``step``, ``hook``, ``forward``, ``loss``,
``backward``, ``adam``, ``chunk``, ``eval`` and ``tell_loss``, and the
mesh's ``gather``. They record only while a ``torch.profiler`` session is
active (:func:`trace`, or any other profiler): there is no switch of their
own. Off, a span is one boolean check and a shared no-op. On, each span
opens a host range ``p2l::<name>`` in the profiler's trace, keeps a record
with its parent, attributes and host interval on the profiler's clock
(``time.time_ns``), and on a card records a pair of CUDA events on the
current stream; nothing is read back until :func:`spans`.
"""

from __future__ import annotations

import contextlib
import itertools
import logging
import os
import time

import torch
from torch.autograd import profiler as _autograd_profiler

from pix2latent_tpu_torch.utils import cuda_build

_BUILD_LOG = logging.getLogger(cuda_build.__name__)
_HANDLER_NAME = "log_compiles"


@contextlib.contextmanager
def trace(log_dir: str):
    """Trace everything inside the block, host and card, to
    ``log_dir/trace.json``; the port's spans record meanwhile
    (:func:`spans`):

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


_OFF = contextlib.nullcontext()
_RECORDS = []
_OPEN = []            # the open spans, innermost last (the host thread's)
_IDS = itertools.count(1)


class _Span:
    """One recorded span; see :func:`span`."""

    __slots__ = ("id", "parent", "name", "attrs", "start_ns", "end_ns",
                 "device", "events", "_range")

    def __init__(self, name, attrs):
        self.name, self.attrs = name, attrs
        self.id = next(_IDS)
        self.parent = _OPEN[-1].id if _OPEN else None
        self.end_ns = None
        self.device = None
        self.events = []

    def __enter__(self):
        # the clock read before the profiler's own stamp and after its
        # end's: its first range of a process returns late
        self.start_ns = time.time_ns()
        # an operator's range, not ``record_function``'s user annotation:
        # the profiler mirrors each user annotation onto the device's
        # timeline, where a trace's reader would count it as device work
        self._range = torch._C._profiler._RecordFunctionFast(
            "p2l::" + self.name)
        self._range.__enter__()
        _OPEN.append(self)
        _RECORDS.append(self)
        if torch.cuda.is_initialized():
            self.device = torch.cuda.current_device()
            self._record()
        return self

    def _record(self):
        event = torch.cuda.Event(enable_timing=True)
        event.record()
        self.events.append(event)

    def __exit__(self, *exc):
        if self.device is not None:
            self._record()
        _OPEN.remove(self)
        self._range.__exit__(*exc)
        self._range = None
        self.end_ns = time.time_ns()
        return False


def span(name: str, **attrs):
    """A named span of the port's hot path:

        with profiling.span("inner", steps=30, rows=18):
            ...

    Recorded only while a ``torch.profiler`` session is active; otherwise
    a shared no-op context manager."""
    # PyTorch's own flag, set while any profiler session runs
    if not _autograd_profiler._is_profiler_enabled:
        return _OFF
    return _Span(name, attrs)


def spans() -> list:
    """The finished spans recorded so far, in the order they opened:
    ``{"id", "parent", "name", "attrs", "start_ns", "end_ns", "host_ms",
    "device_ms"}``, with ``parent`` the id of the span open around it (or
    None) and ``device_ms`` the time between its CUDA events (None without
    a card). Waits once for each card the spans ran on."""
    done = [r for r in _RECORDS if r.end_ns is not None]
    for device in {r.device for r in done if r.device is not None}:
        torch.cuda.synchronize(device)
    return [{"id": r.id, "parent": r.parent, "name": r.name,
             "attrs": dict(r.attrs), "start_ns": r.start_ns,
             "end_ns": r.end_ns, "host_ms": (r.end_ns - r.start_ns) * 1e-6,
             "device_ms": (r.events[0].elapsed_time(r.events[1])
                           if r.device is not None else None)}
            for r in done]


def clear_spans():
    """Forget the recorded spans (open ones keep running, unrecorded)."""
    _RECORDS.clear()


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
