"""The traced run's spans, module timings and device trace.

Spans come from wrappers on objects the harness built, never from an edit
to the program: ``opt.core.grad_steps`` (the inner run of a generation),
``opt.core.eval`` (an eval-only generation's evaluation) and
``mesh.gather`` (the exchange between ranks), each timed on the device by
CUDA events recorded on the current stream around the call. Module timings
come from PyTorch's public module hooks (forward pre/post, full backward
pre/post) on the model's submodules of the classes the cell's readers ask
for, again by CUDA events; a forward under grad is paired with the next
backward of the same module. The device trace is ``torch.profiler``'s over
the first generations of the window: busy time is the union of the device
activities' intervals, idle gaps are attributed to the host operation
running at their middle.
"""

from __future__ import annotations

import time
from collections import defaultdict

import numpy as np
import torch


class HostEvent:
    """A host-clock stand-in for ``torch.cuda.Event`` where there is no
    card (the CPU rehearsal): it times the host, not a device."""

    def record(self):
        self.t = time.perf_counter()

    def elapsed_time(self, other):
        return (other.t - self.t) * 1e3


def event(cuda: bool):
    ev = torch.cuda.Event(enable_timing=True) if cuda else HostEvent()
    ev.record()
    return ev


def synchronize(cuda: bool):
    if cuda:
        torch.cuda.synchronize()


class Spans:
    """CUDA-event spans of wrapped calls, each tagged with the window's
    generation it fell in (``generation``, set by the window)."""

    def __init__(self, cuda: bool):
        self.cuda = cuda
        self.generation = 0
        self.records = defaultdict(list)   # name -> [(gen, start, end, info)]
        self._wrapped = []

    def wrap(self, obj, attr, name, info=None):
        fn = getattr(obj, attr)

        def timed(*args, **kwargs):
            start = event(self.cuda)
            out = fn(*args, **kwargs)
            end = event(self.cuda)
            self.records[name].append(
                (self.generation, start, end,
                 info(args, kwargs, out) if info else None))
            return out
        setattr(obj, attr, timed)
        self._wrapped.append((obj, attr))

    def remove(self):
        for obj, attr in self._wrapped:
            delattr(obj, attr)
        self._wrapped = []

    def read(self, generations: int) -> dict:
        """``{name: [{"gen", "ms", "info"}]}`` of the spans in the counted
        generations (1-based)."""
        synchronize(self.cuda)
        return {name: [{"gen": g, "ms": s.elapsed_time(e), "info": info}
                       for g, s, e, info in recs if 1 <= g <= generations]
                for name, recs in self.records.items()}


def _tensor_shapes(xs):
    return [list(x.shape) for x in xs if isinstance(x, torch.Tensor)]


class ModuleTimer:
    """Device time of every forward and backward of the model's modules
    whose class name is in ``classes``."""

    def __init__(self, model, classes, cuda: bool):
        self.cuda = cuda
        self.calls = []
        self._pending = defaultdict(list)
        self._handles = []
        for _, m in model.named_modules():
            if type(m).__name__ in classes:
                self._hook(m)

    def _hook(self, m):
        cls = type(m).__name__
        params = {n: list(p.shape) for n, p in m.named_parameters(
            recurse=False)}

        starts = {}

        def pre(module, args):
            starts[id(module)] = event(self.cuda)

        def post(module, args, out):
            ev = event(self.cuda)
            rec = {"class": cls, "in": _tensor_shapes(args),
                   "out": list(out.shape), "params": params,
                   "fwd": (starts.pop(id(module)), ev), "bwd": None}
            self.calls.append(rec)
            if torch.is_grad_enabled() and out.requires_grad:
                self._pending[id(module)].append(rec)

        def bwd_pre(module, grad_out):
            ev = event(self.cuda)
            if self._pending[id(module)]:
                self._pending[id(module)][-1]["bwd_start"] = ev

        def bwd_post(module, grad_in, grad_out):
            ev = event(self.cuda)
            if self._pending[id(module)]:
                rec = self._pending[id(module)].pop()
                if "bwd_start" in rec:
                    rec["bwd"] = (rec.pop("bwd_start"), ev)

        self._handles += [m.register_forward_pre_hook(pre),
                          m.register_forward_hook(post),
                          m.register_full_backward_pre_hook(bwd_pre),
                          m.register_full_backward_hook(bwd_post)]

    def remove(self):
        for h in self._handles:
            h.remove()
        self._handles = []

    def read(self) -> dict:
        """``{class: [{"in", "out", "params", "fwd_ms", "bwd_ms"}]}``."""
        synchronize(self.cuda)
        out = defaultdict(list)
        for rec in self.calls:
            fwd = rec["fwd"][0].elapsed_time(rec["fwd"][1])
            bwd = (rec["bwd"][0].elapsed_time(rec["bwd"][1])
                   if rec["bwd"] is not None else None)
            out[rec["class"]].append({"in": rec["in"], "out": rec["out"],
                                      "params": rec["params"],
                                      "fwd_ms": fwd, "bwd_ms": bwd})
        return dict(out)


class DeviceTrace:
    """``torch.profiler`` over part of the window."""

    def __init__(self, cuda: bool):
        from torch.profiler import ProfilerActivity, profile
        self.cuda = cuda
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda
                                         else [])
        self.prof = profile(activities=acts)
        self.t0 = self.t1 = None

    def start(self):
        synchronize(self.cuda)
        self.prof.start()
        self.t0 = time.time_ns()

    def stop(self):
        synchronize(self.cuda)
        self.t1 = time.time_ns()
        self.prof.stop()

    def read(self) -> dict:
        """``busy_s``, ``window_s`` and the breakdown: the device
        operations that took most time and the idle gaps by the host
        operation running at their middle (at most 10 each)."""
        from torch.autograd import DeviceType
        events = self.prof.profiler.kineto_results.events()
        dev, host = [], []
        for e in events:
            start, dur = e.start_ns(), e.duration_ns()
            if dur <= 0:
                continue
            if e.device_type() == DeviceType.CUDA:
                dev.append((start, start + dur, e.name()))
            elif e.device_type() == DeviceType.CPU:
                host.append((start, start + dur, e.name()))
        return summarize(dev, host, self.t0, self.t1)


def summarize(dev, host, t0, t1, top=10) -> dict:
    """Busy time, the device operations by total time and the idle gaps
    by host operation, over device intervals ``dev`` and host intervals
    ``host`` (``(start_ns, end_ns, name)``) inside ``[t0, t1]``."""
    dev = sorted((max(s, t0), min(e, t1), n) for s, e, n in dev
                 if e > t0 and s < t1)
    by_op = defaultdict(float)
    busy, gaps, cursor = 0, [], t0
    for s, e, n in dev:
        by_op[n[:160]] += (e - s) * 1e-9
        if s > cursor:
            gaps.append((cursor, s))
        if e > cursor:
            busy += e - max(s, cursor)
            cursor = e
    if t1 > cursor:
        gaps.append((cursor, t1))
    idle = defaultdict(float)
    if host:
        hs = np.array([h[0] for h in host], np.int64)
        he = np.array([h[1] for h in host], np.int64)
        for s, e in sorted(gaps, key=lambda g: g[0] - g[1])[:2000]:
            mid = (s + e) // 2
            inside = np.nonzero((hs <= mid) & (he >= mid))[0]
            if len(inside):
                name = host[inside[np.argmin(he[inside] - hs[inside])]][2]
            else:
                name = "(no host operation)"
            idle[name[:160]] += (e - s) * 1e-9
    def rank(d):
        return [[k, v] for k, v in sorted(d.items(),
                                          key=lambda kv: -kv[1])[:top]]
    return {"busy_s": busy * 1e-9, "window_s": (t1 - t0) * 1e-9,
            "device_ops": rank(by_op), "idle_gaps": rank(idle)}
