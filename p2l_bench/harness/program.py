"""Readers' arithmetic over the program's own spans: the records that
``pix2latent_tpu_torch.utils.profiling.span`` keeps while the traced run's
profiler is on, and the device's idle gaps put down to them.

A record is ``{"id", "parent", "name", "attrs", "start_ns", "end_ns",
"host_ms", "device_ms"}`` (``profiling.spans()``); its host interval is on
the profiler's clock. A trace may carry them as ``trace["program"]`` and
the idle intervals of the traced window as ``trace["device"]["gaps"]``
(``[[start_ns, end_ns]]``). Where it does not, both are taken from the run
itself: the records from the program, those of the traced window, and the
gaps from the harness's ``DeviceTrace``, found in the frames that called
the reader; the first reader stores both in the trace for the others. A
program without spans gives None, and so does every reader here.

"Per generation" is per recorded ``strategy_tell`` span: a generation
tells once, and its tell always falls inside the traced window. Without a
card a record has no device time, and its host time stands in (the CPU
rehearsal), as ``trace.HostEvent`` does for the harness's own spans.
"""

from __future__ import annotations

import sys

import numpy as np


def _device_trace():
    """The harness's ``DeviceTrace`` of this run, from the calling frames;
    None outside a traced run."""
    from p2l_bench.harness.trace import DeviceTrace
    frame = sys._getframe(1)
    while frame is not None:
        for value in list(frame.f_locals.values()):
            if isinstance(value, DeviceTrace) and value.t1 is not None:
                return value
        frame = frame.f_back
    return None


def idle_gaps(dev, t0, t1) -> list:
    """``[[start_ns, end_ns]]`` of the times inside ``[t0, t1]`` that no
    device interval of ``dev`` (``(start_ns, end_ns, ...)``) covers: the
    complement of the union that ``trace.summarize`` calls busy."""
    gaps, cursor = [], t0
    for s, e in sorted((max(d[0], t0), min(d[1], t1)) for d in dev
                       if d[1] > t0 and d[0] < t1):
        if s > cursor:
            gaps.append([cursor, s])
        cursor = max(cursor, e)
    if t1 > cursor:
        gaps.append([cursor, t1])
    return gaps


def _from_run(trace):
    """Fill ``trace["program"]`` and ``trace["device"]["gaps"]`` from the
    run, where the harness left them out and the program records spans."""
    if "program" in trace:
        return
    trace["program"] = None
    from pix2latent_tpu_torch.utils import profiling
    dtrace = _device_trace()
    if not hasattr(profiling, "spans") or dtrace is None:
        return
    from torch.autograd import DeviceType
    t0, t1 = dtrace.t0, dtrace.t1
    trace["program"] = [r for r in profiling.spans()
                        if r["end_ns"] >= t0 and r["start_ns"] <= t1]
    dev = [(e.start_ns(), e.start_ns() + e.duration_ns())
           for e in dtrace.prof.profiler.kineto_results.events()
           if e.duration_ns() > 0 and e.device_type() == DeviceType.CUDA]
    trace["device"]["gaps"] = idle_gaps(dev, t0, t1)


def records(trace):
    """The program's span records of the traced window; None without."""
    _from_run(trace)
    return trace["program"] or None


def gaps(trace):
    """The traced window's idle intervals; None without spans."""
    if records(trace) is None:
        return None
    return trace["device"].get("gaps")


def _ms(rec) -> float:
    return rec["device_ms"] if rec["device_ms"] is not None else rec[
        "host_ms"]


def _generations(recs) -> int:
    return sum(r["name"] == "strategy_tell" for r in recs)


def _under(recs, ancestor):
    """Each record's test: is a span named ``ancestor`` around it?"""
    by_id = {r["id"]: r for r in recs}

    def inside(rec):
        parent = by_id.get(rec["parent"])
        while parent is not None:
            if parent["name"] == ancestor:
                return True
            parent = by_id.get(parent["parent"])
        return False
    return inside


def ms_per_generation(trace, name):
    """Summed time of the spans ``name``, per generation."""
    recs = records(trace)
    if recs is None or not _generations(recs):
        return None
    return sum(_ms(r) for r in recs if r["name"] == name) / _generations(
        recs)


def count_per_generation(trace, name):
    """The number of spans ``name``, per generation."""
    recs = records(trace)
    if recs is None or not _generations(recs):
        return None
    return sum(r["name"] == name for r in recs) / _generations(recs)


def ms_per_step(trace, name, within="inner"):
    """Summed time of the spans ``name`` under a ``within`` span, per
    ``step`` span under one."""
    recs = records(trace)
    if recs is None:
        return None
    inside = _under(recs, within)
    steps = sum(r["name"] == "step" and inside(r) for r in recs)
    if not steps:
        return None
    return sum(_ms(r) for r in recs
               if r["name"] == name and inside(r)) / steps


def idle_ms_per_generation(trace, names, inside: bool):
    """Device idle time per generation, ms, of the gaps whose middle falls
    (``inside``) or does not fall (not ``inside``) in the host interval of
    a span named in ``names``; a gap inside a span is inside every span
    around it, so this is the gap's innermost span or one of its
    ancestors."""
    recs = records(trace)
    idle = gaps(trace)
    if recs is None or idle is None or not _generations(recs):
        return None
    spans = [(r["start_ns"], r["end_ns"]) for r in recs
             if r["name"] in names]
    idle = np.asarray(idle, np.int64).reshape(-1, 2)
    mids = (idle[:, 0] + idle[:, 1]) // 2
    held = np.zeros(len(mids), bool)
    for s, e in spans:
        held |= (mids >= s) & (mids <= e)
    pick = held if inside else ~held
    return float((idle[pick, 1] - idle[pick, 0]).sum()) * 1e-6 / \
        _generations(recs)
