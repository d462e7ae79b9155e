"""One run of one cell: set-up, the warm-up generation, the measured
window over the driver's own loop, one more generation after it, then the
comparison with the reference.

Set-up makes the inputs from the seed on the device, builds the port's
problem and optimizer as the cell's entry point does, and runs the first
generation through the same ``optimize`` call the window goes on with (the
warm-up, which builds every shape the window uses). ``setup_s`` runs from
the process's start to the window's opening. Where the window closes, the
driver runs one more generation outside the counted time. Then the peak
memory is read, the program's state freed, and the reference judges both
generations (``checks``): the warm-up, which starts from the harness's own
candidates, and the one after the window, which starts from the program's.
"""

from __future__ import annotations

import gc
import math
import time

import torch

from p2l_bench.harness import checks, spec
from p2l_bench.harness.capture import Capture
from p2l_bench.harness.trace import (DeviceTrace, ModuleTimer, Spans,
                                     synchronize)
from p2l_bench.harness.window import EndOfInversion, StopWindow, Window


def padded(popsize: int, mesh) -> int:
    size = mesh.size if mesh is not None else 1
    return -(-popsize // size) * size


class Run:
    """A cell's problem, optimizer and warm-up capture on one rank."""

    def __init__(self, wl, cfg, seed: int, device, mesh=None):
        t = time.time()
        from pix2latent_tpu_torch import optimizers
        self.phases = {"import_s": time.time() - t}
        self.wl, self.cfg, self.mesh, self.device = wl, cfg, mesh, device
        self.problem = spec.problem(cfg["problem"])
        self.popsize = padded(cfg["popsize"], mesh)
        self.rows = (mesh.rows(self.popsize) if mesh is not None
                     else range(self.popsize))
        t = time.time()
        self.inputs = self.problem.make_inputs(cfg, seed, device,
                                               self.popsize)
        synchronize(device.type == "cuda")
        self.phases["inputs_s"] = time.time() - t
        t = time.time()
        self.model, vm, loss_fn = self.problem.build(cfg, self.inputs, device)
        cls = getattr(optimizers, wl["optimizer"])
        self.opt = cls(self.model, vm, loss_fn, mesh=mesh, seed=seed,
                       device=device)
        self.capture = Capture(self.opt, self.inputs["x0"])
        self.capture.install()
        self.after = None
        self.phases["build_s"] = time.time() - t

    def opened(self):
        """The warm-up generation is over: its capture comes off."""
        self.capture.remove()

    def closed(self):
        """The window is closed: capture the generation that follows."""
        self.after = Capture(self.opt, None)
        self.after.install()

    def drive(self, window: Window):
        """Inversions through the driver's ``optimize`` until the window
        stops."""
        window.install()
        try:
            while True:
                window.new_inversion()
                try:
                    self.opt.optimize(**self.wl["optimize"])
                except EndOfInversion:
                    continue
                raise RuntimeError("the driver ran its final steps, which "
                                   "the window never lets it reach")
        except StopWindow:
            pass
        finally:
            window.remove()

    def free(self):
        """Drop the program's state; the inputs and the captures stay."""
        self.capture.remove()
        if self.after is not None:
            self.after.remove()
        self.opt = self.model = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def readings(self, mode: str = "program", look: bool = False) -> dict:
        """The compared numbers, each the larger of the two judged
        generations' readings (the warm-up and the one after the window);
        the CMA update is ``cma_gap`` for the warm-up and ``cma_gap.after``
        for the other, from the program's state before its tell.
        ``mode`` "control": the reference in TF32 in the program's place;
        "unchanged": a tell that returned its state unchanged (the other
        numbers read 1 then by construction). ``look`` adds the numbers
        read beside them for a calibration's look."""
        ref = self.problem.Reference(self.cfg, self.inputs)
        out = {}
        for cap, start in ((self.capture, self.problem.start(
                self.cfg, self.inputs, self.rows)),
                (self.after, None)):
            if cap is None:
                continue
            part = self._generation(ref, cap, start, mode, look)
            if cap is self.after:
                part = {n.replace("cma_gap", "cma_gap.after"): v
                        for n, v in part.items()}
            for n, v in checks.finite(part).items():
                # NaN, where a side was not finite, wins
                out[n] = v if math.isnan(v) else max(out.get(n, v), v)
        return out

    def _generation(self, ref, cap, start, mode, look) -> dict:
        """One captured generation's numbers; ``start`` None: the leaves
        that entered the generation's first hook call, the program's."""
        kind, block = self.wl["kind"], self.cfg["reference_block_rows"]
        before = None
        if start is None:
            start = {n: t.clone() for n, t in cap.hooks[0][0].items()}
            before = cap.tell["before"]
        dim = cap.tell["x"].shape[1]
        cma_ref = checks.reference_cma(cap, self.popsize, dim, before=before)
        if mode == "unchanged":
            return {"cma_gap": checks.cma_gap(
                checks.cma_state(cap.tell["before"]), cma_ref)}
        ref_side = checks.reference_side(ref, cap, start, kind, self.popsize,
                                         block)
        if mode == "control":
            prog = checks.reference_side(ref, cap, start, kind,
                                         self.popsize, block, tf32=True)
            prog["cma"] = checks.reference_cma(cap, self.popsize, dim,
                                               tf32=True, before=before)
            prog["tell_loss"] = self._all_rows(prog["tell_loss"])
        else:
            prog = checks.program_side(cap, range(self.popsize), kind)
        # every rank judges the whole population's tell losses, the
        # program's as its exchange delivered them against the reference's
        # as the harness's own gather delivers them
        ref_side["tell_loss"] = self._all_rows(ref_side["tell_loss"])
        out = checks.numbers(prog, ref_side, cma_ref, look)
        noise = checks.noise_gap(ref, cap)
        if noise is not None and mode == "program":
            out["noise_gap"] = noise
        return out

    def _all_rows(self, t):
        """Every rank's rows of ``t``, gathered by the harness itself."""
        if self.mesh is None or self.mesh.size == 1:
            return t
        import torch.distributed as dist
        parts = [torch.empty_like(t) for _ in range(self.mesh.size)]
        dist.all_gather(parts, t.contiguous())
        return torch.cat(parts)


class Reducer:
    """Reductions over the ranks of a mesh (identity on one)."""

    def __init__(self, mesh, device):
        self.mesh, self.device = mesh, device
        self.on = mesh is not None and mesh.size > 1

    def _all(self, values, op):
        if not self.on:
            return list(values)
        import torch.distributed as dist
        t = torch.tensor(values, dtype=torch.float64, device=self.device)
        dist.all_reduce(t, op=op)
        return t.tolist()

    def max(self, values):
        import torch.distributed as dist
        return self._all(values, dist.ReduceOp.MAX if self.on else None)

    def mean(self, values):
        import torch.distributed as dist
        total = self._all(values, dist.ReduceOp.SUM if self.on else None)
        return [v / (self.mesh.size if self.on else 1) for v in total]

    def stop(self, stop: bool) -> bool:
        """Rank 0's decision, on every rank."""
        mine = 1.0 if stop and self.mesh.rank == 0 else 0.0
        return self.max([mine])[0] > 0


def measure(wl, cfg, seed: int, seconds: float, traced: bool, device, t0,
            bench: dict, mesh=None):
    """One run of cell ``wl``: the result's fields (on every rank; rank 0's
    are printed)."""
    cuda = device.type == "cuda"
    red = Reducer(mesh, device)
    before = time.time() - t0
    run = Run(wl, cfg, seed, device, mesh)
    run.phases["start_s"] = before
    entries = spec.cell_metrics(bench, wl["name"], traced)
    readers = ({m["name"]: spec.reader(m["name"]) for m in entries}
               if traced else {})
    classes = {c for r in readers.values() for c in getattr(r, "MODULES", ())}
    state = {"finite": [], "tracing": False}
    spans = Spans(cuda)
    modules = dtrace = None

    def open_window():
        nonlocal modules, dtrace
        run.opened()
        if red.on:
            mesh.barrier()
        synchronize(cuda)
        state["setup_s"] = time.time() - t0
        run.phases["warm_up_s"] = time.time() - state["warm_up_from"]
        if traced:
            spans.generation = 1
            spans.wrap(run.opt.core, "grad_steps", "grad_steps",
                       lambda a, kw, out: {"steps": int(a[3])})
            spans.wrap(run.opt.core, "eval", "eval")
            if mesh is not None:
                spans.wrap(mesh, "gather", "gather")
            modules = ModuleTimer(run.model, classes, cuda)
            dtrace = DeviceTrace(cuda)
            dtrace.start()
            state["tracing"] = True

    def stop_tracing():
        if state["tracing"]:
            modules.remove()
            dtrace.stop()
            state["tracing"] = False

    def generation_end(i):
        losses = run.opt.losses
        state["finite"].append(bool(losses) and math.isfinite(losses[-1]))
        spans.generation = i + 1
        if i >= wl["trace_generations"]:
            stop_tracing()

    def close_window():
        # the generation after the window is judged, not timed or traced
        stop_tracing()
        spans.remove()
        run.closed()

    window = Window(run.opt, wl["optimize"]["meta_steps"], seconds,
                    on_open=open_window, on_generation=generation_end,
                    share=red.stop if red.on else None,
                    on_close=close_window)
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    state["warm_up_from"] = time.time()
    run.drive(window)
    synchronize(cuda)
    gens, secs = window.counted()
    peak = red.max([torch.cuda.max_memory_allocated(device)
                    if cuda else 0])[0]
    out = {"generations": gens, "window_s": secs, "setup": run.phases,
           "generation_s": window.generation_seconds(),
           "failed": sum(not f for f in state["finite"][:gens]),
           "setup_s": state["setup_s"], "peak_bytes": peak}
    if traced:
        stop_tracing()
        dev = dtrace.read()
        out["busy_s"], out["trace_window_s"] = red.mean(
            [dev["busy_s"], dev["window_s"]])
        device = {"busy_s": out["busy_s"], "window_s": out["trace_window_s"]}
        out["trace"] = _trace(wl, cfg, run, window, spans, modules, device,
                              peak, mesh)
        out["breakdown"] = {"device_ops": dev["device_ops"],
                            "idle_gaps": dev["idle_gaps"]}
        out["per_layer"] = {name: r.read(out["trace"])
                            for name, r in readers.items()}
    run.free()
    names = sorted(wl["checks"])
    readings = run.readings()
    values = red.max([math.inf if not math.isfinite(readings.get(n, math.nan))
                      else readings[n] for n in names])
    out["readings"] = dict(zip(names, values))
    return out


def _trace(wl, cfg, run, window, spans, modules, device, peak,
           mesh) -> dict:
    from p2l_bench.flops import model as model_flops
    from p2l_bench.flops.roofline import PEAK_FLOPS
    gens, secs = window.counted()
    return {"cell": wl["name"], "kind": wl["kind"], "config": cfg,
            "chips": mesh.size if mesh is not None else 1,
            "rows": cfg["popsize"],
            "grad_steps": wl["optimize"].get("grad_steps", 0)
            if wl["kind"] != "evalonly" else 0,
            "generations": gens, "window_s": secs,
            "generation_s": window.generation_seconds(),
            "spans": spans.read(gens), "modules": modules.read(),
            "device": device,
            "peak_bytes": peak, "flops": model_flops.per_row(cfg),
            "peak_flops": PEAK_FLOPS[cfg["dtype"]]}
