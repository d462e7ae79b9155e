"""The readings a cell's comparison limits are set from, on the card.

    python3 -m p2l_bench.calibrate --workload <cell> --seeds S [S ...] \\
        [--control N] [--faults half_batch answer ...] [--out PATH]

For every seed it builds the cell's run, drives the warm-up generation
and the one after it through the cell's own driver (a window of no length,
so the second is the one a run judges after its window) and reads the
compared numbers: the program's (the lower readings come from these, with
the numbers read beside them for the look), then for the first
``--control`` seeds the control's (the reference computed in TF32 in the
program's place) and an unchanged tell's ``cma_gap.after``, then for those
seeds each planted fault's (``harness/faults.py``). One JSON line per
reading; the last line holds them all. A multi-card cell starts one
process per card. The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

from p2l_bench.harness import env, spec
from p2l_bench.harness.cell import Reducer, Run
from p2l_bench.harness.faults import planted
from p2l_bench.harness.window import Window


def judged(wl, cfg, seed, device, mesh, fault=None) -> Run:
    """A run whose warm-up generation and the one after it ran (under
    ``fault``), its program state freed."""
    with planted(fault):
        run = Run(wl, cfg, seed, device, mesh)
        run.drive(Window(run.opt, wl["optimize"]["meta_steps"], 0.0,
                         on_open=run.opened, on_close=run.closed))
    run.free()
    return run


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--control", type=int, default=3)
    p.add_argument("--faults", nargs="*", default=[])
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    env.prepare_caches()
    wl = spec.workload(args.workload)
    cfg = spec.config(wl["config"])
    chips = int(wl["chips"])
    missing = env.cards_missing(chips)
    if missing:
        print(f"calibrate: {missing}", file=sys.stderr)
        return 2
    if chips > 1 and "RANK" not in os.environ:
        from p2l_bench.harness.launch import launch
        return launch(sys.argv[1:] if argv is None else argv, chips,
                      time.time(), module="p2l_bench.calibrate")
    from p2l_bench.harness.launch import close, rank_mesh
    mesh, device = rank_mesh(chips)
    red = Reducer(mesh, device)
    rows = []

    def record(kind, seed, readings, seconds):
        # the judged numbers and those read beside them for the look
        names = sorted(readings)
        values = red.max([readings[n] for n in names])
        row = {"kind": kind, "seed": seed, "seconds": seconds,
               **dict(zip(names, values))}
        rows.append(row)
        if mesh is None or mesh.rank == 0:
            print(json.dumps(row), flush=True)

    for i, seed in enumerate(args.seeds):
        t = time.time()
        run = judged(wl, cfg, seed, device, mesh)
        record("program", seed, run.readings(look=True), time.time() - t)
        if i < args.control:
            t = time.time()
            record("control", seed, run.readings("control"),
                   time.time() - t)
            record("unchanged", seed, run.readings("unchanged"), 0.0)
        del run
    for fault in args.faults:
        for seed in args.seeds[:args.control]:
            t = time.time()
            run = judged(wl, cfg, seed, device, mesh, fault)
            record(fault, seed, run.readings(), time.time() - t)
            del run
    if mesh is None or mesh.rank == 0:
        summary = {"workload": wl["name"], "card": env.card(device.index or 0),
                   "readings": rows}
        print(json.dumps(summary), flush=True)
        if args.out:
            with open(args.out, "w") as f:
                f.write(json.dumps(summary) + "\n")
    close(mesh)
    return 0


if __name__ == "__main__":
    sys.exit(main())
