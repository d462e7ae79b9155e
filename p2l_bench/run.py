"""Run one cell of the benchmark once and print its result.

    python3 -m p2l_bench.run --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

The last line of standard output is one JSON object: ``correct``,
``attempted`` (generations completed in the window), ``failed`` (those
whose tell losses were not finite), ``metrics`` (the cell's end-to-end
metrics, or with ``--trace 1`` its per-layer ones), ``device``, with
``--trace 1`` the ``breakdown``, then ``card`` and last ``checks``: each
number the comparison judged, beside its limit. The same numbers close
standard error. The run exits non-zero and prints no result without the
cards the cell needs, when the program cannot be imported, or when a JAX
module was loaded in any of its processes. A cell on several cards starts
one process per card.
"""

from __future__ import annotations

import time

T0 = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def result_line(wl, cfg, bench, out, traced, card, chips) -> dict:
    """The result's JSON object from :func:`cell.measure`'s fields."""
    units = {m["name"]: m["unit"] for m in
             bench["end_to_end"] + bench["per_layer"]}
    if traced:
        values = {k: v for k, v in out["per_layer"].items() if v is not None}
    else:
        rate = (out["generations"] * cfg["popsize"] * wl["work_per_row"]
                / out["window_s"]) if out["generations"] else None
        values = {wl["rate_metric"]: rate, "setup_s": out["setup_s"]}
    metrics = {k: {"value": v, "unit": units[k]} for k, v in values.items()
               if v is not None}
    device = {"platform": "gpu", "kind": card["name"], "count": chips,
              "memory_peak_bytes": int(out["peak_bytes"])}
    if traced:
        device["busy_s"] = out["busy_s"]
        device["window_s"] = out["trace_window_s"]
    checks = {n: {"value": (out["readings"][n]
                            if math.isfinite(out["readings"][n]) else None),
                  "limit": lim}
              for n, lim in sorted(wl["checks"].items())}
    correct = (out["generations"] > 0 and out["failed"] == 0
               and all(c["value"] is not None and c["value"] <= c["limit"]
                       for c in checks.values()))
    line = {"correct": bool(correct), "attempted": out["generations"],
            "failed": out["failed"], "metrics": metrics, "device": device}
    if traced:
        line["breakdown"] = out["breakdown"]
    line["card"] = card
    line["checks"] = checks
    return line


def main(argv=None) -> int:
    args = parse(argv)
    from p2l_bench.harness import env, spec
    env.prepare_caches()
    wl = spec.workload(args.workload)
    cfg = spec.config(wl["config"])
    bench = spec.benchmark()
    chips = int(wl["chips"])
    missing = env.cards_missing(chips)
    if missing:
        print(f"p2l_bench: cannot run {wl['name']}: {missing}",
              file=sys.stderr)
        return 2
    if chips > 1 and "RANK" not in os.environ:
        from p2l_bench.harness.launch import launch
        return launch(sys.argv[1:] if argv is None else argv, chips, T0)

    from p2l_bench.harness.launch import close, rank_mesh
    mesh, device = rank_mesh(chips)
    t0 = float(os.environ.get("P2L_BENCH_T0", T0))
    code = serve(args, wl, cfg, bench, device, mesh, t0)
    close(mesh)
    return code


def serve(args, wl, cfg, bench, device, mesh, t0) -> int:
    """One rank's run once its card (and mesh) are up: measure, look for
    forbidden modules on every rank, and on rank 0 print the result. A
    rank that finds one exits 3, and so does rank 0, printing no result."""
    from p2l_bench.harness import env
    from p2l_bench.harness.cell import Reducer, measure
    out = measure(wl, cfg, args.seed, args.seconds, bool(args.trace),
                  device, t0, bench, mesh)
    loaded = env.forbidden_modules()
    if loaded:
        print(f"p2l_bench: forbidden modules were loaded: {loaded}",
              file=sys.stderr)
    if Reducer(mesh, device).max([float(bool(loaded))])[0] > 0:
        if not loaded:
            print("p2l_bench: another rank loaded forbidden modules",
                  file=sys.stderr)
        return 3
    if mesh is not None and mesh.rank != 0:
        return 0
    line = result_line(wl, cfg, bench, out, bool(args.trace),
                       env.card(device.index or 0) if device.type == "cuda"
                       else {"name": str(device)},
                       mesh.size if mesh is not None else 1)
    sys.stdout.flush()
    print(f"set-up: {json.dumps(out['setup'])}; window "
          f"{out['window_s']!r} s, {out['generations']} generations of "
          f"{json.dumps(out['generation_s'])} s", file=sys.stderr)
    for name, c in line["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
