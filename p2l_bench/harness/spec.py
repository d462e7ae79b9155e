"""Finding a cell's files by name.

``BENCHMARK.json`` at the checkout's root lists the cells and metrics;
``workloads/<cell>.json`` holds a cell (its configuration, traffic, cards
and the limits of its comparison), ``traffic/<traffic>.json`` the driver
and schedule a traffic mix runs, ``configs/<config>.json`` a
configuration, ``metrics/<metric>.py`` the reader of a per-layer metric and
``problems/<problem>.py`` the builder of a configuration's model family.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark() -> dict:
    return _json(ROOT / "BENCHMARK.json")


def _named(kind: str, name: str) -> dict:
    d = _json(BENCH_DIR / kind / f"{name}.json")
    if d.get("name") != name:
        raise ValueError(f"{kind}/{name}.json names itself "
                         f"{d.get('name')!r}")
    return d


def traffic(name: str) -> dict:
    return _named("traffic", name)


def workload(name: str) -> dict:
    """Cell ``name``: its workload file over its traffic's (the cell's own
    keys win; ``why`` and ``name`` are the cell's)."""
    wl = _named("workloads", name)
    return {**traffic(wl["traffic"]), **wl}


def config(name: str) -> dict:
    return _named("configs", name)


def problem(name: str):
    """The module that builds configuration family ``name``."""
    return importlib.import_module(f"p2l_bench.problems.{name}")


def reader(metric: str):
    """The reader of per-layer metric ``metric``: ``metrics/<metric>.py``
    (a name may hold dots, so it is loaded by path)."""
    path = BENCH_DIR / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        f"p2l_bench.metrics.{metric.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def cell_metrics(bench: dict, cell: str, traced: bool) -> list:
    """The metric entries a run of ``cell`` reports: the end-to-end ones
    untraced, the per-layer ones traced; an entry with ``workloads`` only
    in those cells."""
    entries = bench["per_layer" if traced else "end_to_end"]
    return [m for m in entries if cell in m.get("workloads", [cell])]
