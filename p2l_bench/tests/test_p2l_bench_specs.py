"""Every configuration, cell, traffic mix and metric of ``BENCHMARK.json``
is a file of its own that the harness finds by name, and the file keeps
to the benchmark's contract."""

import json
import re

import pytest

from p2l_bench.harness import spec

BENCH = spec.benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]


def test_top_level_keys_and_size():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert len(json.dumps(BENCH)) <= 64 * 1024
    assert BENCH["paths"] == ["p2l_bench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert all(not w.startswith("/") and ".." not in w
               for w in BENCH["command"])


@pytest.mark.parametrize("entry", BENCH["configs"], ids=lambda c: c["name"])
def test_config_file_found_by_name(entry):
    assert NAME.match(entry["name"])
    assert entry["file"] == f"p2l_bench/configs/{entry['name']}.json"
    cfg = spec.config(entry["name"])
    assert cfg["reduced"] == entry["reduced"] == []
    assert cfg["dtype"] == "float32" and cfg["tf32"] is False
    assert spec.problem(cfg["problem"]).Reference
    assert len(entry["why"]) <= 200 and len(entry["source"]) <= 200


@pytest.mark.parametrize("cell", CELLS)
def test_cell_file_found_by_name(cell):
    entry = next(w for w in BENCH["workloads"] if w["name"] == cell)
    wl = spec.workload(cell)
    assert {k: wl[k] for k in ("config", "traffic", "chips", "why")} == {
        k: entry[k] for k in ("config", "traffic", "chips", "why")}
    assert wl["chips"] in (1, 4) and len(wl["why"]) <= 200
    assert spec.traffic(wl["traffic"])["optimizer"] in (
        "BasinCMAOptimizer", "CMAOptimizer")
    assert all(0 < v < 1 for v in wl["checks"].values())


def test_each_pair_of_config_and_traffic_once():
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(set(pairs)) == len(pairs)


def test_at_most_one_four_card_cell():
    assert sum(w["chips"] == 4 for w in BENCH["workloads"]) <= max(
        1, len(CELLS) // 4)


@pytest.mark.parametrize("metric", METRICS, ids=lambda m: m["name"])
def test_metric_entry(metric):
    assert NAME.match(metric["name"]) and UNIT.match(metric["unit"])
    assert metric["better"] in ("lower", "higher")
    assert set(metric.get("workloads", CELLS)) <= set(CELLS)
    if metric in BENCH["per_layer"]:
        assert metric["source"] in ("device_trace", "program_span",
                                    "program_counter", "host_clock")
        assert callable(spec.reader(metric["name"]).read)
        moved = next(m for m in BENCH["end_to_end"]
                     if m["name"] == metric["moves"])
        assert set(metric["workloads"]) <= set(moved.get("workloads", CELLS))
    else:
        assert metric["source"] in ("host_clock", "device_trace")
        assert 0.01 <= metric["bound"] <= 0.25


@pytest.mark.parametrize("cell", CELLS)
def test_every_cell_reports_setup_a_rate_and_a_layer(cell):
    e2e = [m["name"] for m in spec.cell_metrics(BENCH, cell, False)]
    layers = spec.cell_metrics(BENCH, cell, True)
    assert "setup_s" in e2e and len(e2e) >= 2 and layers
    assert spec.workload(cell)["rate_metric"] in e2e


def test_layers_named_alike():
    """Metrics of one module name their layer letter for letter alike."""
    by_layer = {}
    for m in BENCH["per_layer"]:
        by_layer.setdefault(m["layer"], []).append(m["name"])
    assert "device" in by_layer and len(by_layer) >= 5
