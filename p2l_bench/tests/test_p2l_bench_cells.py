"""Each cell end to end at a small width on the CPU: everything a run does
after its look for a card (set-up, warm-up, window, traced readers, the
comparison, the result line), and the same run with the timed path broken
underneath coming out not correct, for each fault the cell can have, also
where the fault appears only after the first generation."""

import contextlib
import io
import json
import os
import socket
import sys
import time
import types

import pytest
import torch
import torch.multiprocessing as mp

from p2l_bench import run as run_cli
from p2l_bench.harness import cell as cell_mod
from p2l_bench.harness import spec
from p2l_bench.harness.faults import FAULTS, planted
from p2l_bench.tests import tiny

CPU = torch.device("cpu")
BENCH = spec.benchmark()


@pytest.fixture(autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def measure(wl, cfg, traced, seconds=None, mesh=None, fault=None,
            late=False):
    # the CPU's profiler slows a traced generation several times
    seconds = seconds or (15.0 if traced else 10.0)
    with planted(fault, late):
        out = cell_mod.measure(wl, cfg, 2 ** 31 + 17, seconds, traced, CPU,
                               time.time(), BENCH, mesh)
    if mesh is not None and mesh.rank != 0:
        return None
    return run_cli.result_line(wl, cfg, BENCH, out, traced,
                               {"name": "cpu"}, mesh.size if mesh else 1)


def limits(wl):
    """The cell's checks at limits that pass at the tiny size (the cell's
    own limits are set for the card at the timed size)."""
    wl["checks"] = {n: tiny.LIMITS.get(n, 1e-4) for n in wl["checks"]}
    return wl


@pytest.mark.parametrize("cell,traced", [
    ("biggan256-basincma", True), ("cars512-basincma", False),
    ("cars512-basincma", True), ("biggan256-cma-evalonly", True),
    ("biggan256-cma-evalonly", False)])
def test_cell_end_to_end(cell, traced, monkeypatch):
    wl, cfg = tiny.cell(cell, monkeypatch)
    line = measure(limits(wl), cfg, traced)
    assert line["correct"], (line["attempted"], line["checks"])
    assert line["attempted"] >= 1 and line["failed"] == 0
    names = {m["name"] for m in spec.cell_metrics(BENCH, cell, traced)}
    assert set(line["metrics"]) <= names
    if traced:
        assert {"busy_s", "window_s"} <= set(line["device"])
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    else:
        assert set(line["metrics"]) == names
    assert list(line)[-1] == "checks"


@pytest.mark.parametrize("cell,fault", [
    ("biggan256-basincma", "unchanged"), ("biggan256-basincma", "half_batch"),
    ("biggan256-basincma", "answer"), ("cars512-basincma", "half_batch"),
    ("biggan256-cma-evalonly", "answer")])
def test_fault_is_not_correct(cell, fault, monkeypatch):
    wl, cfg = tiny.cell(cell, monkeypatch)
    line = measure(limits(wl), cfg, False, fault=fault)
    assert any(c["value"] is None or c["value"] > c["limit"]
               for c in line["checks"].values()), line["checks"]
    assert not line["correct"]


@pytest.mark.parametrize("cell,fault", [
    ("biggan256-basincma", "half_batch"), ("biggan256-basincma", "answer"),
    ("cars512-basincma", "unchanged"), ("biggan256-cma-evalonly", "answer")])
def test_fault_after_the_first_generation_is_not_correct(cell, fault,
                                                         monkeypatch):
    # the warm-up generation is sound; the generation judged after the
    # window is not
    wl, cfg = tiny.cell(cell, monkeypatch)
    line = measure(limits(wl), cfg, False, seconds=0.5, fault=fault,
                   late=True)
    assert any(c["value"] is None or c["value"] > c["limit"]
               for c in line["checks"].values()), line["checks"]
    assert not line["correct"]


def _rank(rank, world, port, case, results):
    os.environ.update(MASTER_ADDR="localhost", MASTER_PORT=str(port),
                      WORLD_SIZE=str(world), RANK=str(rank),
                      LOCAL_RANK=str(rank))
    torch.set_num_threads(1)
    from pix2latent_tpu_torch.parallel import make_mesh, multihost
    multihost.initialize_multihost(backend="gloo")
    mesh = make_mesh(devices="cpu")
    wl, cfg = tiny.cell("biggan256-basincma-x4")
    limits(wl)
    if case == "jax_on_rank1" and rank == 1:
        measure = cell_mod.measure

        def loads_jax(*args, **kwargs):
            # found in sys.modules once the window has closed
            out = measure(*args, **kwargs)
            sys.modules["jax"] = types.ModuleType("jax")
            return out
        cell_mod.measure = loads_jax
    args = types.SimpleNamespace(seed=2 ** 31 + 17, seconds=15.0, trace=1)
    stdout = io.StringIO()
    with planted(case if case in FAULTS else None), \
            contextlib.redirect_stdout(stdout):
        code = run_cli.serve(args, wl, cfg, BENCH, CPU, mesh, time.time())
    results.put((rank, code, [ln for ln in stdout.getvalue().splitlines()
                              if ln.startswith('{"correct"')]))
    torch.distributed.destroy_process_group()


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.mark.parametrize("case", [None, "no_exchange", "jax_on_rank1"])
def test_four_ranks_over_gloo(case):
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    procs = mp.start_processes(_rank, args=(4, _free_port(), case, results),
                               nprocs=4, join=False, start_method="spawn")
    got = dict((rank, (code, out)) for rank, code, out in
               (results.get(timeout=300) for _ in range(4)))
    while not procs.join(timeout=300):
        pass
    if case == "jax_on_rank1":
        # every rank looks; rank 1 finds it, and rank 0 prints no result
        assert got[1][0] == 3 and got[0] == (3, []), got
        return
    assert [got[r][0] for r in range(4)] == [0, 0, 0, 0]
    assert [len(got[r][1]) for r in range(4)] == [1, 0, 0, 0]
    line = json.loads(got[0][1][-1])
    assert line["correct"] == (case is None), line["checks"]
    assert line["device"]["count"] == 4
    if case is None:
        assert "gather_ms.x4" in line["metrics"]
