"""The ranks of a multi-card cell, started as ``torchrun`` starts them.

The first process of a run starts one child process per card with
torchrun's variables (``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE``,
``RANK``, ``LOCAL_RANK``), keeps rank 0's standard output as its own and
sends the others' to standard error, waits for every child and returns
the worst exit code. A child that fails ends the others.
"""

from __future__ import annotations

import os
import socket
import subprocess
import sys
import time


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def launch(argv, ranks: int, t0: float, module="p2l_bench.run") -> int:
    port = _free_port()
    procs = []
    for rank in range(ranks):
        env = dict(os.environ, MASTER_ADDR="localhost",
                   MASTER_PORT=str(port), WORLD_SIZE=str(ranks),
                   RANK=str(rank), LOCAL_RANK=str(rank),
                   P2L_BENCH_T0=repr(t0))
        procs.append(subprocess.Popen(
            [sys.executable, "-m", module, *argv], env=env,
            stdout=None if rank == 0 else sys.stderr))
    try:
        while any(p.poll() is None for p in procs):
            if any(p.poll() not in (None, 0) for p in procs):
                break
            time.sleep(0.2)
    finally:
        for p in procs:
            if p.poll() is None:
                p.terminate()
        for p in procs:
            try:
                p.wait(timeout=30)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()
    codes = [p.returncode for p in procs]
    return next((c for c in codes if c != 0), 0)


def rank_mesh(chips: int):
    """``(mesh, device)`` of this process: the population mesh over the
    ranks the launcher started (NCCL), or no mesh and the first card."""
    import torch
    if chips == 1:
        return None, torch.device("cuda", 0)
    from pix2latent_tpu_torch.parallel import make_mesh, multihost
    multihost.initialize_multihost(backend="nccl")
    mesh = make_mesh(devices="cuda")
    return mesh, mesh.device


def close(mesh):
    """Wait for every rank, then end the process group."""
    if mesh is not None:
        import torch.distributed as dist
        dist.barrier()
        dist.destroy_process_group()
