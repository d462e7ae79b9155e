"""Multi-process population sharding (counterpart of
``pix2latent_tpu/parallel/multihost.py``).

The population axis is the only sharded axis, the generator weights and the
search state are replicated, and the one collective of a generation is the
gather of the per-sample losses into the tell (``parallel/mesh.py``), so
running one inversion's population on several cards changes where the
ranks come from, nothing about the program. One process runs per card::

    torchrun --nproc_per_node=N -m pix2latent_tpu_torch.examples.\\
        invert_biggan_basincma_sharded

and each of them calls::

    from pix2latent_tpu_torch.parallel import make_mesh, multihost
    multihost.initialize_multihost()     # before any kernel runs
    mesh = make_mesh()                   # every rank of the group
    ... BasinCMAOptimizer(..., mesh=mesh).optimize(...)   # unchanged

Every rank runs the same program; the results land on every rank, and rank
0 (``mesh.is_writer``) writes the files.
"""

from __future__ import annotations

import os
from typing import Optional

import torch
import torch.distributed as dist


def _launcher_markers() -> bool:
    """True when ``torchrun`` (or a launcher setting its variables) started
    this process as one of several: ``TORCHELASTIC_RUN_ID``, or
    ``WORLD_SIZE`` above 1."""
    if os.environ.get("TORCHELASTIC_RUN_ID"):
        return True
    try:
        return int(os.environ.get("WORLD_SIZE", "1")) > 1
    except ValueError:
        return True


def _env_config() -> bool:
    """The ``env://`` rendezvous's own variables are set."""
    return "MASTER_ADDR" in os.environ and "WORLD_SIZE" in os.environ


def _init_method(coordinator_address: Optional[str]) -> str:
    if coordinator_address is None:
        return "env://"
    if "://" in coordinator_address:
        return coordinator_address
    return f"tcp://{coordinator_address}"


def initialize_multihost(coordinator_address: Optional[str] = None,
                         num_processes: Optional[int] = None,
                         process_id: Optional[int] = None,
                         local_device_ids=None,
                         backend: Optional[str] = None) -> dict:
    """Idempotent wrapper over ``torch.distributed.init_process_group``.

    A group is made when the caller or the environment asks for one:
    explicit arguments (``coordinator_address`` ``host:port``, or a
    ``tcp://`` or ``file://`` URL; ``num_processes`` is the world size,
    ``process_id`` the rank), or ``torchrun``'s variables
    (``MASTER_ADDR`` / ``MASTER_PORT`` / ``WORLD_SIZE`` / ``RANK`` through
    ``env://``; ``TORCHELASTIC_RUN_ID`` or ``WORLD_SIZE`` above 1 mark a
    multi-process launch). Plain single-process runs are a no-op.

    ``backend``: NCCL when CUDA is available, else gloo. Under NCCL the
    card is ``local_device_ids[0]``, else ``LOCAL_RANK``, and becomes the
    current device before the group starts; NCCL missing raises, with no
    switch to gloo. A failed initialisation raises: each process going on
    alone would compute garbage. Returns :func:`topology`."""
    if dist.is_available() and dist.is_initialized():
        return topology()
    explicit = (coordinator_address is not None or num_processes is not None
                or process_id is not None)
    from_env = _env_config() or _launcher_markers()
    if not (explicit or from_env):
        return topology()
    if not dist.is_available():
        raise RuntimeError("torch.distributed is not available in this "
                           "PyTorch build")

    backend = backend or ("nccl" if torch.cuda.is_available() else "gloo")
    if backend == "nccl":
        if not dist.is_nccl_available():
            raise RuntimeError("NCCL is not available in this PyTorch build; "
                               "a CUDA population mesh needs it")
        if local_device_ids is not None and len(local_device_ids) != 1:
            raise ValueError(f"one card per process, got local_device_ids="
                             f"{local_device_ids}")
        local = (int(local_device_ids[0]) if local_device_ids is not None
                 else int(os.environ.get("LOCAL_RANK", "0")))
        torch.cuda.set_device(local)
    kwargs = {}
    if num_processes is not None:
        kwargs["world_size"] = int(num_processes)
    if process_id is not None:
        kwargs["rank"] = int(process_id)
    try:
        dist.init_process_group(backend=backend,
                                init_method=_init_method(coordinator_address),
                                **kwargs)
    except Exception as e:
        if explicit:
            raise
        raise RuntimeError(
            "torch.distributed.init_process_group failed although the "
            "environment asks for a process group (MASTER_ADDR/WORLD_SIZE, "
            "TORCHELASTIC_RUN_ID). Each process going on alone would "
            "compute garbage. Fix the launch (torchrun sets MASTER_ADDR, "
            "MASTER_PORT, WORLD_SIZE, RANK and LOCAL_RANK) or pass "
            "coordinator_address/num_processes/process_id; to run one "
            "process alone, clear WORLD_SIZE and TORCHELASTIC_RUN_ID.") from e
    return topology()


def topology() -> dict:
    """This process's rank, the number of processes, and the cards: one a
    process."""
    distributed = dist.is_available() and dist.is_initialized()
    count = dist.get_world_size() if distributed else 1
    return {
        "process_index": dist.get_rank() if distributed else 0,
        "process_count": count,
        "local_devices": 1,
        "global_devices": count,
    }


def local_population_rows(mesh, num_samples: int,
                          axis_name: str = "pop") -> range:
    """The population rows this process computes: with the population
    split over the ranks in order, ``[rank * per, (rank + 1) * per)``. A
    population that does not split over the mesh raises ``ValueError``."""
    return mesh.rows(num_samples)
