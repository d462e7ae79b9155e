"""Population sharding over ``torch.distributed`` (counterpart of
``pix2latent_tpu/parallel/mesh.py``).

The JAX package shards the leading population axis of every variable over a
1-D ``('pop',)`` device mesh and lets GSPMD partition the generator; the
generator weights and the CMA state are replicated, and the one collective
of a generation is the gather of the per-sample losses into the replicated
tell. The port does the same with one process per card:

- every rank holds the model and the search state, replicated;
- every rank computes a contiguous block of the population's rows,
  ``[rank * per, (rank + 1) * per)``: the forward, the backward and Adam on
  those rows only;
- every random draw (the ask, ``VariableManager.initialize``, the hooks) is
  made at the full population size on every rank, which then keeps its own
  rows, so the ranks' generators stay in lockstep and each row sees the
  draws it sees without a mesh;
- the per-row tell losses are gathered into the full population's, and
  every rank runs the same tell on them. Other gathers come only at the end
  of a run, when logging and at a checkpoint, and in the transform search,
  whose variable propagation gathers the propagated variables once a
  generation.

Every gather goes through :meth:`Mesh.gather`, which counts its calls and
bytes (:func:`gather_counts`). NCCL gathers CUDA tensors, gloo CPU tensors;
a CUDA mesh without NCCL raises. Without a process group :func:`make_mesh`
gives a one-rank mesh whose gathers are copies, the JAX package's
single-process mesh.
"""

from __future__ import annotations

import os
from typing import Optional

import torch
import torch.distributed as dist

from pix2latent_tpu_torch.utils.device import resolve_device
from pix2latent_tpu_torch.utils.profiling import span

POP_AXIS = "pop"

_COUNTS = {"gathers": 0, "gather_bytes": 0}


def reset_gather_counts():
    for k in _COUNTS:
        _COUNTS[k] = 0


def gather_counts() -> dict:
    """``{"gathers", "gather_bytes"}`` since the last reset: the calls of
    :meth:`Mesh.gather` and the bytes they gathered (the full result's)."""
    return dict(_COUNTS)


def _map(fn, tree):
    """``fn`` on every tensor of a nested dict / list / tuple / NamedTuple."""
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_map(fn, v) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, v) for v in tree)
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    return tree


def max_rows(tree) -> int:
    """The largest leading dimension of the tensors of ``tree``."""
    rows = []
    _map(lambda t: rows.append(t.shape[0] if t.dim() else 0), tree)
    return max(rows, default=0)


class Mesh:
    """One rank's view of a 1-D population mesh: this rank, the number of
    ranks, this rank's device and whether a ``torch.distributed`` process
    group joins them (without one, only a one-rank mesh gathers)."""

    def __init__(self, rank: int = 0, size: int = 1, device="cpu",
                 distributed: bool = False, axis_name: str = POP_AXIS):
        self.rank, self.size = int(rank), int(size)
        self.device = torch.device(device)
        self.distributed = bool(distributed)
        self.axis_name = axis_name
        self.backend = dist.get_backend() if self.distributed else None

    def __repr__(self):
        return (f"Mesh(rank={self.rank}, size={self.size}, "
                f"device={self.device}, backend={self.backend})")

    @property
    def shape(self) -> dict:
        return {self.axis_name: self.size}

    @property
    def is_writer(self) -> bool:
        """Rank 0 writes the files of a run; every rank holds their data."""
        return self.rank == 0

    def rows(self, pop: int) -> range:
        """The rows of a ``pop``-row population this rank computes."""
        pop = int(pop)
        if pop % self.size:
            raise ValueError(f"a population of {pop} rows does not split "
                             f"over a {self.size}-rank mesh")
        per = pop // self.size
        return range(self.rank * per, (self.rank + 1) * per)

    def local(self, t, pop: int):
        """This rank's rows of ``t`` (``pop`` leading rows)."""
        if self.size == 1:
            return t
        r = self.rows(pop)
        return t[r.start:r.stop]

    def embed(self, t, pop: int):
        """``t``, this rank's rows, at their place in a ``pop``-row tensor
        of zeros: a full-size operand for a draw that every rank makes
        alike."""
        if self.size == 1:
            return t
        r = self.rows(pop)
        full = t.new_zeros((pop, *t.shape[1:]))
        full[r.start:r.stop] = t
        return full

    def gather(self, t):
        """Every rank's ``t`` concatenated in rank order along the leading
        axis (a copy on a one-rank mesh without a process group). Counted
        in :func:`gather_counts`."""
        t = t.detach().contiguous()
        if t.dim() == 0:
            raise ValueError("gather takes a tensor with a leading axis")
        _COUNTS["gathers"] += 1
        _COUNTS["gather_bytes"] += t.numel() * t.element_size() * self.size
        if not self.distributed and self.size != 1:
            raise RuntimeError(f"a {self.size}-rank mesh needs a "
                               "torch.distributed process group")
        with span("gather"):
            if not self.distributed:
                return t.clone()
            if self.backend == "nccl":
                out = t.new_empty((self.size * t.shape[0], *t.shape[1:]))
                dist.all_gather_into_tensor(out, t)
                return out
            parts = [torch.empty_like(t) for _ in range(self.size)]
            dist.all_gather(parts, t)
            return torch.cat(parts)

    def broadcast(self, tree):
        """``tree`` with every tensor replaced by rank 0's (through the
        mesh's device, back to the tensor's own)."""
        if not self.distributed:
            return tree

        def bcast(t):
            buf = t.detach().to(self.device).contiguous().clone()
            dist.broadcast(buf, src=0)
            return buf.to(t.device)
        return _map(bcast, tree)

    def barrier(self):
        """Wait for every rank (a checkpoint's file operations)."""
        if self.distributed:
            dist.barrier()


def _local_index() -> int:
    if "LOCAL_RANK" in os.environ:
        return int(os.environ["LOCAL_RANK"])
    return torch.cuda.current_device()


def _rank_device(devices, rank: int, backend) -> torch.device:
    if isinstance(devices, (list, tuple)):
        return resolve_device(devices[rank])
    kind = devices if devices is not None else (
        "cuda" if backend in (None, "nccl") else "cpu")
    device = resolve_device(kind)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", _local_index())
    return device


def make_mesh(n_devices: Optional[int] = None, axis_name: str = POP_AXIS,
              devices=None) -> Mesh:
    """The population mesh over every rank of the process group (one rank
    without one).

    ``n_devices`` must be None or the world size: a rank cannot sit out of
    the program every rank runs. ``devices``: one device per rank (rank r
    takes ``devices[r]``), or one device type for all (``"cuda"`` is
    ``cuda:LOCAL_RANK``), or None: ``cuda:LOCAL_RANK`` under NCCL or
    without a group, the CPU under gloo. A CUDA device makes it the current
    one. A CUDA mesh over another backend than NCCL, or a CPU mesh over
    NCCL, raises."""
    distributed = dist.is_available() and dist.is_initialized()
    rank = dist.get_rank() if distributed else 0
    size = dist.get_world_size() if distributed else 1
    if n_devices is not None and int(n_devices) != size:
        raise ValueError(f"n_devices={n_devices}: the mesh takes every rank "
                         f"of the process group ({size}); start as many "
                         "processes as cards to use")
    backend = dist.get_backend() if distributed else None
    device = _rank_device(devices, rank, backend)
    if device.type == "cuda":
        if distributed and backend != "nccl":
            raise RuntimeError(f"a CUDA mesh gathers over NCCL, but the "
                               f"process group runs {backend}")
        torch.cuda.set_device(device)
    elif backend == "nccl":
        raise ValueError(f"NCCL gathers CUDA tensors; the mesh's device is "
                         f"{device}")
    return Mesh(rank, size, device, distributed, axis_name)


class PopulationSharding:
    """The population axis split over ``mesh``'s ranks in order, the rest
    of each tensor whole; calling it on a ``[pop, ...]`` tensor gives this
    rank's rows."""

    def __init__(self, mesh: Mesh, axis_name: str = POP_AXIS):
        self.mesh = mesh
        self.axis_name = axis_name

    def rows(self, pop: int) -> range:
        return self.mesh.rows(pop)

    def __call__(self, t):
        return self.mesh.local(t, t.shape[0])


def population_sharding(mesh: Mesh,
                        axis_name: str = POP_AXIS) -> PopulationSharding:
    """Shard the leading (population) dim; replicate the rest."""
    return PopulationSharding(mesh, axis_name)


def replicate(tree, mesh: Mesh):
    """``tree`` (model parameters, a search state, a generator's state) as
    rank 0 holds it, on every rank: one broadcast, run once at set-up."""
    return mesh.broadcast(tree)


def shard_variables(variables, mesh: Mesh, axis_name: str = POP_AXIS,
                    pop: Optional[int] = None):
    """This rank's rows of every tensor of ``variables`` with ``pop``
    (default: the most) leading rows; other tensors (1-row shared outputs,
    scalars) are left whole. A population that does not split over the
    mesh raises ``ValueError``."""
    if mesh.size == 1:
        return variables
    pop = max_rows(variables) if pop is None else int(pop)
    return _map(lambda t: mesh.local(t, pop)
                if t.dim() and t.shape[0] == pop else t, variables)


# the port has no traced graph: the in-graph placement is the same function
constrain_variables = shard_variables


def gather_rows(tree, mesh: Mesh, rows: int):
    """``tree`` with every tensor of ``rows`` leading rows (this rank's
    rows of a population) gathered into the full population's."""
    return _map(lambda t: mesh.gather(t)
                if t.dim() and t.shape[0] == rows else t, tree)


def pad_population(num_samples: int, mesh: Optional[Mesh],
                   axis_name: str = POP_AXIS) -> int:
    """Round a population size up to a multiple of the mesh axis so every
    rank gets an equal block (CMA-ES accepts any lambda; the extra samples
    are real candidates and only add selection pressure)."""
    if mesh is None:
        return num_samples
    n_dev = mesh.shape[axis_name]
    return ((num_samples + n_dev - 1) // n_dev) * n_dev
