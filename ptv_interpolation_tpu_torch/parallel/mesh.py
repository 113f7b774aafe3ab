"""Process-group construction: one process per GPU over ``torch.distributed``.

Counterpart of ``ptv_interpolation_tpu/parallel/mesh.py``. The JAX package
drives every device of a 1D mesh from one process; here every rank is a
process of its own that calls the same functions with the same arguments
(SPMD), and a :class:`Mesh` names the group, this rank and its device.
Grid queries and z-slabs of fields are cut along the mesh's one axis
(``DATA_AXIS``); the at-scale grid path also cuts the cell-sorted particle
store by z-slab ownership (``parallel/slab_store.py``).

Collectives go through NCCL when every rank of a host has a GPU of its
own, and through gloo on the CPU or when ranks share a GPU (NCCL refuses
two ranks on one device). Gloo is not relied on for CUDA tensors: the
gathers of ``parallel/sharding.py`` stage their buffers through host
memory there (:func:`all_gather_cat`).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from ptv_interpolation_tpu_torch.device import resolve_device

DATA_AXIS = "data"

# the variables torchrun (and torch.distributed's env:// rendezvous) set
_ENV_HINTS = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")


def _local_world_size(world_size: int) -> int:
    return int(os.environ.get("LOCAL_WORLD_SIZE", world_size))


def _pick_backend(device, world_size: int) -> str:
    """NCCL when ``device`` is a GPU and every rank of this host has one
    of its own; gloo otherwise."""
    dev = torch.device(device)
    if (dev.type == "cuda" and dist.is_nccl_available()
            and _local_world_size(world_size) <= torch.cuda.device_count()):
        return "nccl"
    return "gloo"


def initialize_distributed(coordinator_address: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None,
                           device="cuda") -> bool:
    """Join the process group: ``torch.distributed.init_process_group``
    driven by arguments or by the environment ``torchrun`` sets (``RANK``,
    ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``).

    ``coordinator_address`` is an ``init_method`` URL
    (``tcp://host:port``, ``file:///path``) or a bare ``host:port``, read
    as TCP; ``num_processes`` and ``process_id`` are the world size and
    this rank. The backend is NCCL when ``device`` is a GPU and every rank
    of this host has one of its own (``LOCAL_WORLD_SIZE`` ≤ the GPU count),
    else gloo.

    On a GPU the rank's card (:func:`make_mesh`'s choice) becomes the
    process's current CUDA device. Call once per process, before
    :func:`make_mesh`. Returns True if the group was set up here, False if
    it already was or this is a plainly single process (no arguments, no
    ``torchrun`` environment): then nothing is done, as in the JAX
    package."""
    if dist.is_initialized():
        return False
    env_hints = any(k in os.environ for k in _ENV_HINTS)
    if coordinator_address is None and num_processes is None and not env_hints:
        return False
    world = int(num_processes if num_processes is not None
                else os.environ.get("WORLD_SIZE", 1))
    rank = int(process_id if process_id is not None
               else os.environ.get("RANK", 0))
    backend = _pick_backend(device, world)
    kwargs = {}
    if coordinator_address is not None:
        kwargs["init_method"] = (coordinator_address
                                 if "://" in coordinator_address
                                 else f"tcp://{coordinator_address}")
    if num_processes is not None:
        kwargs["world_size"] = int(num_processes)
    if process_id is not None:
        kwargs["rank"] = int(process_id)
    if torch.device(device).type == "cuda":
        # the rank's card becomes the process's current device, so that
        # synchronisations and memory statistics without a device argument
        # see it; NCCL binds its communicator to it
        dev = _rank_device(device, rank)
        torch.cuda.set_device(dev)
        if backend == "nccl":
            kwargs["device_id"] = dev
    dist.init_process_group(backend, **kwargs)
    return True


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A 1D mesh of ranks: the process group (None for a single process),
    this rank, the number of ranks and this rank's device."""

    group: Optional[dist.ProcessGroup]
    rank: int
    size: int
    device: torch.device
    axis_name: str = DATA_AXIS

    @property
    def backend(self) -> Optional[str]:
        return None if self.group is None else dist.get_backend(self.group)

    @property
    def stages_through_host(self) -> bool:
        """Gloo with GPU tensors: collectives take host copies."""
        return self.backend == "gloo" and self.device.type == "cuda"


def _rank_device(device, rank: int) -> torch.device:
    dev = resolve_device(device)
    if dev.type == "cpu" or dev.index is not None:
        return dev
    local = int(os.environ.get("LOCAL_RANK", rank))
    return torch.device("cuda", local % torch.cuda.device_count())


def make_mesh(n_devices: Optional[int] = None, axis_name: str = DATA_AXIS,
              device="cuda") -> Optional[Mesh]:
    """A 1D mesh over the first ``n_devices`` ranks of the job (all of
    them by default); a one-rank mesh when no process group is set up.

    Every rank of the job calls it alike. With ``n_devices`` below the
    world size it sets up a subgroup of ranks ``0 … n_devices−1`` (a
    collective over the whole job) and returns None on the other ranks.
    The rank's device is ``cuda:{LOCAL_RANK % device_count}`` (``LOCAL_RANK``
    defaults to the rank) unless ``device`` names an index or the CPU."""
    if not dist.is_initialized():
        if n_devices not in (None, 1):
            raise ValueError(f"n_devices={n_devices} without a process group: "
                             f"call initialize_distributed first")
        return Mesh(None, 0, 1, _rank_device(device, 0), axis_name)
    world = dist.get_world_size()
    n = world if n_devices is None else int(n_devices)
    if not 1 <= n <= world:
        raise ValueError(f"n_devices={n} outside 1..{world} ranks")
    rank = dist.get_rank()
    group = (dist.group.WORLD if n == world
             else dist.new_group(ranks=list(range(n))))
    if rank >= n:
        return None
    return Mesh(group, rank, n, _rank_device(device, rank), axis_name)


def all_gather_cat(mesh: Mesh, t: torch.Tensor) -> torch.Tensor:
    """Every rank's ``t`` (one shape on all ranks) concatenated along dim 0
    in rank order, on every rank. Under gloo GPU tensors are staged
    through host memory: gloo's CUDA collectives are not relied on."""
    if mesh.size == 1:
        return t
    src = t.cpu() if mesh.stages_through_host else t
    parts = [torch.empty_like(src) for _ in range(mesh.size)]
    dist.all_gather(parts, src.contiguous(), group=mesh.group)
    return torch.cat(parts).to(t.device)


@dataclasses.dataclass(frozen=True)
class Sharding:
    """How an array lies on a mesh: replicated (``axis_name`` None) or
    with its leading dimension cut into equal row blocks, one per rank
    (the last padded with zeros)."""

    mesh: Mesh
    axis_name: Optional[str] = None

    def shard(self, x) -> torch.Tensor:
        """This rank's part of ``x`` (numpy array or tensor, whole on every
        rank) on the mesh's device, in ``x``'s dtype."""
        t = x if torch.is_tensor(x) else torch.as_tensor(np.asarray(x))
        if self.axis_name is None:
            return t.to(self.mesh.device)
        n = t.shape[0]
        rows = -(-n // self.mesh.size)
        lo = min(self.mesh.rank * rows, n)
        part = t[lo:lo + rows].to(self.mesh.device)
        if part.shape[0] < rows:
            pad = part.new_zeros((rows - part.shape[0],) + tuple(t.shape[1:]))
            part = torch.cat([part, pad])
        return part


def replicated(mesh: Mesh) -> Sharding:
    return Sharding(mesh, None)


def row_sharded(mesh: Mesh, axis_name: str = DATA_AXIS) -> Sharding:
    """Shard the leading dimension (query rows / z-slabs) over the mesh."""
    return Sharding(mesh, axis_name)


def shard_fields(mesh: Mesh, *fields, axis_name: str = DATA_AXIS):
    """This rank's z-slab of each (nz, ny, nx) field on its device: equal
    slabs of ``ceil(nz / size)`` planes, the last padded with zero planes
    (False for a mask). Returns one tensor for one field, else a tuple."""
    sharding = row_sharded(mesh, axis_name)
    out = tuple(sharding.shard(f) for f in fields)
    return out if len(out) > 1 else out[0]
