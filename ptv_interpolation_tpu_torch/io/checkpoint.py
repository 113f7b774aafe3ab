"""Checkpoint / resume of field results with ``torch.save``.

Counterpart of ``ptv_interpolation_tpu/io/checkpoint.py``, whose orbax
checkpoints keep device shardings. Here a checkpoint is one file holding a
dict of CPU tensors with the keys of the JAX package's tree — ``x``,
``y``, ``z``, ``u``, ``v``, ``w``, ``mask`` and ``u_init``, ``v_init``,
``w_init`` when the result holds them — read back with
``torch.load(weights_only=True)``. Given a mesh, :func:`load_checkpoint`
puts each rank's z-slab of the 3D fields on its device, the counterpart
of restoring onto a mesh sharding. The NPZ contract (``io/npz.py``) stays
the portable artifact between the two pipelines.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ptv_interpolation_tpu_torch.device import resolve_device
from ptv_interpolation_tpu_torch.io.npz import FieldResult

_FIELDS = ("u", "v", "w", "mask", "u_init", "v_init", "w_init")


def _cpu_tensor(a) -> torch.Tensor:
    if torch.is_tensor(a):
        return a.detach().cpu()
    return torch.as_tensor(np.asarray(a))


def save_checkpoint(path: str, result: FieldResult):
    """Write a FieldResult (numpy arrays or tensors on any device) to
    ``path`` as a dict of CPU tensors."""
    tree = {name: _cpu_tensor(getattr(result, name))
            for name in ("x", "y", "z", "u", "v", "w")}
    if result.mask is not None:
        tree["mask"] = _cpu_tensor(result.mask)
    if result.has_dual:
        tree.update(u_init=_cpu_tensor(result.u_init),
                    v_init=_cpu_tensor(result.v_init),
                    w_init=_cpu_tensor(result.w_init))
    torch.save(tree, os.path.abspath(path))


def load_checkpoint(path: str, device="cuda", mesh=None) -> FieldResult:
    """Load a checkpoint: the 3D fields as tensors on ``device`` or, given
    a mesh (``parallel.make_mesh``), this rank's z-slab of each on the
    mesh's device (``parallel.shard_fields``: equal slabs, the last padded
    with zero planes); the 1D axes ``x``, ``y``, ``z`` whole, as numpy
    arrays."""
    tree = torch.load(os.path.abspath(path), map_location="cpu",
                      weights_only=True)
    if mesh is None:
        dev = resolve_device(device)
        place = lambda t: t.to(dev)  # noqa: E731
    else:
        from ptv_interpolation_tpu_torch.parallel.mesh import shard_fields
        place = lambda t: shard_fields(mesh, t)  # noqa: E731
    fields = {name: place(tree[name]) for name in _FIELDS if name in tree}
    return FieldResult(x=tree["x"].numpy(), y=tree["y"].numpy(),
                       z=tree["z"].numpy(), **fields)
