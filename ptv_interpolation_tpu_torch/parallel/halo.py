"""Z-slab plans, halo exchanges and reductions for the z-sharded solves.

In the JAX package the cleaning functions run unchanged on z-sharded
arrays: GSPMD inserts the halo exchanges of the stencils and turns the CG
dots into ``psum``s (``ptv_interpolation_tpu/parallel/sharding.py``). Here
each exchange is written out. A rank owns the planes ``[z0, z1)`` of the
true global grid (:func:`z_slab_plan`; no padded planes, so the multigrid
level plan and the domain-edge terms stay the one-device ones), and every
operator that reads z ± 1 runs by one rule: extend the slab by a halo,
apply the unchanged one-device operator, crop the halo planes. A rank
extends only toward its neighbours, so the domain-edge Neumann terms land
on the first rank's plane 0 and the last rank's plane nz − 1, and at slab
faces they fall on halo planes, which are cropped.

Collectives: point-to-point sends to rank ± 1 for halos (NCCL, or gloo —
CUDA tensors under gloo are staged through host memory, as
:func:`parallel.mesh.all_gather_cat` does), and an all-gather for sums and
for joining slabs.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch
import torch.distributed as dist

from ptv_interpolation_tpu_torch.parallel.mesh import Mesh, all_gather_cat

Bounds = Tuple[Tuple[int, int], ...]


def z_slab_plan(nz: int, mesh: Mesh, align: int = 1) -> Bounds:
    """Every rank's owned planes ``(z0, z1)`` of ``nz`` planes: units of
    ``align`` planes dealt out evenly, the spare units to the first ranks,
    so every boundary is a multiple of ``align`` and the last slab, whose
    last unit ends at ``nz``, is the short one. Raises when a rank would
    get no plane."""
    units = -(-nz // align)
    base, extra = divmod(units, mesh.size)
    if base == 0:
        raise ValueError(f"{nz} planes in units of {align} are too few for "
                         f"{mesh.size} ranks")
    bounds, u0 = [], 0
    for r in range(mesh.size):
        u1 = u0 + base + (r < extra)
        bounds.append((u0 * align, min(u1 * align, nz)))
        u0 = u1
    return tuple(bounds)


def mg_slab_plan(nz: int, mesh: Mesh, n_levels: int, unit: int = 1):
    """``(bounds, n_sharded)`` for a multigrid of ``n_levels`` levels over
    ``nz`` planes, each of the multigrid's finest planes ``unit`` planes of
    the plan (2 for the variational cleaner's parity sublattices).

    The first ``n_sharded`` levels run on z-slabs and the rest whole on
    every rank. Restriction and prolongation stay local when every
    boundary is a multiple of ``2**(n_sharded − 1)`` multigrid planes, so
    ``n_sharded`` is the most levels for which that alignment still leaves
    every rank at least 2 planes on its last sharded level."""
    for n_sharded in range(n_levels, 0, -1):
        align = unit << (n_sharded - 1)
        if -(-nz // align) // mesh.size >= 2:
            return z_slab_plan(nz, mesh, align), n_sharded
    raise ValueError(f"{nz} planes are too few for {mesh.size} ranks: each "
                     f"needs at least {2 * unit}")


def halo_exchange(mesh: Mesh, x: torch.Tensor, width: int = 1) -> torch.Tensor:
    """This rank's slab ``x`` (…, planes, ny, nx) extended along z by
    ``width`` planes from each neighbour (rank ± 1), on the sides that
    have one. Every neighbour's slab must hold ``width`` planes."""
    if mesh.size == 1:
        return x
    host = mesh.stages_through_host
    ops, recv = [], {}
    for side, peer, plane in (("lo", mesh.rank - 1, 0),
                              ("hi", mesh.rank + 1, x.shape[-3] - width)):
        if not 0 <= peer < mesh.size:
            continue
        send = x.narrow(-3, plane, width).contiguous()
        if host:
            send = send.cpu()
        recv[side] = torch.empty_like(send)
        peer = dist.get_global_rank(mesh.group, peer)
        ops += [dist.P2POp(dist.isend, send, peer, mesh.group),
                dist.P2POp(dist.irecv, recv[side], peer, mesh.group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    parts = ([recv["lo"].to(x.device)] if "lo" in recv else []) + [x] + (
        [recv["hi"].to(x.device)] if "hi" in recv else [])
    return torch.cat(parts, -3)


def allreduce_sum(mesh: Mesh, t: torch.Tensor) -> torch.Tensor:
    """Σ over ranks of ``t`` (this rank's partial sums, any shape). The
    partials are all-gathered and summed in rank order on every rank, so
    every rank holds the same bits whatever the backend's reduction order:
    the CG loops branch on these values, and ranks that disagreed would
    leave the loop at different iterations."""
    if mesh.size == 1:
        return t
    return all_gather_cat(mesh, t[None]).sum(0)


@dataclasses.dataclass(frozen=True)
class ZSlabs:
    """Every rank's owned z-planes of a grid (:func:`z_slab_plan`) and the
    operations a solve runs on this rank's slab. Arrays are (…, nz, ny, nx):
    z is the third axis from the end, so a leading batch axis (the parity
    sublattices) rides along."""

    mesh: Mesh
    bounds: Bounds

    @property
    def z0(self) -> int:
        return self.bounds[self.mesh.rank][0]

    @property
    def z1(self) -> int:
        return self.bounds[self.mesh.rank][1]

    def _sides(self, width):
        """The halo planes below and above the slab: ``width`` toward each
        neighbour, 0 at a domain edge."""
        rank = self.mesh.rank
        return (width if rank > 0 else 0,
                width if rank < self.mesh.size - 1 else 0)

    def take(self, whole, width: int = 0, dtype=None) -> torch.Tensor:
        """This rank's slab of ``whole`` (a numpy array or tensor whole on
        every rank), extended by ``width`` planes toward each neighbour,
        on the mesh's device: a halo taken without communication."""
        lo, hi = self._sides(width)
        t = torch.as_tensor(whole).narrow(-3, self.z0 - lo,
                                          self.z1 - self.z0 + lo + hi)
        return t.to(device=self.mesh.device, dtype=dtype).contiguous()

    def extend(self, x: torch.Tensor, width: int = 1) -> torch.Tensor:
        """The slab ``x`` with ``width`` halo planes from each neighbour."""
        return halo_exchange(self.mesh, x, width)

    def pad(self, x: torch.Tensor, width: int = 1) -> torch.Tensor:
        """The slab ``x`` with ``width`` zero planes toward each neighbour:
        the halo of an operand that the operator reads only in its own
        plane."""
        lo, hi = self._sides(width)
        if not lo + hi:
            return x
        return torch.cat([x.new_zeros(x.shape[:-3] + (lo,) + x.shape[-2:]), x,
                          x.new_zeros(x.shape[:-3] + (hi,) + x.shape[-2:])],
                         -3)

    def crop(self, x: torch.Tensor, width: int = 1) -> torch.Tensor:
        """``x`` without its ``width`` halo planes on each neighbour side."""
        lo, hi = self._sides(width)
        return x.narrow(-3, lo, x.shape[-3] - lo - hi)

    def sum(self, x: torch.Tensor) -> torch.Tensor:
        """Σ of ``x`` over every rank's slab (:func:`allreduce_sum`)."""
        return allreduce_sum(self.mesh, x.sum())

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        """The whole array from every rank's slab ``x``, on every rank: one
        all-gather of the slabs, each padded to the thickest."""
        if self.mesh.size == 1:
            return x
        rows = max(z1 - z0 for z0, z1 in self.bounds)
        zf = x.movedim(-3, 0)
        if zf.shape[0] < rows:
            zf = torch.cat([zf, zf.new_zeros((rows - zf.shape[0],)
                                             + zf.shape[1:])])
        parts = all_gather_cat(self.mesh, zf.contiguous()).split(rows)
        whole = torch.cat([p[:z1 - z0] for p, (z0, z1)
                           in zip(parts, self.bounds)])
        return whole.movedim(0, -3)

    def coarsen(self) -> "ZSlabs":
        """The slabs of the grid coarsened by 2 along z (each ``z0`` even):
        the next multigrid level, or the parity sublattices' planes."""
        return ZSlabs(self.mesh, tuple((z0 // 2, -(-z1 // 2))
                                       for z0, z1 in self.bounds))
