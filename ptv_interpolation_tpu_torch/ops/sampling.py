"""Point sampling of gridded fields (``map_coordinates`` equivalents).

Counterpart of ``ptv_interpolation_tpu/ops/sampling.py``: orders 0 and 1
as ``jax.scipy.ndimage.map_coordinates`` with ``mode="nearest"`` computes
them, and order 3 as the JAX package's Catmull-Rom tricubic. Every order
indexes the volume directly in scipy's convention (voxel ``i`` at
coordinate ``i``) and clamps each tap index at the edges; ``grid_sample``
is not used, since its ``align_corners`` and padding rules are not that
convention.

The JAX package packs the four x-taps of a sample into a 4× store to work
around a TPU gather limit; here the 64 taps are gathered straight from the
volume, which gives the same values. Runs where ``volume`` is.
"""

from __future__ import annotations

import torch


def map_coordinates(volume, coords, order: int = 1):
    """Sample ``volume`` (nz, ny, nx) at ``coords`` (3, Q) index coordinates
    (z, y, x rows, scipy convention), clamped at edges.

    order 0 → nearest (half away from zero, as JAX rounds), 1 → trilinear,
    3 → Catmull-Rom tricubic. Returns a (Q,) float32 tensor.
    """
    volume = torch.as_tensor(volume, dtype=torch.float32)
    coords = torch.as_tensor(coords, dtype=torch.float32,
                             device=volume.device)
    if order == 0:
        return _nearest(volume, coords)
    if order == 1:
        return _trilinear(volume, coords)
    if order == 3:
        return _catmull_rom_3d(volume, coords)
    raise NotImplementedError(f"order {order} not supported")


def _flat_index(shape, iz, iy, ix):
    _, ny, nx = shape
    return (iz * ny + iy) * nx + ix


def _round_half_away_from_zero(c):
    """``lax.round``'s default: ties go away from zero (``torch.round``
    rounds them to even). ``c − trunc(c)`` is exact in f32."""
    t = torch.trunc(c)
    return t + torch.where((c - t).abs() >= 0.5, torch.sign(c), 0.0)


def _nearest(volume, coords):
    idx = [_round_half_away_from_zero(coords[a]).long().clamp(0, n - 1)
           for a, n in enumerate(volume.shape)]
    return volume.reshape(-1)[_flat_index(volume.shape, *idx)]


def _trilinear(volume, coords):
    """JAX's order-1 sum: the 8 corners in (z, y, x) product order, each
    ``((wz·wy)·wx)·value``, added left to right."""
    taps = []
    for a, n in enumerate(volume.shape):
        lower = torch.floor(coords[a])
        w_hi = coords[a] - lower
        lo = lower.long()
        taps.append(((lo.clamp(0, n - 1), 1 - w_hi),
                     ((lo + 1).clamp(0, n - 1), w_hi)))
    flat = volume.reshape(-1)
    out = None
    for iz, wz in taps[0]:
        for iy, wy in taps[1]:
            for ix, wx in taps[2]:
                term = wz * wy * wx * flat[_flat_index(volume.shape,
                                                       iz, iy, ix)]
                out = term if out is None else out + term
    return out


def _cr_weights(t):
    """Catmull-Rom basis weights for offsets (-1, 0, 1, 2): (4, Q)."""
    t2 = t * t
    t3 = t2 * t
    w0 = 0.5 * (-t3 + 2 * t2 - t)
    w1 = 0.5 * (3 * t3 - 5 * t2 + 2)
    w2 = 0.5 * (-3 * t3 + 4 * t2 + t)
    w3 = 0.5 * (t3 - t2)
    return torch.stack([w0, w1, w2, w3], dim=0)


def _catmull_rom_3d(volume, coords):
    """Tricubic Catmull-Rom: tap ``i`` of an axis reads
    ``clip(floor(c) + i − 1, 0, n − 1)``; per (z, y) tap the four x-taps
    are one (4, Q) gather, weighted and summed as the JAX package does."""
    nz, ny, nx = volume.shape
    base = torch.floor(coords)
    t = coords - base
    base = base.long()
    wz, wy, wx = _cr_weights(t[0]), _cr_weights(t[1]), _cr_weights(t[2])
    offs = torch.arange(-1, 3, device=volume.device)[:, None]
    x_idx = (base[2][None] + offs).clamp(0, nx - 1)          # (4, Q)
    flat = volume.reshape(-1)
    out = torch.zeros(coords.shape[1], dtype=torch.float32,
                      device=volume.device)
    for iz in range(4):
        z_idx = (base[0] + iz - 1).clamp(0, nz - 1)
        for iy in range(4):
            y_idx = (base[1] + iy - 1).clamp(0, ny - 1)
            rows = flat[(z_idx * ny + y_idx) * nx + x_idx]    # (4, Q)
            out = out + wz[iz] * wy[iy] * torch.sum(wx * rows, dim=0)
    return out
