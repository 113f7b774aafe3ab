"""The upstream's sibson weighting (``interpolator.py:83-124``) in plain
PyTorch: the k nearest points weighted by inverse distance times
``exp(-d / std(d))``, normalised. Computed in the dtype of its inputs."""

from __future__ import annotations

import torch

from perfbench.reference.knn import knn

EPS = 1e-10
CHUNK = 1 << 20          # queries per pass, so that (Q, k, C) stays small


def sibson(points, values, queries, k, cell):
    """Values (Q, C) at ``queries`` (Q, 3) from ``points`` (N, 3) carrying
    ``values`` (N, C), all of one dtype and device."""
    out = torch.empty((queries.shape[0], values.shape[1]),
                      dtype=values.dtype, device=values.device)
    for q0 in range(0, queries.shape[0], CHUNK):
        d2, idx, _ = knn(points, queries[q0:q0 + CHUNK], k, cell)
        dist = d2.sqrt()
        inv = 1.0 / (dist + EPS)
        w = inv / inv.sum(dim=1, keepdim=True)
        std = dist.std(dim=1, correction=0, keepdim=True)
        w = w * torch.exp(-dist / (std + EPS))
        w = w / w.sum(dim=1, keepdim=True)
        out[q0:q0 + CHUNK] = torch.einsum("qk,qkc->qc", w, values[idx])
    return out
