"""Exact k nearest neighbours in plain PyTorch, by a uniform cell grid.

Points and queries are binned into cubic cells of side ``cell``. Each
query is measured against every point of its own cell and the 26 cells
around it, and the k nearest of those are taken. The result is certified
where the k-th distance is no larger than the distance from the query to
the outside of that 3×3×3 block (a side with no cells beyond it needs no
check); every query that is not certified is measured against all points.
So the answer is the exact k nearest neighbours in the arithmetic of the
points' dtype, whatever the cell size; the cell size only sets the cost.

This file is part of the benchmark's yardstick: it imports nothing of the
program under test.
"""

from __future__ import annotations

import itertools

import torch

# one batch of cells holds at most this many candidate distances
_BUDGET = 1 << 26


def knn(points: torch.Tensor, queries: torch.Tensor, k: int, cell: float,
        budget: int = _BUDGET):
    """``(d2, idx, n_open)``: the squared distances (Q, k), ascending, the
    indices into ``points`` (Q, k) of each query's k nearest points, and
    how many queries were not certified by their block and were measured
    against all points.
    ``points`` (N, 3) and ``queries`` (Q, 3) share one dtype and device;
    the distances are computed in that dtype."""
    n, q = points.shape[0], queries.shape[0]
    if n < k:
        raise ValueError(f"{n} points cannot give {k} neighbours")
    dev, dt = points.device, points.dtype
    p64, q64 = points.double(), queries.double()
    lo = torch.minimum(p64.min(0).values, q64.min(0).values)
    pc = ((p64 - lo) / cell).floor().long()
    qc = ((q64 - lo) / cell).floor().long()
    dims = torch.maximum(pc.max(0).values, qc.max(0).values) + 1
    nx, ny, nz = (int(d) for d in dims)

    def cell_id(c):
        return (c[:, 2] * ny + c[:, 1]) * nx + c[:, 0]

    pid = cell_id(pc)
    porder = torch.argsort(pid)
    counts = torch.bincount(pid, minlength=nx * ny * nz)
    starts = torch.cumsum(counts, 0) - counts
    sorted_pts = points[porder]
    mc = int(counts.max())

    qid = cell_id(qc)
    qorder = torch.argsort(qid)
    qcells, qcounts = torch.unique_consecutive(qid[qorder],
                                               return_counts=True)
    qstarts = torch.cumsum(qcounts, 0) - qcounts
    mq = int(qcounts.max())

    offsets = torch.tensor(list(itertools.product((-1, 0, 1), repeat=3)),
                           device=dev)                      # (27, 3) dz dy dx
    n_cand = 27 * mc
    kk = min(k, n_cand)
    out_d2 = torch.full((q, k), float("inf"), dtype=dt, device=dev)
    out_idx = torch.zeros((q, k), dtype=torch.long, device=dev)
    certified = torch.zeros(q, dtype=torch.bool, device=dev)
    per_cell = mq * n_cand
    step = max(1, budget // per_cell)
    q_ar = torch.arange(mq, device=dev)
    c_ar = torch.arange(mc, device=dev)
    for b0 in range(0, len(qcells), step):
        cells = qcells[b0:b0 + step]
        nb = len(cells)
        cz = cells // (nx * ny)
        cy = (cells // nx) % ny
        cx = cells % nx
        nz_ = cz[:, None] + offsets[None, :, 0]
        ny_ = cy[:, None] + offsets[None, :, 1]
        nx_ = cx[:, None] + offsets[None, :, 2]
        inside = ((nz_ >= 0) & (nz_ < nz) & (ny_ >= 0) & (ny_ < ny)
                  & (nx_ >= 0) & (nx_ < nx))
        ncell = torch.where(inside, (nz_ * ny + ny_) * nx + nx_, 0)
        cnt = torch.where(inside, counts[ncell], 0)
        cidx = starts[ncell][:, :, None] + c_ar                 # (nb, 27, mc)
        cok = (c_ar < cnt[:, :, None]).reshape(nb, n_cand)
        cidx = torch.where(cok, cidx.reshape(nb, n_cand), 0)
        cand = sorted_pts[cidx]                                  # (nb, C, 3)

        qrow = qstarts[b0:b0 + nb, None] + q_ar                  # (nb, mq)
        qok = q_ar < qcounts[b0:b0 + nb, None]
        qsel = qorder[torch.where(qok, qrow, 0)]
        qq = queries[qsel]                                       # (nb, mq, 3)

        d2 = (qq[:, :, None, 0] - cand[:, None, :, 0]).square()
        for a in (1, 2):
            d2 += (qq[:, :, None, a] - cand[:, None, :, a]).square()
        d2.masked_fill_(~cok[:, None, :], float("inf"))
        val, pos = torch.topk(d2, kk, dim=2, largest=False, sorted=True)
        del d2
        gidx = porder[torch.gather(cidx, 1, pos.reshape(nb, -1))
                      .reshape(nb, mq, kk)]

        # the distance from each query to the outside of its 3×3×3 block,
        # in float64; a side with no cell beyond it is open
        qpos = q64[qsel]
        qcell = qc[qsel]
        low_face = lo + (qcell - 1) * cell
        high_face = lo + (qcell + 2) * cell
        inf = torch.tensor(float("inf"), dtype=torch.float64, device=dev)
        to_low = torch.where(qcell - 1 >= 0, qpos - low_face, inf)
        to_high = torch.where(qcell + 1 <= dims - 1, high_face - qpos, inf)
        margin = torch.minimum(to_low, to_high).min(dim=2).values
        if kk == k:
            kth = val[:, :, k - 1].double().sqrt()
            ok = qok & (kth <= margin)
        else:
            ok = torch.zeros_like(qok)
        rows = qsel[qok]
        out_d2[rows, :kk] = val[qok]
        out_idx[rows, :kk] = gidx[qok]
        certified[qsel[ok]] = True

    rest = torch.nonzero(~certified).squeeze(1)
    if len(rest):
        chunk = max(1, budget // n)
        for r0 in range(0, len(rest), chunk):
            rows = rest[r0:r0 + chunk]
            qq = queries[rows]
            d2 = (qq[:, None, 0] - points[None, :, 0]).square()
            for a in (1, 2):
                d2 += (qq[:, None, a] - points[None, :, a]).square()
            val, pos = torch.topk(d2, k, dim=1, largest=False, sorted=True)
            out_d2[rows] = val
            out_idx[rows] = pos
    return out_d2, out_idx, int(len(rest))
