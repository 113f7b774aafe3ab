#!/usr/bin/env python
"""Count, per node of the one-phase kernel's headline blocks, the slots a
shortlist written after h halvings would have to hold.

Usage, from the repository root on a machine with an NVIDIA GPU::

    python tools/measure_pallas_list_counts.py [--blocks 128] [--seed 3]

It builds the inputs of ``backend='pallas'`` for the headline problem
(``bench.make_problem``: 1M points → 256³, k = 50, block (2, 8, 8)) with
the port's ``_pallas_setup``, takes half of the blocks from the middle of
the grid and half at random, forms d² and the halvings as
``_pallas_eval_plain`` does, and prints, for h = 4, 8, 10, 12 and 14, the
median / p99 / max over the nodes of #{d² ≤ hi} and of the open slots
(lo < d² ≤ hi), with the panel's real slots and the starting hi. These
counts size the kernel's shortlist (``_LIST_AFTER`` and ``_LIST_SLACK`` in
``ptv_interpolation_tpu_torch/ops/pallas_grid_knn.py``).
"""

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

BLOCK = (2, 8, 8)
REPORT = (4, 8, 10, 12, 14)


def _stats(x):
    x = x.double().flatten()
    return (f"{float(x.median()):.0f} / {float(x.quantile(0.99)):.0f} / "
            f"{float(x.max()):.0f}")


def main(n_blocks, seed):
    import torch
    from bench import GRID_N, K, make_problem
    from ptv_interpolation_tpu_torch.grid import create_grid
    from ptv_interpolation_tpu_torch.ops import pallas_grid_knn as pg
    from ptv_interpolation_tpu_torch.ops.grid_knn import _block_queries

    if not torch.cuda.is_available():
        raise SystemExit("needs an NVIDIA GPU: the headline setup is too "
                         "large for a CPU run")
    dev = torch.device("cuda")
    pts, vals = make_problem()
    grid = create_grid(((0, GRID_N + 1),) * 3, GRID_N)
    starts, axes, store, dims, L = pg._pallas_setup(pts, vals, grid, K,
                                                    BLOCK, 1.45, dev)
    n, R = starts.shape
    rng = np.random.default_rng(seed)
    half = n_blocks // 2
    ids = np.concatenate([np.arange(n // 2, n // 2 + half),
                          rng.choice(n, n_blocks - half, replace=False)])
    ids = torch.as_tensor(ids, device=dev)
    qx, qy, qz, _ = _block_queries(axes, BLOCK, dims[1], dims[2], ids)
    cols = (((starts[ids].long() // 128) * 128)[:, :, None]
            + torch.arange(L, device=dev)).reshape(len(ids), R * L)
    c = store[:3, cols]                                      # (3, g, C)
    d = qx[:, :, None] - c[0][:, None, :]
    d2 = d * d
    d = qy[:, :, None] - c[1][:, None, :]
    d2 = d2 + d * d
    d = qz[:, :, None] - c[2][:, None, :]
    d2 = d2 + d * d                                          # (g, B, C)
    del d
    real = (c[0] < pg._BIG * 0.5).sum(dim=1)
    hi = (torch.where(d2 < pg._BIG * 0.5, d2, torch.zeros((), device=dev))
          .amax(dim=-1, keepdim=True) * (1.0 + 1e-6) + 1e-30)
    lo = torch.zeros_like(hi)
    print(f"{n_blocks} of {n} headline blocks (seed {seed}), C = R·L = "
          f"{R} × {L} = {R * L} slots, k = {K}; real slots per block: mean "
          f"{float(real.double().mean()):.0f}, min {int(real.min())}, max "
          f"{int(real.max())}; median hi at the start "
          f"{float(hi.median()):.0f}")
    print("halvings | #{d² ≤ hi} median / p99 / max | open (lo < d² ≤ hi) "
          "median / p99 / max")
    for h in range(1, max(REPORT) + 1):
        mid = 0.5 * (lo + hi)
        ge = (d2 <= mid).sum(dim=-1, keepdim=True) >= K
        hi = torch.where(ge, mid, hi)
        lo = torch.where(ge, lo, mid)
        if h in REPORT:
            n_le = (d2 <= hi).sum(dim=-1)
            n_open = ((d2 > lo) & (d2 <= hi)).sum(dim=-1)
            print(f"{h} | {_stats(n_le)} | {_stats(n_open)}")


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--blocks", type=int, default=128)
    ap.add_argument("--seed", type=int, default=3)
    args = ap.parse_args()
    main(args.blocks, args.seed)
