"""Auto-alignment CLI (reference `auto_align.py:64-108`), flag-compatible
with ``ptv_interpolation_tpu.cli.auto_align``. Host scipy only
(``align.find_best_offset``), so it takes no ``--device``."""

from __future__ import annotations

import argparse

import numpy as np

from ptv_interpolation_tpu_torch.align import find_best_offset
from ptv_interpolation_tpu_torch.io import load_mask, load_ptv_data


def main(argv=None):
    p = argparse.ArgumentParser(
        description="Find best alignment offset between PTV points and mask.")
    p.add_argument("--input", "-i", required=True, help="Input CSV file")
    p.add_argument("--mask", "-m", required=True, help="Input Mask TIFF")
    p.add_argument("--invert-mask", action="store_true", help="Invert mask")
    p.add_argument("--initial", type=int, nargs=3, default=[0, 0, 0],
                   help="Initial guess (x y z)")
    p.add_argument("--sample", type=int, default=5000,
                   help="Number of points to sample for speed")
    p.add_argument("--swap-xy", action="store_true")
    p.add_argument("--mask-transpose", type=int, nargs=3,
                   help="Transpose mask axes: e.g., 2 1 0")
    args = p.parse_args(argv)

    print("Loading data...")
    cloud = load_ptv_data(args.input)
    if args.swap_xy:
        print("Swapping X and Y coordinates...")
        cloud = cloud.swap_xy()
    if len(cloud) > args.sample:
        print(f"Sampling {args.sample} points for faster optimization...")
        rng = np.random.default_rng(0)
        cloud = cloud.select(rng.choice(len(cloud), args.sample, replace=False))

    print("Loading mask...")
    mask = np.asarray(load_mask(args.mask))
    if args.mask_transpose:
        print(f"Transposing mask with axes {args.mask_transpose}...")
        mask = np.transpose(mask, axes=args.mask_transpose)

    best_offset, score = find_best_offset(cloud, mask,
                                          initial_offset=args.initial,
                                          invert=args.invert_mask)
    print("\n" + "=" * 30)
    print("OPTIMIZATION COMPLETE")
    print("=" * 30)
    print(f"Best Offset (x, y, z): {best_offset}")
    print(f"Rounded Offset: {np.round(best_offset).astype(int)}")
    print(f"Final Score (Sum of distances): {score:.2f}")
    print("=" * 30)
    print("\nYou can now copy these values into your run scripts.")
    return best_offset, score


if __name__ == "__main__":
    main()
