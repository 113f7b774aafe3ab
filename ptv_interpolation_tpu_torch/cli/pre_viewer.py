"""Interactive mask/points alignment pre-viewer.

Counterpart of ``ptv_interpolation_tpu/cli/pre_viewer.py`` (the
reference's `pre_viewer.py:7-205` and its launcher `run_pre_viewer.py:20-71`):
a mask slice with the point cloud overlaid, live X/Y/Z offset sliders and
plane selection, to check an alignment offset before interpolation. The
launcher mode auto-aligns on a sample first and seeds the sliders with
the result. Host numpy and matplotlib; matplotlib is imported only when a
viewer is built.
"""

from __future__ import annotations

import argparse

import numpy as np


class PreViewer:
    """Mask slice + scatter overlay with live offset sliders."""

    PLANES = ("XY", "XZ", "YZ")

    def __init__(self, cloud, fluid_mask, offset=(0.0, 0.0, 0.0)):
        import matplotlib.pyplot as plt
        from matplotlib.widgets import RadioButtons, Slider

        self.points = np.asarray(cloud.points, np.float64)
        self.mask = np.asarray(fluid_mask, bool)
        self.offset = list(offset)
        self.plane = "XY"
        nz, ny, nx = self.mask.shape
        self.slice_idx = {"XY": nz // 2, "XZ": ny // 2, "YZ": nx // 2}

        self.fig = plt.figure(figsize=(10, 8))
        self.ax = self.fig.add_axes([0.25, 0.32, 0.70, 0.60])
        ax_radio = self.fig.add_axes([0.03, 0.70, 0.12, 0.18])
        self.radio = RadioButtons(ax_radio, self.PLANES)
        self.radio.on_clicked(self._on_plane)

        span = max(nx, ny, nz)
        self.sliders = {}
        for i, axis in enumerate("xyz"):
            ax_s = self.fig.add_axes([0.25, 0.20 - 0.05 * i, 0.60, 0.03])
            s = Slider(ax_s, f"{axis.upper()} offset", -span, span,
                       valinit=self.offset[i], valstep=1)
            s.on_changed(self._on_offset)
            self.sliders[axis] = s
        ax_slice = self.fig.add_axes([0.25, 0.05, 0.60, 0.03])
        self.s_slice = Slider(ax_slice, "Slice", 0, self._n_slices() - 1,
                              valinit=self.slice_idx[self.plane], valstep=1)
        self.s_slice.on_changed(self._on_slice)
        self.redraw()

    def _n_slices(self):
        nz, ny, nx = self.mask.shape
        return {"XY": nz, "XZ": ny, "YZ": nx}[self.plane]

    def _on_plane(self, label):
        self.plane = label
        self.s_slice.valmax = self._n_slices() - 1
        self.s_slice.ax.set_xlim(0, self.s_slice.valmax)
        self.s_slice.set_val(min(self.slice_idx[label], self.s_slice.valmax))

    def _on_offset(self, _val):
        self.offset = [self.sliders[a].val for a in "xyz"]
        self.redraw()

    def _on_slice(self, val):
        self.slice_idx[self.plane] = int(val)
        self.redraw()

    def shifted_points(self):
        return self.points + np.asarray(self.offset)

    def slice_selection(self, tol=1.0):
        """Points within ``tol`` of the current slice + the mask slice —
        exposed for tests."""
        pts = self.shifted_points()
        idx = self.slice_idx[self.plane]
        if self.plane == "XY":
            sel = np.abs(pts[:, 2] - idx) < tol
            m = self.mask[idx, :, :]
            h, v = pts[sel, 0], pts[sel, 1]
        elif self.plane == "XZ":
            sel = np.abs(pts[:, 1] - idx) < tol
            m = self.mask[:, idx, :]
            h, v = pts[sel, 0], pts[sel, 2]
        else:
            sel = np.abs(pts[:, 0] - idx) < tol
            m = self.mask[:, :, idx]
            h, v = pts[sel, 1], pts[sel, 2]
        return m, h, v

    def redraw(self):
        m, h, v = self.slice_selection()
        self.ax.clear()
        self.ax.imshow(m, origin="lower", cmap="gray")
        self.ax.scatter(h, v, s=4, c="red", alpha=0.7)
        self.ax.set_title(f"{self.plane} slice {self.slice_idx[self.plane]} — "
                          f"offset {tuple(round(o, 1) for o in self.offset)} "
                          f"({len(h)} points in slice)")
        self.fig.canvas.draw_idle()

    def show(self):
        import matplotlib.pyplot as plt
        plt.show()


def main(argv=None):
    p = argparse.ArgumentParser(
        description="Interactively verify PTV/mask alignment.")
    p.add_argument("--input", "-i", required=True, help="Input CSV file")
    p.add_argument("--mask", "-m", required=True, help="Mask TIFF")
    p.add_argument("--invert-mask", action="store_true")
    p.add_argument("--offset", type=float, nargs=3, default=[0, 0, 0],
                   help="Initial offset (x y z)")
    p.add_argument("--auto-align", action="store_true",
                   help="Run auto-alignment on a sample first "
                        "(the run_pre_viewer.py launcher behavior)")
    p.add_argument("--sample", type=int, default=2000)
    p.add_argument("--swap-xy", action="store_true")
    args = p.parse_args(argv)

    from ptv_interpolation_tpu_torch.io import load_mask, load_ptv_data
    cloud = load_ptv_data(args.input)
    if args.swap_xy:
        cloud = cloud.swap_xy()
    mask = np.asarray(load_mask(args.mask))
    if args.invert_mask:
        mask = ~mask

    offset = list(args.offset)
    if args.auto_align:
        from ptv_interpolation_tpu_torch.align import find_best_offset
        sample = cloud
        if len(cloud) > args.sample:
            rng = np.random.default_rng(0)
            sample = cloud.select(rng.choice(len(cloud), args.sample,
                                             replace=False))
        best, score = find_best_offset(sample, mask, initial_offset=offset)
        print(f"Auto-align offset: {np.round(best).astype(int)} (score {score:.1f})")
        offset = list(best)

    viewer = PreViewer(cloud, mask, offset=offset)
    viewer.show()


if __name__ == "__main__":
    main()
