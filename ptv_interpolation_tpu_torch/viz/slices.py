"""Interactive velocity-field slice viewers (matplotlib).

Capability rebuild of `visualizer.py`: plane selection
(XY/XZ/YZ), slice/vector-scale/color-limit sliders, background scalar
choice (speed/u/v/w), solid-mask overlay, grid-vector quiver, raw input
point overlay, and a cleaned/original dual-field toggle. Comparison
variants show two fields plus their difference.

These viewers are a thin host-side compatibility layer over the NPZ field
contract — nothing here touches the device.
"""

from __future__ import annotations

import numpy as np


def _speed(u, v, w):
    return np.sqrt(u ** 2 + v ** 2 + w ** 2)


def _unpack_dual(field):
    """Reference dual-field convention: a (cleaned, initial) tuple
    (`main.py:236-241`)."""
    if isinstance(field, tuple):
        return np.asarray(field[0]), np.asarray(field[1])
    return np.asarray(field), None


class SliceViewer:
    """Interactive slice viewer (reference ``SliceViewer``,
    `visualizer.py:5-287`)."""

    PLANES = ("XY", "XZ", "YZ")

    def __init__(self, u, v, w, x, y, z, mask=None, input_df=None, fig=None,
                 title="Velocity Field", quiver_step=2):
        import matplotlib.pyplot as plt
        from matplotlib.widgets import Button, RadioButtons, Slider

        self.u, self.u_init = _unpack_dual(u)
        self.v, self.v_init = _unpack_dual(v)
        self.w, self.w_init = _unpack_dual(w)
        self.has_dual = self.u_init is not None
        self.showing_init = False
        self.x, self.y, self.z = (np.asarray(a) for a in (x, y, z))
        self.mask = None if mask is None else np.asarray(mask, bool)
        self.input_points = None
        if input_df is not None:
            # accepts a PointCloud or a pandas-like with x/y/z/u/v/w
            self.input_points = (np.asarray(input_df.x), np.asarray(input_df.y),
                                 np.asarray(input_df.z), np.asarray(input_df.u),
                                 np.asarray(input_df.v), np.asarray(input_df.w))
        self.plane = "XY"
        self.background = "speed"
        self.quiver_step = quiver_step
        nz, ny, nx = self.u.shape
        self.slice_idx = {"XY": nz // 2, "XZ": ny // 2, "YZ": nx // 2}

        self.fig = fig or plt.figure(figsize=(11, 8))
        self.fig.suptitle(title)
        self.ax = self.fig.add_axes([0.30, 0.25, 0.62, 0.66])
        self.cax = self.fig.add_axes([0.93, 0.25, 0.015, 0.66])

        ax_radio = self.fig.add_axes([0.03, 0.70, 0.12, 0.18])
        self.radio = RadioButtons(ax_radio, self.PLANES)
        self.radio.on_clicked(self._on_plane)
        ax_bg = self.fig.add_axes([0.03, 0.42, 0.12, 0.22])
        self.bg_radio = RadioButtons(ax_bg, ("speed", "u", "v", "w"))
        self.bg_radio.on_clicked(self._on_background)

        ax_slice = self.fig.add_axes([0.30, 0.14, 0.55, 0.03])
        self.s_slice = Slider(ax_slice, "Slice", 0, self._n_slices() - 1,
                              valinit=self.slice_idx[self.plane], valstep=1)
        self.s_slice.on_changed(self._on_slice)
        ax_scale = self.fig.add_axes([0.30, 0.09, 0.55, 0.03])
        self.s_scale = Slider(ax_scale, "Vector scale", 0.1, 10.0, valinit=1.0)
        self.s_scale.on_changed(lambda _val: self.redraw())
        vmax0 = float(np.nanmax(_speed(self.u, self.v, self.w))) or 1.0
        ax_vmin = self.fig.add_axes([0.30, 0.05, 0.25, 0.03])
        ax_vmax = self.fig.add_axes([0.60, 0.05, 0.25, 0.03])
        self.s_vmin = Slider(ax_vmin, "vmin", 0.0, vmax0, valinit=0.0)
        self.s_vmax = Slider(ax_vmax, "vmax", 1e-9, vmax0, valinit=vmax0)
        self.s_vmin.on_changed(lambda _val: self.redraw())
        self.s_vmax.on_changed(lambda _val: self.redraw())

        if self.has_dual:
            ax_btn = self.fig.add_axes([0.03, 0.30, 0.12, 0.05])
            self.toggle_btn = Button(ax_btn, "Show original")
            self.toggle_btn.on_clicked(self._on_toggle)

        self.colorbar = None
        self.redraw()

    # ------------------------------------------------------------- helpers
    def _fields(self):
        if self.showing_init and self.has_dual:
            return self.u_init, self.v_init, self.w_init
        return self.u, self.v, self.w

    def _n_slices(self):
        nz, ny, nx = self.u.shape
        return {"XY": nz, "XZ": ny, "YZ": nx}[self.plane]

    def _take(self, f, idx):
        if self.plane == "XY":
            return f[idx, :, :]
        if self.plane == "XZ":
            return f[:, idx, :]
        return f[:, :, idx]

    def _plane_axes(self):
        # returns (horizontal coords, vertical coords, labels, in-plane comps)
        if self.plane == "XY":
            return self.x, self.y, ("X", "Y"), ("u", "v")
        if self.plane == "XZ":
            return self.x, self.z, ("X", "Z"), ("u", "w")
        return self.y, self.z, ("Y", "Z"), ("v", "w")

    def slice_data(self):
        """Current background slice + in-plane vector components (used by
        tests and subclasses)."""
        u, v, w = self._fields()
        idx = self.slice_idx[self.plane]
        comp = {"speed": _speed(u, v, w), "u": u, "v": v, "w": w}[self.background]
        bg = self._take(comp, idx)
        names = {"u": u, "v": v, "w": w}
        ch, cv = self._plane_axes()[3]
        qh = self._take(names[ch], idx)
        qv = self._take(names[cv], idx)
        m = None if self.mask is None else self._take(self.mask, idx)
        return bg, qh, qv, m

    # ------------------------------------------------------------ callbacks
    def _on_plane(self, label):
        self.plane = label
        self.s_slice.valmax = self._n_slices() - 1
        self.s_slice.ax.set_xlim(0, self.s_slice.valmax)
        self.s_slice.set_val(min(self.slice_idx[self.plane],
                                 self.s_slice.valmax))

    def _on_background(self, label):
        self.background = label
        self.redraw()

    def _on_slice(self, val):
        self.slice_idx[self.plane] = int(val)
        self.redraw()

    def _on_toggle(self, _event):
        self.showing_init = not self.showing_init
        self.toggle_btn.label.set_text(
            "Show cleaned" if self.showing_init else "Show original")
        self.redraw()

    # --------------------------------------------------------------- render
    def redraw(self):
        self.ax.clear()
        bg, qh, qv, m = self.slice_data()
        hc, vc, (hl, vl), _ = self._plane_axes()
        extent = [hc[0], hc[-1], vc[0], vc[-1]]
        im = self.ax.imshow(bg, origin="lower", extent=extent, aspect="auto",
                            cmap="viridis", vmin=self.s_vmin.val,
                            vmax=max(self.s_vmax.val, self.s_vmin.val + 1e-12))
        if m is not None:
            rgba = np.zeros(m.shape + (4,))
            rgba[~m] = [0, 0, 0, 1]
            self.ax.imshow(rgba, origin="lower", extent=extent, aspect="auto")
        step = self.quiver_step
        H, V = np.meshgrid(hc, vc)
        self.ax.quiver(H[::step, ::step], V[::step, ::step],
                       qh[::step, ::step], qv[::step, ::step],
                       color="white", scale=None,
                       scale_units="xy", angles="xy",
                       width=0.002 * self.s_scale.val)
        if self.input_points is not None:
            self._overlay_points()
        label = ("original" if self.showing_init else
                 ("cleaned" if self.has_dual else "field"))
        self.ax.set_title(f"{self.plane} plane, slice "
                          f"{self.slice_idx[self.plane]} ({label})")
        self.ax.set_xlabel(hl)
        self.ax.set_ylabel(vl)
        if self.colorbar is None:
            self.colorbar = self.fig.colorbar(im, cax=self.cax,
                                              label=self.background)
        else:
            self.colorbar.update_normal(im)
        self.fig.canvas.draw_idle()

    def _overlay_points(self):
        px, py, pz, pu, pv, pw = self.input_points
        idx = self.slice_idx[self.plane]
        if self.plane == "XY":
            coord, h, v_, uh, uv = pz, px, py, pu, pv
            center = self.z[idx]
            tol = (self.z[1] - self.z[0]) if len(self.z) > 1 else 0.5
        elif self.plane == "XZ":
            coord, h, v_, uh, uv = py, px, pz, pu, pw
            center = self.y[idx]
            tol = (self.y[1] - self.y[0]) if len(self.y) > 1 else 0.5
        else:
            coord, h, v_, uh, uv = px, py, pz, pv, pw
            center = self.x[idx]
            tol = (self.x[1] - self.x[0]) if len(self.x) > 1 else 0.5
        sel = np.abs(coord - center) < tol
        if sel.any():
            self.ax.quiver(h[sel], v_[sel], uh[sel], uv[sel], color="red",
                           scale=None, scale_units="xy", angles="xy",
                           width=0.003 * self.s_scale.val, alpha=0.8)

    def show(self):
        import matplotlib.pyplot as plt
        plt.show()


class SideBySideViewer(SliceViewer):
    """Two fields side by side (reference `visualizer.py:400-511`)."""

    def __init__(self, fields_a, fields_b, x, y, z, mask=None,
                 labels=("A", "B"), fig=None, title="Comparison", **kw):
        import matplotlib.pyplot as plt
        self._b = tuple(np.asarray(f) for f in fields_b)
        self.labels = labels
        fig = fig or plt.figure(figsize=(14, 7))
        self.ax2 = None
        super().__init__(*fields_a, x, y, z, mask=mask, fig=fig, title=title,
                         **kw)

    def redraw(self):
        if self.ax2 is None:
            self.ax.set_position([0.28, 0.25, 0.32, 0.63])
            self.ax2 = self.fig.add_axes([0.62, 0.25, 0.32, 0.63])
        super().redraw()
        self.ax2.clear()
        ub, vb, wb = self._b
        idx = self.slice_idx[self.plane]
        comp = {"speed": _speed(ub, vb, wb), "u": ub, "v": vb,
                "w": wb}[self.background]
        bg = self._take(comp, idx)
        hc, vc, (hl, vl), _ = self._plane_axes()
        extent = [hc[0], hc[-1], vc[0], vc[-1]]
        self.ax2.imshow(bg, origin="lower", extent=extent, aspect="auto",
                        cmap="viridis", vmin=self.s_vmin.val,
                        vmax=max(self.s_vmax.val, self.s_vmin.val + 1e-12))
        if self.mask is not None:
            m = self._take(self.mask, idx)
            rgba = np.zeros(m.shape + (4,))
            rgba[~m] = [0, 0, 0, 1]
            self.ax2.imshow(rgba, origin="lower", extent=extent, aspect="auto")
        self.ax.set_title(self.labels[0])
        self.ax2.set_title(self.labels[1])
        self.ax2.set_xlabel(hl)


class ComparisonViewer(SideBySideViewer):
    """Field, field, and difference (reference `visualizer.py:289-398`)."""

    def __init__(self, fields_a, fields_b, *args, **kw):
        self.ax3 = None
        super().__init__(fields_a, fields_b, *args, **kw)

    def redraw(self):
        if self.ax3 is None:
            self.ax3 = self.fig.add_axes([0.62, 0.25, 0.30, 0.30])
        super().redraw()
        if self.ax2 is not None:
            self.ax.set_position([0.28, 0.25, 0.20, 0.63])
            self.ax2.set_position([0.51, 0.25, 0.20, 0.63])
            self.ax3.set_position([0.74, 0.25, 0.20, 0.63])
        self.ax3.clear()
        ua, va, wa = self._fields()
        ub, vb, wb = self._b
        idx = self.slice_idx[self.plane]
        comp_a = {"speed": _speed(ua, va, wa), "u": ua, "v": va,
                  "w": wa}[self.background]
        comp_b = {"speed": _speed(ub, vb, wb), "u": ub, "v": vb,
                  "w": wb}[self.background]
        diff = self._take(comp_a, idx) - self._take(comp_b, idx)
        hc, vc, _, _ = self._plane_axes()
        extent = [hc[0], hc[-1], vc[0], vc[-1]]
        lim = max(float(np.abs(diff).max()), 1e-12)
        self.ax3.imshow(diff, origin="lower", extent=extent, aspect="auto",
                        cmap="RdBu_r", vmin=-lim, vmax=lim)
        self.ax3.set_title("difference")


class ScalarSliceViewer(SliceViewer):
    """Single scalar field slice viewer (reference `visualizer.py:513-574`)."""

    def __init__(self, scalar, x, y, z, mask=None, field_name="Scalar",
                 cmap="viridis", **kw):
        s = np.asarray(scalar)
        self.field_name = field_name
        self.cmap = cmap
        zero = np.zeros_like(s)
        super().__init__(s, zero, zero, x, y, z, mask=mask,
                         title=field_name, **kw)
        self.background = "u"  # the scalar rides the u slot

    def slice_data(self):
        idx = self.slice_idx[self.plane]
        bg = self._take(self.u, idx)
        m = None if self.mask is None else self._take(self.mask, idx)
        return bg, np.zeros_like(bg), np.zeros_like(bg), m


class ScalarSideBySideViewer(SideBySideViewer):
    """Two scalar fields side by side (reference `visualizer.py:576-652`)."""

    def __init__(self, scalar_a, scalar_b, x, y, z, mask=None,
                 labels=("A", "B"), title="Scalar comparison", **kw):
        a = np.asarray(scalar_a)
        b = np.asarray(scalar_b)
        zero = np.zeros_like(a)
        super().__init__((a, zero, zero), (b, np.zeros_like(b),
                                           np.zeros_like(b)),
                         x, y, z, mask=mask, labels=labels, title=title, **kw)
        self.background = "u"


# ------------------------------------------------------------------ facade
# (reference `visualizer.py:654-677`)

def show(u, v, w, x, y, z, mask=None, input_df=None, fig=None, block=True):
    viewer = SliceViewer(u, v, w, x, y, z, mask=mask, input_df=input_df,
                         fig=fig)
    if block and fig is None:
        viewer.show()
    return viewer


def compare(fields_a, fields_b, x, y, z, mask=None, labels=("A", "B"),
            block=True):
    viewer = ComparisonViewer(fields_a, fields_b, x, y, z, mask=mask,
                              labels=labels)
    if block:
        viewer.show()
    return viewer


def side_by_side(fields_a, fields_b, x, y, z, mask=None, labels=("A", "B"),
                 block=True):
    viewer = SideBySideViewer(fields_a, fields_b, x, y, z, mask=mask,
                              labels=labels)
    if block:
        viewer.show()
    return viewer


def show_scalar(scalar, x, y, z, mask=None, field_name="Scalar", block=True):
    viewer = ScalarSliceViewer(scalar, x, y, z, mask=mask,
                               field_name=field_name)
    if block:
        viewer.show()
    return viewer


def compare_scalars(scalar_a, scalar_b, x, y, z, mask=None,
                    labels=("A", "B"), title="Scalar comparison", block=True):
    viewer = ScalarSideBySideViewer(scalar_a, scalar_b, x, y, z, mask=mask,
                                    labels=labels, title=title)
    if block:
        viewer.show()
    return viewer
