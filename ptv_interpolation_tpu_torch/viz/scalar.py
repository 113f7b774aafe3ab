"""Tri-panel scalar field viewer (the reference's ``show_scalar_field``,
`analyze_flow.py:54-180`): XY/XZ/YZ slices with optional
log scale, percentile color limits, RGBA solid overlay, and slice sliders."""

from __future__ import annotations

import numpy as np


def show_scalar_field(scalar_field, x, y, z, mask=None,
                      field_name="Scalar Field", log_scale=False, fig=None,
                      interactive=True, cmap=None, clim=None):
    import matplotlib.pyplot as plt
    from matplotlib.widgets import Slider

    scalar_field = np.asarray(scalar_field)
    nz, ny, nx = scalar_field.shape

    show_at_end = fig is None
    if fig is None:
        fig, axes = plt.subplots(1, 3, figsize=(15, 5),
                                 gridspec_kw={"width_ratios": [nx, nx, ny]})
    else:
        if len(fig.axes) >= 3:
            axes = fig.axes[:3]
        else:
            fig.clf()
            axes = fig.subplots(1, 3,
                                gridspec_kw={"width_ratios": [nx, nx, ny]})
    axes = np.asarray(axes)
    fig.suptitle(field_name, fontsize=14)

    iz, iy, ix = nz // 2, ny // 2, nx // 2

    valid = scalar_field[np.asarray(mask, bool)] if mask is not None \
        else scalar_field[scalar_field > 0]
    if log_scale and valid.size > 0:
        plot_data = np.log10(scalar_field + 1e-20)
        vmin = np.log10(np.percentile(valid, 1) + 1e-20)
        vmax = np.log10(np.percentile(valid, 99) + 1e-20)
        curr_cmap = cmap or "hot"
        label = f"log10({field_name})"
    else:
        plot_data = scalar_field
        if clim is not None:
            vmin, vmax = clim
        else:
            vmin = np.percentile(valid, 1) if valid.size else 0.0
            vmax = np.percentile(valid, 99) if valid.size \
                else float(scalar_field.max())
        curr_cmap = cmap or "viridis"
        label = field_name

    def mask_rgba(axis, idx):
        if mask is None:
            return None
        m = np.asarray(mask, bool)
        sl = m[idx] if axis == 0 else (m[:, idx] if axis == 1 else m[:, :, idx])
        rgba = np.zeros(sl.shape + (4,))
        rgba[~sl] = [0, 0, 0, 1]
        return rgba

    ims, mask_ims = [], []
    panels = [
        (0, iz, "XY plane", "X", "Y", lambda i: plot_data[i, :, :]),
        (1, iy, "XZ plane", "X", "Z", lambda i: plot_data[:, i, :]),
        (2, ix, "YZ plane", "Y", "Z", lambda i: plot_data[:, :, i]),
    ]
    coords = (np.asarray(z), np.asarray(y), np.asarray(x))
    for (axis, idx, name, xl, yl, get) in panels:
        ax = axes[axis]
        im = ax.imshow(get(idx), cmap=curr_cmap, vmin=vmin, vmax=vmax,
                       origin="lower")
        ims.append(im)
        mi = None
        if mask is not None:
            mi = ax.imshow(mask_rgba(axis, idx), origin="lower")
        mask_ims.append(mi)
        ax.set_title(f"{name} ({'ZYX'[axis]}={coords[axis][idx]:.1f})")
        ax.set_xlabel(xl)
        ax.set_ylabel(yl)

    fig.colorbar(ims[2], ax=list(axes.ravel()), label=label, aspect=30,
                 pad=0.08)

    if interactive:
        import matplotlib.pyplot as plt
        plt.subplots_adjust(bottom=0.25)
        sliders = []
        for i, (n, init, lbl) in enumerate(
                [(nz, iz, "Z slice"), (ny, iy, "Y slice"), (nx, ix, "X slice")]):
            ax_s = fig.add_axes([0.15, 0.15 - 0.05 * i, 0.2, 0.03])
            sliders.append(Slider(ax_s, lbl, 0, n - 1, valinit=init,
                                  valstep=1))

        def update(_val):
            vals = [int(s.val) for s in sliders]
            getters = [lambda i: plot_data[i, :, :],
                       lambda i: plot_data[:, i, :],
                       lambda i: plot_data[:, :, i]]
            for axis in range(3):
                ims[axis].set_data(getters[axis](vals[axis]))
                if mask_ims[axis] is not None:
                    mask_ims[axis].set_data(mask_rgba(axis, vals[axis]))
                axes[axis].set_title(
                    f"{panels[axis][2]} ({'ZYX'[axis]}={coords[axis][vals[axis]]:.1f})")
            fig.canvas.draw_idle()

        for s in sliders:
            s.on_changed(update)
        fig._sliders = sliders

    if show_at_end:
        import matplotlib.pyplot as plt
        plt.show()
    return fig
