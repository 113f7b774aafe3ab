"""Wall per unit: the whole measured window over the units completed in
it (the window closes when the unit running at its deadline completes)."""


def read(window):
    return window.window_s / window.units if window.units else None
