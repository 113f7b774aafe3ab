#!/usr/bin/env python
"""Print how far the PyTorch port's flow analysis lies from the JAX
package's, both run on the CPU (JAX_PLATFORMS=cpu), on the fixtures of
``tests/test_torch_drag.py`` and ``tests/test_torch_analyze.py``:

* mesh drag: the port's device pipeline against the JAX package's public
  ``compute_interface_drag(method="mesh")`` (which takes the host extractor
  off the TPU) and against the JAX device pipeline called directly —
  the largest |Δ| of any force, over the label's force scale, and of the
  area, relative;
* the two permeabilities of ``run_analysis`` on the 32³ gyroid field: the
  port and JAX against an f64 evaluation of the same formula.

Run from the repository root:
``JAX_PLATFORMS=cpu python tools/measure_torch_analysis_parity.py``.
"""

import os
import sys
import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [REPO, os.path.join(REPO, "tests"), os.path.join(REPO, "tools")]


def _gap(got, want):
    """Largest force gap over the force scale, and the area gap."""
    out = []
    for label, w in want.items():
        g = got[label]
        scale = max(abs(v) for k, v in w.items() if k.startswith("F"))
        f = max(abs(g[k] - w[k]) for k in w if k.startswith("F")) / scale
        a = abs(g["Area"] - w["Area"]) / w["Area"]
        out.append((label, f, a))
    return out


def drag_gaps():
    import test_torch_drag as t
    from ptv_interpolation_tpu import drag as jd
    u, v, w, p, lab, bg = t._problem()
    for with_bg in (False, True):
        port = t._port_mesh(with_bg)
        host = jd.compute_interface_drag(
            u, v, w, p, t.MU, *t.SPACING, lab, method="mesh",
            volume=t.VOLUME, background_mask=bg if with_bg else None)
        dev = t._jax_device_mesh(with_bg)
        for name, ref in (("JAX public (host extractor)", host),
                          ("JAX device pipeline", dev)):
            for label, f, a in _gap(port, ref):
                print(f"mesh drag, background mask {with_bg}, label {label}"
                      f", port vs {name}: max |ΔF| / force scale {f:.3e}, "
                      f"|ΔArea| / Area {a:.3e}")


def permeability_gaps():
    import test_torch_analyze as t
    for name in sorted(t.CONFIGS):
        with tempfile.TemporaryDirectory() as tmp:
            both = t._run_both(name, _PathLike(tmp))
        (want, _, _), (got, _, _) = both["jax"], both["port"]
        f64 = dict(zip(("permeability_dissipation", "permeability_pressure"),
                       t._f64_permeabilities(t.CONFIGS[name], got)))
        for k, ref in f64.items():
            print(f"run_analysis {name}, {k}: port vs f64 "
                  f"{abs(got[k] - ref) / abs(ref):.3e}, JAX vs f64 "
                  f"{abs(want[k] - ref) / abs(ref):.3e}")


class _PathLike(str):
    """A directory name that joins with ``/`` as ``pathlib`` does."""

    def __truediv__(self, name):
        return _PathLike(os.path.join(self, name))


def main():
    import torch
    torch.set_num_threads(2)
    drag_gaps()
    permeability_gaps()


if __name__ == "__main__":
    main()
