"""The port's fused kNN-MAD filter (``ops/fused_mad.py``, plain version of
the kernel on the CPU) against the JAX package's, whose Pallas kernel runs
in interpret mode, on the same seeded clouds."""

import functools

import numpy as np
import pytest
import torch

from ptv_interpolation_tpu.ops import fused_mad as jfm
from ptv_interpolation_tpu.ops.neighbors import build_cell_list as jax_cells
from ptv_interpolation_tpu_torch.ops import fused_mad as tfm
from ptv_interpolation_tpu_torch.ops.neighbors import build_cell_list

torch.set_num_threads(2)

# d², τ² and the bisections are f32 in one op order on both sides; XLA may
# round d² differently in the last bit, which moves √τ² by an ulp or two
RTOL = 1e-6


def _cloud(n, n_outliers, seed):
    """The clouds of ``tests/test_filtering.py::_make_cloud``."""
    rng = np.random.default_rng(seed)
    pts = rng.uniform(0, 10, size=(n, 3))
    vals = np.stack([0.1 * np.sin(pts[:, 0]), 0.1 * np.cos(pts[:, 1]),
                     np.ones(n)], axis=-1)
    out_idx = rng.choice(n, n_outliers, replace=False)
    vals[out_idx] *= 8.0
    pts = pts.astype(np.float32)
    speed = np.sqrt((vals.astype(np.float32) ** 2).sum(axis=1))
    return pts, speed.astype(np.float32)


def _coincident():
    """A cloud where 300 points have a twin at the same position with a
    different speed: self-exclusion must drop exactly one copy."""
    pts, speed = _cloud(2500, 10, 3)
    rng = np.random.default_rng(4)
    twins = rng.choice(len(pts), 300, replace=False)
    pts = np.concatenate([pts, pts[twins]])
    speed = np.concatenate([speed, speed[twins] * 1.3]).astype(np.float32)
    return pts, speed


CLOUDS = {"c3000": lambda: _cloud(3000, 25, 5),
          "c5000": lambda: _cloud(5000, 40, 7),
          "coincident": _coincident}


@functools.lru_cache(maxsize=None)
def _jax_run(cloud, k):
    """The JAX filter in interpret mode, with the kernel's inputs and
    output captured."""
    pts, speed = CLOUDS[cloud]()
    seen = {}
    eval_, compact, capacity = (jfm._mad_eval, jfm._compact_indices_scatter,
                                jfm._lattice_capacity)

    def grab_eval(*a, **kw):
        out = eval_(*a, **kw)
        seen["eval"] = ([np.asarray(x) for x in a[:6]], a[6:], np.asarray(out))
        return out

    def grab_compact(*a, **kw):
        g = compact(*a, **kw)
        seen["G"] = np.asarray(g)
        return g

    def grab_capacity(*a, **kw):
        seen["C_raw"] = capacity(*a, **kw)
        return seen["C_raw"]

    jfm._mad_eval, jfm._compact_indices_scatter, jfm._lattice_capacity = (
        grab_eval, grab_compact, grab_capacity)
    try:
        res = jfm.fused_mad_filter(pts, speed, k, 3.0, interpret=True,
                                   want_kth=True)
    finally:
        jfm._mad_eval, jfm._compact_indices_scatter, jfm._lattice_capacity = (
            eval_, compact, capacity)
    return res, seen


@functools.lru_cache(maxsize=None)
def _port_run(cloud, k):
    pts, speed = CLOUDS[cloud]()
    seen = {}
    compact, capacity = tfm._compact_indices_scatter, tfm._lattice_capacity

    def grab_compact(*a, **kw):
        g = compact(*a, **kw)
        seen["G"] = g.numpy()
        return g

    def grab_capacity(*a, **kw):
        seen["C_raw"] = capacity(*a, **kw)
        return seen["C_raw"]

    tfm._compact_indices_scatter, tfm._lattice_capacity = (grab_compact,
                                                           grab_capacity)
    try:
        res = tfm.fused_mad_filter(pts, speed, k, 3.0, want_kth=True,
                                   device="cpu")
    finally:
        tfm._compact_indices_scatter, tfm._lattice_capacity = (compact,
                                                               capacity)
    return res, seen


@pytest.mark.parametrize("cloud,k", [("c3000", 25), ("c3000", 30),
                                     ("c5000", 25), ("c5000", 30),
                                     ("coincident", 30)])
def test_fused_mad_filter_matches_jax(cloud, k):
    """keep and covered identical on every point; the k-th distances and
    the median radius within 1e-6 relative."""
    (jk, jc, jr, jkth), _ = _jax_run(cloud, k)
    (tk, tc, tr, tkth), _ = _port_run(cloud, k)
    np.testing.assert_array_equal(tc, jc)
    np.testing.assert_array_equal(tk, jk)
    assert jc.mean() > 0.9
    np.testing.assert_allclose(tkth, jkth, rtol=RTOL)
    assert abs(tr - jr) <= RTOL * abs(jr)


@pytest.mark.parametrize("cloud,k", [("c3000", 25), ("c5000", 30),
                                     ("coincident", 30)])
def test_lattice_capacity_and_compaction_match_jax(cloud, k):
    """The panel width before rounding and the compacted source rows G are
    bit-identical to the JAX package's."""
    _, jseen = _jax_run(cloud, k)
    _, tseen = _port_run(cloud, k)
    assert tseen["C_raw"] == jseen["C_raw"]
    np.testing.assert_array_equal(tseen["G"], jseen["G"])


@pytest.mark.parametrize("cloud,k", [("c3000", 25), ("c5000", 30),
                                     ("coincident", 30)])
def test_mad_eval_plain_matches_pallas_interpret(cloud, k):
    """On the JAX package's own panel and query rows, the plain version's
    keep|covered row is identical and med, mad and √τ² agree to 1e-6
    relative (padding slots +inf on both)."""
    _, jseen = _jax_run(cloud, k)
    (sm, cand, qx, qy, qz, qs), (kk, thr, Bt, C, *_), want = jseen["eval"]
    t = functools.partial(torch.tensor, dtype=torch.float32)
    got = tfm._mad_eval(np.float32(sm[0, 0]), t(cand[:4]), t(qx), t(qy),
                        t(qz), t(qs), kk, thr, Bt, C).numpy()
    assert got.shape == want.shape
    np.testing.assert_array_equal(got[:, 0], want[:, 0])
    np.testing.assert_array_equal(np.isinf(got[:, 1]), np.isinf(want[:, 1]))
    fin = np.isfinite(want[:, 1])
    np.testing.assert_allclose(got[:, 1][fin], want[:, 1][fin], rtol=RTOL)
    np.testing.assert_allclose(got[:, 2:4], want[:, 2:4], rtol=RTOL,
                               atol=1e-7)
    np.testing.assert_array_equal(got[:, 4:], 0.0)


def test_coincident_points_follow_the_reference():
    """Self-exclusion by indicator drops one copy of a coincident pair,
    as the reference's ``idx[:, 1:]`` does: covered decisions agree with
    an f64 KDTree reference on the coincident cloud."""
    from scipy.spatial import cKDTree
    pts, speed = _coincident()
    keep, covered, _, _ = _port_run("coincident", 30)[0]
    p = pts.astype(np.float64)
    s = speed.astype(np.float64)
    _, idx = cKDTree(p).query(p, k=31)
    neigh = s[idx[:, 1:]]
    med = np.median(neigh, axis=1)
    mad = np.median(np.abs(neigh - med[:, None]), axis=1)
    ref = np.abs(s - med) / (mad + 1e-6) <= 3.0
    assert (keep[covered] == ref[covered]).mean() > 0.998


def test_cell_list_matches_jax():
    """The filter's cell list (margin/3 cells) is permutation-identical."""
    pts, _ = _cloud(3000, 25, 5)
    j = jax_cells(pts, cell_size=0.7, build_table=False)
    t = build_cell_list(pts, cell_size=0.7, device="cpu")
    np.testing.assert_array_equal(t.order.numpy(), np.asarray(j.order))
    np.testing.assert_array_equal(t.starts.numpy(), np.asarray(j.starts))


def test_mad_eval_refuses_what_the_kernel_cannot_take():
    args = (np.float32(4.0), torch.zeros((8, 256)),
            *(torch.zeros((2, 1, 128)),) * 4, 25, 3.0, 128, 128)
    with pytest.raises(ValueError, match=r"\(4, n_blocks\*128\)"):
        tfm._mad_eval(*args)
    meta = [torch.zeros((4, 256), device="meta")] + [
        torch.zeros((2, 1, 128), device="meta")] * 4
    with pytest.raises(ValueError, match="unsupported device"):
        tfm._mad_eval(np.float32(4.0), *meta, 25, 3.0, 128, 128)


def test_kernel_build_raises_without_nvcc(monkeypatch, tmp_path):
    """The wrapper's build path raises when there is no nvcc; it never
    falls back to the plain version."""
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    tfm._kernel_lib.cache_clear()
    from ptv_interpolation_tpu_torch.ops import cuda_build
    cuda_build.load_library.cache_clear()
    monkeypatch.setattr(cuda_build, "BUILD_DIR", tmp_path / "_build")
    try:
        with pytest.raises(RuntimeError, match="nvcc not found"):
            tfm._kernel_lib()
    finally:
        tfm._kernel_lib.cache_clear()
        cuda_build.load_library.cache_clear()


def test_cuda_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the no-card behaviour cannot show")
    pts, speed = _cloud(600, 5, 1)
    with pytest.raises(RuntimeError, match="cuda.is_available"):
        tfm.fused_mad_filter(pts, speed, 25, 3.0, device="cuda")


def test_declines_past_the_panel_bounds():
    """The max_bt / max_panel guards return None, as the JAX package's."""
    pts, speed = _cloud(3000, 25, 5)
    assert tfm.fused_mad_filter(pts, speed, 25, 3.0, max_bt=64,
                                device="cpu") is None
    assert tfm.fused_mad_filter(pts, speed, 25, 3.0, max_panel=128,
                                device="cpu") is None
    assert jfm.fused_mad_filter(pts, speed, 25, 3.0, max_panel=128,
                                interpret=True) is None
