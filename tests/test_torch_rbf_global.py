"""The port's global RBF (``interpolate/rbf_global.py`` and
``interpolate/rbf_global_pcg.py``) against the JAX package's on the same
seeded clouds: the dense fit and evaluation, evaluation alone on a
JAX-fitted model, and the matrix-free projected PCG (iteration counts,
the identity fallback of indefinite blocks, the near-singular safeguard,
routing), and the carried-over dataset generators scenario 2 uses."""

import numpy as np
import pytest
import torch

from ptv_interpolation_tpu.interpolate import rbf_global as jrg
from ptv_interpolation_tpu.interpolate import rbf_global_pcg as jrp
from ptv_interpolation_tpu_torch.convert import global_rbf_from_numpy
from ptv_interpolation_tpu_torch.interpolate import rbf_global as trg
from ptv_interpolation_tpu_torch.interpolate import rbf_global_pcg as trp

torch.set_num_threads(2)


def _field(p):
    """``tests/test_rbf_global_pcg.py::_field``."""
    return np.stack([np.sin(p[:, 0] * 0.7),
                     np.cos(p[:, 1] * 0.5) + 0.3 * p[:, 2],
                     p[:, 0] * p[:, 1] * 0.1], axis=-1)


def _cloud(n=1000, seed=5):
    rng = np.random.default_rng(seed)
    pts = rng.uniform(0, 10, size=(n, 3)).astype(np.float32)
    q = rng.uniform(1, 9, size=(500, 3)).astype(np.float32)
    return pts, _field(pts).astype(np.float32), q


def _rel_l2(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / np.linalg.norm(want)


@pytest.mark.parametrize("kernel,eps,smoothing,degree,tol", [
    # Cholesky, the BASELINE config-2 form (measured 1.1e-5)
    ("gaussian", 2.0, 1e-3, -1, 1e-4),
    # LU on the saddle system (measured 3.0e-5)
    ("thin_plate_spline", 1.0, 0.0, None, 1e-4),
    ("cubic", 1.0, 1e-3, None, 1e-4),
])
def test_dense_fit_and_evaluate_match_jax(kernel, eps, smoothing, degree,
                                          tol):
    """Fit and evaluate on 800 points: the values at 500 queries within
    the relative L2 ``tol``. The coefficients themselves are as far apart
    as the f32 systems' conditioning lets them be; the field is not."""
    pts, vals, q = _cloud(800)
    kw = dict(kernel=kernel, epsilon=eps, smoothing=smoothing, degree=degree)
    want = np.asarray(jrg.rbf_global_interpolate(pts, vals, q, **kw))
    got = trg.rbf_global_interpolate(pts, vals, q, device="cpu", **kw)
    assert got.shape == want.shape and bool(torch.isfinite(got).all())
    assert _rel_l2(got.numpy(), want) < tol


@pytest.mark.parametrize("kernel,eps,degree,tol", [
    # measured 1.7e-6, 2.2e-6 and 8.0e-5: quintic's Σ|K·c| reaches 2.6e4
    # against values of order 1, so f32 sums in another order move it most
    ("gaussian", 2.0, -1, 1e-5), ("thin_plate_spline", 1.0, 1, 1e-5),
    ("quintic", 1.0, 2, 2e-4)])
def test_evaluate_on_a_jax_fitted_model(kernel, eps, degree, tol):
    """``rbf_global_evaluate`` alone, on the JAX package's fitted model
    carried over by ``convert.global_rbf_from_numpy``, in tiles of 200
    queries: the relative L2 within ``tol`` (the (T, N) products over 800
    terms summed in another order)."""
    pts, vals, q = _cloud(800)
    jm = jrg.rbf_global_fit(pts, vals, kernel=kernel, epsilon=eps,
                            degree=degree, smoothing=1e-3)
    want = np.asarray(jrg.rbf_global_evaluate(jm, q))
    tm = global_rbf_from_numpy(
        np.asarray(jm.points_scaled), np.asarray(jm.coeffs),
        np.asarray(jm.poly_coeffs), np.asarray(jm.shift),
        np.asarray(jm.scale), jm.kernel, jm.epsilon, jm.degree,
        device="cpu")
    assert tm.scale.shape == () and tm.poly_coeffs.shape[0] == {
        -1: 0, 1: 4, 2: 10}[degree]
    got = trg.rbf_global_evaluate(tm, q, query_tile=200).numpy()
    assert _rel_l2(got, want) < tol


def test_failed_cholesky_gives_nan_as_jax():
    """A positive-definite kernel made indefinite (negative smoothing):
    JAX's Cholesky returns NaN and so do its coefficients; the port's
    ``cholesky_ex`` reports the failure and it gives NaN too, without
    raising."""
    pts, vals, q = _cloud(200)
    kw = dict(kernel="gaussian", epsilon=2.0, smoothing=-5.0, degree=-1)
    jm = jrg.rbf_global_fit(pts, vals, **kw)
    tm = trg.rbf_global_fit(pts, vals, device="cpu", **kw)
    assert np.isnan(np.asarray(jm.coeffs)).all()
    assert bool(torch.isnan(tm.coeffs).all())


def _captured_pcg(monkeypatch, module):
    """Wrap ``module._pcg_solve`` to keep its preconditioner factors."""
    seen = {}
    solve = module._pcg_solve

    def grab(*a, **kw):
        seen["pre_chol"] = np.asarray(a[4])
        return solve(*a, **kw)

    monkeypatch.setattr(module, "_pcg_solve", grab)
    return seen


def _identity_blocks(pre_chol):
    eye = np.eye(pre_chol.shape[1], dtype=np.float32)
    return np.array([np.array_equal(b, eye) for b in pre_chol])


@pytest.mark.parametrize("kernel,eps,smoothing,tol,field_tol", [
    # converge cleanly above the f32 floor: the step count is the JAX
    # package's within ±2 (63, 27 and 13 steps on both sides here); the
    # conditionally positive definite kernels (thin-plate, multiquadric)
    # are indefinite on every 128-block, which falls back to the identity
    ("thin_plate_spline", 1.0, 0.0, 1e-2, 5e-3),
    ("gaussian", 6.0, 1e-3, 1e-4, 1e-4),
    ("gaussian", 10.0, 0.0, 1e-5, 1e-5),
    ("multiquadric", 2.0, 0.0, 2e-2, 2e-2),          # 107 steps
])
def test_pcg_matches_jax(monkeypatch, kernel, eps, smoothing, tol,
                         field_tol):
    """The projected PCG on 1 000 points (blocks of 128, row tiles of
    512): the same preconditioner blocks fall back to the identity, the
    iteration count within ±2, both residuals at ``tol``, and the fields
    within ``field_tol`` relative L2 (a CG stopped at ``tol`` is that far
    from its solution)."""
    pts, vals, q = _cloud()
    kw = dict(kernel=kernel, epsilon=eps, smoothing=smoothing, tol=tol,
              block=128, row_tile=512)
    j_seen = _captured_pcg(monkeypatch, jrp)
    t_seen = _captured_pcg(monkeypatch, trp)
    lines = []
    monkeypatch.setattr("builtins.print", lambda s: lines.append(s))
    jm = jrp.rbf_global_fit_pcg(pts, vals, verbose=True, **kw)
    tm = trp.rbf_global_fit_pcg(pts, vals, verbose=True, device="cpu", **kw)
    j_iters = int(lines[0].split("iters=")[1].split()[0])
    t_iters, t_res = trp.rbf_global_fit_pcg.last_solve
    assert lines[1] == (f"  [rbf-pcg] N=1000 iters={t_iters} "
                        f"relres={t_res:.2e}")
    assert abs(t_iters - j_iters) <= 2, (t_iters, j_iters)
    assert t_res <= tol and float(lines[0].split("relres=")[1]) <= tol
    j_eye = _identity_blocks(j_seen["pre_chol"])
    np.testing.assert_array_equal(_identity_blocks(t_seen["pre_chol"]),
                                  j_eye)
    assert j_eye.all() if kernel != "gaussian" else not j_eye.any()
    want = np.asarray(jrg.rbf_global_evaluate(jm, q))
    got = trg.rbf_global_evaluate(tm, q).numpy()
    assert _rel_l2(got, want) < field_tol


def test_pcg_near_singular_system_stays_finite():
    """A flat gaussian (ε = 0.5 on scaled coordinates) is rank-deficient
    in f32; the best-iterate safeguard returns a finite, bounded field, as
    in ``tests/test_rbf_global_pcg.py``."""
    pts, vals, q = _cloud()
    tm = trp.rbf_global_fit_pcg(pts, vals, kernel="gaussian", epsilon=0.5,
                                block=128, row_tile=512, device="cpu")
    out = trg.rbf_global_evaluate(tm, q).numpy()
    assert np.isfinite(out).all() and np.abs(out).max() < 100.0
    assert trp.rbf_global_fit_pcg.last_solve[0] < 600


def test_auto_routing_and_smoothing(monkeypatch):
    """``solver='auto'`` takes the PCG above ``DENSE_FIT_MAX``, as the JAX
    package does; nonzero smoothing lowers the coefficient norm."""
    pts, vals, q = _cloud(600)
    monkeypatch.setattr(trg, "DENSE_FIT_MAX", 500)
    called = []
    fit = trp.rbf_global_fit_pcg
    monkeypatch.setattr(trp, "rbf_global_fit_pcg",
                        lambda *a, **kw: (called.append(1), fit(*a, **kw))[1])
    out = trg.rbf_global_interpolate(pts, vals, q, kernel="gaussian",
                                     epsilon=6.0, block=128, row_tile=512,
                                     device="cpu")
    assert called and bool(torch.isfinite(out).all())
    m0, m1 = (fit(pts, vals, kernel="gaussian", epsilon=6.0,
                  smoothing=s, block=128, row_tile=512, device="cpu")
              for s in (0.0, 1.0))
    assert float(m1.coeffs.norm()) < float(m0.coeffs.norm())


def test_datasets_match_jax(tmp_path):
    """The carried-over generators give the JAX package's clouds, masks
    and bounds, and write the same files."""
    from ptv_interpolation_tpu.datasets import cylinders as jcyl
    from ptv_interpolation_tpu.datasets import sphere_pack as jsp
    from ptv_interpolation_tpu_torch.datasets import cylinders, sphere_pack
    for jmod, tmod, kw in ((jcyl, cylinders, dict(n_points=3000)),
                           (jsp, sphere_pack, dict(n_points=3000, size=24,
                                                   voxel_units=True))):
        want = jmod.generate(**kw)
        got = tmod.generate(filename=str(tmp_path / "p.csv"),
                            maskname=str(tmp_path / "m.tif"), **kw)
        np.testing.assert_array_equal(got[0].points, want[0].points)
        np.testing.assert_array_equal(got[0].values, want[0].values)
        np.testing.assert_array_equal(got[1], want[1])
        assert got[2] == want[2]
        assert (tmp_path / "p.csv").stat().st_size > 0
    u, v = cylinders.analytic_velocity(np.array([1.0]), np.array([0.5]))
    np.testing.assert_array_equal(
        (u, v), jcyl.analytic_velocity(np.array([1.0]), np.array([0.5])))
