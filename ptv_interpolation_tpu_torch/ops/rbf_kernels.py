"""Radial basis function kernels (scipy ``RBFInterpolator`` conventions).

Counterpart of ``ptv_interpolation_tpu/ops/rbf_kernels.py``. The signs
follow scipy's ``_rbfinterp_pythran``, so the kernel matrix is
conditionally positive (semi)definite together with the minimum polynomial
degree, and results compare directly with scipy's ``RBFInterpolator``.
"""

from __future__ import annotations

import torch

# minimal polynomial degree required for conditional positive definiteness
MIN_DEGREE = {
    "linear": 0,
    "thin_plate_spline": 1,
    "cubic": 1,
    "quintic": 2,
    "multiquadric": 0,
    "inverse_multiquadric": -1,
    "inverse_quadratic": -1,
    "gaussian": -1,
}

# kernels whose matrix is positive definite without a polynomial tail: they
# admit a pure dense Cholesky solve
PD_KERNELS = ("inverse_multiquadric", "inverse_quadratic", "gaussian")

# scale-invariant kernels, where scipy forbids a user epsilon ≠ 1
SCALE_INVARIANT = ("linear", "thin_plate_spline", "cubic", "quintic")


def kernel_value(name: str, r: torch.Tensor) -> torch.Tensor:
    """φ(r) with scipy's sign conventions; r ≥ 0 (already ε-scaled)."""
    if name == "linear":
        return -r
    if name == "thin_plate_spline":
        return torch.xlogy(r * r, r)        # r² log r, exactly 0 at r = 0
    if name == "cubic":
        return r * r * r
    if name == "quintic":
        r2 = r * r
        return -(r2 * r2 * r)
    if name == "multiquadric":
        return -torch.sqrt(r * r + 1.0)
    if name == "inverse_multiquadric":
        return 1.0 / torch.sqrt(r * r + 1.0)
    if name == "inverse_quadratic":
        return 1.0 / (r * r + 1.0)
    if name == "gaussian":
        return torch.exp(-(r * r))
    raise ValueError(f"unknown RBF kernel {name!r}")


def polynomial_basis(x: torch.Tensor, degree: int) -> torch.Tensor:
    """Monomial basis of total degree ≤ ``degree`` on (…, 3) coordinates:
    degree -1 → empty, 0 → [1], 1 → [1, x, y, z],
    2 → [1, x, y, z, x², xy, xz, y², yz, z²] (10 terms)."""
    ones = torch.ones(x.shape[:-1] + (1,), dtype=x.dtype, device=x.device)
    if degree < 0:
        return x.new_zeros(x.shape[:-1] + (0,))
    if degree == 0:
        return ones
    if degree >= 3:
        raise NotImplementedError("polynomial degree > 2 not supported")
    terms = [ones, x]
    if degree >= 2:
        iu, ju = torch.triu_indices(3, 3, device=x.device)
        terms.append(x[..., iu] * x[..., ju])
    return torch.cat(terms, dim=-1)


def n_poly_terms(degree: int) -> int:
    return {-1: 0, 0: 1, 1: 4, 2: 10}[degree]
