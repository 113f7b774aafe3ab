"""Synthetic dataset generators (test fixtures standing in for lab PTV
data), host numpy."""

from ptv_interpolation_tpu_torch.datasets import cylinders, sphere_pack

__all__ = ["cylinders", "sphere_pack"]
