"""The roofline arithmetic on worked numbers of the two configurations,
counted from the problem's sizes alone."""

import pytest

from perfbench.roofline import kernels


def test_kernel1_headline():
    ops, n_bytes = kernels.kernel1(256 ** 3, 50, 1_000_000)
    assert ops / 33.5e12 * 1e3 == pytest.approx(0.2003, abs=1e-4)
    assert n_bytes / 3.35e12 * 1e3 == pytest.approx(0.0673, abs=1e-4)
    assert kernels.least_seconds(ops, n_bytes) == ops / 33.5e12
    # over kernel 1's 52 ms: about 0.39% of its roofline
    assert 100 * kernels.least_seconds(ops, n_bytes) / 0.052 == \
        pytest.approx(0.385, abs=0.001)


def test_kernel1_glass():
    ops, _ = kernels.kernel1(6_050_000, 50, 700_000)
    assert ops / 33.5e12 * 1e3 == pytest.approx(0.0722, abs=1e-4)


def test_kernel2_glass():
    ops, n_bytes = kernels.kernel2(648_700, 30)
    assert ops == 648_700 * 31 * 8
    assert n_bytes == 648_700 * 17
    # over kernel 2's 16.5 ms: about 0.03% of its roofline
    assert 100 * kernels.least_seconds(ops, n_bytes) / 0.0165 == \
        pytest.approx(0.029, abs=0.001)
