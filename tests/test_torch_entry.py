"""The port's entry points (``ptv_interpolation_tpu_torch/entry.py``)
against ``__graft_entry__.py``'s, the counterparts of
``tests/test_sharding.py``'s entry tests: the one-device step on the CPU,
and the dry run over a gloo world of 2 processes on the CPU."""

import numpy as np
import pytest
import torch

import __graft_entry__ as ge
from ptv_interpolation_tpu_torch.entry import dryrun_multichip, entry

torch.set_num_threads(2)


def test_entry_single_device_matches_jax():
    """``entry(device="cpu")``: the step gives (16, 16, 16) fields and a
    finite mean |div|, within rtol 1e-3 / atol 1e-5 of JAX's
    ``make_pipeline_step(grid, mesh=None, k=8, iterations=1)`` on the
    same problem."""
    fn, args = entry(device="cpu")
    assert all(a.device.type == "cpu" for a in args)
    out = fn(*args)
    assert tuple(out[0].shape) == (16, 16, 16)
    assert np.isfinite(float(out[3]))
    jfn, jargs = ge.entry()
    want = jfn(*jargs)
    for got, w in zip(out[:3], want[:3]):
        np.testing.assert_allclose(got.numpy(), np.asarray(w), rtol=1e-3,
                                   atol=1e-5)
    np.testing.assert_allclose(float(out[3]), float(want[3]), rtol=1e-3)


def test_entry_runs_on_the_card_by_default():
    """Without ``device=`` the step is built for the card, so it raises
    where there is none."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid here")
    with pytest.raises(RuntimeError):
        entry()


def test_dryrun_multichip_cpu():
    """``dryrun_multichip(2, device="cpu")`` runs the step, variational
    cleaning, ``sharded_interpolate_values`` and both
    ``sharded_grid_interpolate`` backends over 2 gloo ranks, each result
    finite."""
    dryrun_multichip(2, device="cpu")
