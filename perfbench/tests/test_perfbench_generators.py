"""The generators: the same seed gives the same inputs, every seed the
same sizes, and the porous-glass mask has the crop's shape."""

import json
from pathlib import Path

import numpy as np
import pytest

from perfbench.lib.manifest import load_module

BENCH = Path(__file__).resolve().parent.parent
GLASS = json.loads((BENCH / "configs" / "porous_glass.json").read_text())
CUBE = json.loads((BENCH / "configs" / "uniform256.json").read_text())


@pytest.fixture(scope="module")
def glass():
    return load_module(BENCH / "generators", "porous_glass")


def test_glass_mask_is_the_crop(glass):
    fluid = glass.fluid_mask(GLASS)
    assert fluid.shape == (486, 337, 322)
    assert 0.90 < fluid.mean() < 0.94


def test_glass_dataset_is_fixed_by_seed_and_index(glass):
    fluid = glass.fluid_mask(GLASS)
    a = glass.make_dataset(GLASS, fluid, 2**31 + 11, 1)
    b = glass.make_dataset(GLASS, fluid, 2**31 + 11, 1)
    c = glass.make_dataset(GLASS, fluid, 2**31 + 11, 2)
    assert np.array_equal(a["points"], b["points"])
    assert np.array_equal(a["values"], b["values"])
    assert not np.array_equal(a["points"], c["points"])
    n = GLASS["n_tracks"]
    for d in (a, c):
        assert d["points"].shape == (n, 3) and d["values"].dtype == np.float32
        assert len(d["planted"]["threshold"]) == len(d["planted"]["mad"]) \
            == round(0.002 * n)
        i = d["points"].astype(int)
        assert fluid[i[:, 2], i[:, 1], i[:, 0]].all()
        speed = np.linalg.norm(d["values"], axis=1)
        assert (speed[d["planted"]["threshold"]] > GLASS["filter_max_speed"]).all()
        assert (speed[d["planted"]["mad"]] < GLASS["filter_max_speed"]).all()


def test_cube_dataset_is_fixed_by_seed_and_index():
    gen = load_module(BENCH / "generators", "uniform_cube")
    cfg = dict(CUBE, n_points=5000)
    a, b = gen.make_pool(cfg, 12345678901, 2), gen.make_pool(cfg, 12345678901, 2)
    assert np.array_equal(a[0]["points"], b[0]["points"])
    assert not np.array_equal(a[0]["points"], a[1]["points"])
    assert a[1]["points"].min() >= 0 and a[1]["points"].max() < CUBE["extent"]
