"""The committed cross-check fixtures (tests/data/torch_port_fixture.npz
and torch_port_fixture_weighted.npz, read by chip_smoke.py on the GPU) are
what pactpu makes today: rebuilt from their seed and recipe, they equal the
committed files."""

import numpy as np

from make_torch_port_fixture import PATH, PATH_WEIGHTED, build_fixture


def test_fixture_is_current():
    fresh = build_fixture()
    with np.load(PATH) as z:
        assert sorted(z.files) == sorted(fresh)
        for key, value in fresh.items():
            np.testing.assert_array_equal(z[key], value, err_msg=key)
    assert fresh["pcm"].shape == (44100, 2)
    assert len(fresh["stream"]) > 0


def test_weighted_fixture_is_current():
    """The peak_mode="weighted" fixture, made with pactpu's masker tuple in
    order (make_torch_port_fixture.pactpu_maskers_in_order); 45 blocks."""
    fresh = build_fixture("weighted")
    with np.load(PATH_WEIGHTED) as z, np.load(PATH) as ref:
        assert sorted(z.files) == sorted(fresh)
        for key, value in fresh.items():
            np.testing.assert_array_equal(z[key], value, err_msg=key)
        np.testing.assert_array_equal(z["pcm"], ref["pcm"])
        assert z["stream"].tobytes() != ref["stream"].tobytes()
