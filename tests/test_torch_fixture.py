"""The committed cross-check fixtures (tests/data/torch_port_fixture.npz,
torch_port_fixture_weighted.npz, torch_port_fixture_modes.npz and
torch_port_fixture_alloc.npz, read by chip_smoke.py on the GPU) are what
pactpu makes today: rebuilt from their seed and recipe, they equal the
committed files."""

import numpy as np

import os

from make_torch_port_fixture import (ALLOC_MODES, PATH, PATH_ALLOC,
                                     PATH_MODES, PATH_WEIGHTED, RATE_MODES,
                                     build_alloc_fixture, build_fixture,
                                     build_modes_fixture)
from torch_threads import torch_threads  # noqa: F401 (autouse)


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


def test_modes_fixture_is_current():
    """Mono .wak of the input's first channel and stereo .pac, 45 blocks
    each, from the same input as the default fixture."""
    fresh = build_modes_fixture()
    with np.load(PATH_MODES) as z, np.load(PATH) as ref:
        assert sorted(z.files) == sorted(fresh)
        for key, value in fresh.items():
            np.testing.assert_array_equal(z[key], value, err_msg=key)
        np.testing.assert_array_equal(z["stereo_pac_pcm"], ref["pcm"])
        np.testing.assert_array_equal(z["mono_wak_pcm"], ref["pcm"][:, :1])


def test_alloc_fixture_is_current():
    """pactpu's streams of the four other allocators in cbr and reservoir
    and its trained-table cbr stream, from the default fixture's input,
    under 300 KB."""
    fresh = build_alloc_fixture()
    with np.load(PATH_ALLOC) as z, np.load(PATH) as ref:
        assert sorted(z.files) == sorted(fresh)
        for key, value in fresh.items():
            np.testing.assert_array_equal(z[key], value, err_msg=key)
        assert z["seed"] == ref["seed"] and z["seconds"] == ref["seconds"]
    streams = {f"{a}_{r}" for a in ALLOC_MODES for r in RATE_MODES}
    assert len({fresh[f"{k}_stream"].tobytes() for k in streams}) == 8
    assert os.path.getsize(PATH_ALLOC) < 300_000
