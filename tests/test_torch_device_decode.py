"""PyTorch port, the device-parse decode route on the CPU (raw payload rows
-> plain K5 walk -> K1 signs/LRMS -> synthesis): equal to the host-parse
route sample for sample and to pactpu within 1 LSB; corrupt streams raise
on both routes; decode_many and decode_range."""

import os

import numpy as np
import pytest

from make_torch_port_fixture import fixture_pcm
from pactpu.codec import engine as je
from pactpu_torch import Engine
from pactpu_torch.ops import huffman_decode as hd

FIXTURE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                       "torch_port_fixture.npz")
CHUNK = 16
HALF = 1024


@pytest.fixture(scope="module")
def fixture():
    """The stream pactpu encoded (45 blocks) and pactpu's decode of it."""
    z = np.load(FIXTURE)
    return z["stream"].tobytes(), z["decoded"]


@pytest.fixture(scope="module")
def routes():
    return {r: Engine(device="cpu", chunk_blocks=CHUNK, decode_parse=r)
            for r in ("host", "device")}


@pytest.fixture(scope="module")
def long_stream(routes):
    """1.5 s = 66 blocks: four 16-block chunks and a padded tail."""
    stream = routes["host"].encode(fixture_pcm(seed=11, seconds=1.5))
    return stream, routes["host"].decode(stream)[1]


def test_device_parse_equals_host_parse(routes, long_stream):
    stream, host_pcm = long_stream
    fs, dev_pcm = routes["device"].decode(stream)
    assert fs == 44100 and dev_pcm.dtype == np.int16
    np.testing.assert_array_equal(dev_pcm, host_pcm)


@pytest.mark.parametrize("chunk_blocks", [None, CHUNK])
def test_device_parse_matches_pactpu(fixture, chunk_blocks):
    """Within +-1 LSB of pactpu's decode, >= 99.9% of samples identical
    (the inverse MDCT's float32 sums run in another order)."""
    stream, gold = fixture
    _, out = Engine(device="cpu", chunk_blocks=chunk_blocks,
                    decode_parse="device").decode(stream)
    assert out.shape == gold.shape
    d = np.abs(out.astype(np.int32) - gold.astype(np.int32))
    assert d.max() <= 1
    assert (d == 0).mean() >= 0.999


@pytest.mark.parametrize("route", ["host", "device"])
def test_corrupt_stream_raises(routes, long_stream, route):
    """A flipped payload byte raises ValueError naming a channel-block; a
    stream cut inside a channel-block raises too."""
    stream = long_stream[0]
    bad = bytearray(stream)
    bad[len(bad) // 2] ^= 0xFF
    bad[len(bad) // 2 + 1] ^= 0x55
    with pytest.raises(ValueError, match="channel-block"):
        routes[route].decode(bytes(bad))
    with pytest.raises(ValueError):
        routes[route].decode(stream[:len(stream) - 7])


def test_parse_route_selection(monkeypatch, fixture):
    """The environment variable is read when the argument is None; an
    unknown value raises; the default is the host route."""
    monkeypatch.setenv("PACTPU_DECODE_PARSE", "bogus")
    with pytest.raises(ValueError, match="PACTPU_DECODE_PARSE"):
        Engine(device="cpu")
    with pytest.raises(ValueError, match="PACTPU_DECODE_PARSE"):
        Engine(device="cpu", decode_parse="gpu")
    monkeypatch.setenv("PACTPU_DECODE_PARSE", "device")
    assert Engine(device="cpu").decode_parse == "device"
    assert Engine(device="cpu", decode_parse="host").decode_parse == "host"
    monkeypatch.delenv("PACTPU_DECODE_PARSE")
    eng = Engine(device="cpu")
    assert eng.decode_parse == "auto"
    # the host route never frames payload rows for the device

    def no_framing(*a, **k):
        raise AssertionError("the default route framed rows")

    monkeypatch.setattr(hd, "frame_rows", no_framing)
    assert eng.decode(fixture[0])[1].shape == fixture[1].shape


@pytest.mark.parametrize("route", ["host", "device"])
def test_decode_many_equals_serial(routes, long_stream, fixture, route):
    eng = routes[route]
    datas = [long_stream[0], fixture[0]]
    for (fs, out), data in zip(eng.decode_many(datas), datas):
        assert fs == 44100
        np.testing.assert_array_equal(out, eng.decode(data)[1])


WINDOWS = {
    "start": (0, 3000),
    "across_chunk_boundary": (CHUNK * HALF - 500, 2000),
    "end_of_stream": (-1500, 5000),       # from 1500 before the end
    "one_sample": (5000, 1),
    "past_the_end": (10 ** 7, 10),
    "negative_start": (-100, 300),
}


@pytest.mark.parametrize("route", ["host", "device"])
@pytest.mark.parametrize("window", list(WINDOWS))
def test_decode_range_equals_slice(routes, long_stream, route, window):
    stream, full = long_stream
    start, n = WINDOWS[window]
    if window == "end_of_stream":
        start += len(full)
    fs, out = routes[route].decode_range(stream, start, n)
    assert fs == 44100
    lo, hi = max(0, start), min(len(full), start + n)
    np.testing.assert_array_equal(out, full[lo:max(lo, hi)])


def test_decode_range_matches_pactpu(routes, fixture):
    """Against pactpu's decode_range on its own stream, within 1 LSB."""
    stream = fixture[0]
    ref = je.Engine(chunk_blocks=CHUNK)
    for start, n in ((2000, 4000), (CHUNK * HALF - 10, 1500)):
        _, gold = ref.decode_range(stream, start, n)
        _, out = routes["device"].decode_range(stream, start, n)
        assert out.shape == gold.shape == (n, 2)
        assert np.abs(out.astype(np.int32) - gold.astype(np.int32)).max() <= 1
