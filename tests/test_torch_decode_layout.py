"""PyTorch port, the decoded PCM's layout: the decode's chunks are joined on
the device in the caller's layout (int16 [n, C], channels interleaved, the
MDCT-delay row dropped), so the host only slices the download.  Every
Engine decode path (decode, decode_many, roundtrip_many, decode_range; the
host-parse and device-parse routes; .wak and .pac; stereo and mono) gives
the samples of the former host assembly (the overlap-add [b + 1, C, N]
transposed on the host) and of pactpu; the device parser's corruption
flags, downloaded behind the PCM, still name their channel-block; the span
"assemble" copies nothing."""

import os

import numpy as np
import pytest
import torch

from make_torch_port_fixture import fixture_pcm
from pactpu_torch import Engine
from pactpu_torch.codec.header import read_header
from pactpu_torch.ops import quantize as q
from pactpu_torch.utils import metrics as M
from pactpu_torch.utils.config import CodecConfig
from torch_threads import torch_threads  # noqa: F401 (autouse)

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")
CHUNK = 2
N = 1024
ROUTES = ("host", "device")
# input lengths: a whole number of blocks (the Q6 quirk: the header says
# one block more; 4 blocks fill two chunks, so the flush row is the
# carry), and 1 and N - 1 past one (3 blocks: the flush row is the
# overlap-add of the padded block)
LENGTHS = {"q6": 3 * N, "plus_1": N + 1, "minus_1": N + N - 1}


def pcm_of(chans: int, n: int, seed: int = 5) -> np.ndarray:
    return np.ascontiguousarray(fixture_pcm(seed=seed, seconds=0.1)[:n,
                                                                     :chans])


@pytest.fixture(scope="module")
def engines():
    """An Engine of each format, channel count and parse route."""
    return {(fmt, chans, route): Engine(
        device="cpu", cfg=CodecConfig(n_channels=chans), fmt=fmt,
        chunk_blocks=CHUNK, decode_parse=route)
        for fmt in ("wak", "pac") for chans in (2, 1) for route in ROUTES}


@pytest.fixture(scope="module")
def streams(engines):
    """Each format's and channel count's stream of each input length."""
    return {(fmt, chans, name): engines[fmt, chans, "host"].encode(
        pcm_of(chans, n))
        for fmt in ("wak", "pac") for chans in (2, 1)
        for name, n in LENGTHS.items()}


def host_assembly(engines, fmt: str, chans: int, data: bytes) -> np.ndarray:
    """The former assembly of a decode: the chunks' overlap-added PCM and
    the flush row joined as [b + 1, C, N], row 0 dropped, and transposed
    to [n, C] on the host.  The chunks run on the host-parse route: the
    device-parse route's give the same samples (test_torch_device_decode)
    and its plain walk takes tens of ms a block on the CPU."""
    eng = engines[fmt, chans, "host"]
    st = eng._decode_upload(eng._decode_staging(data))
    cfg, b = st["cfg"], st["b"]
    carry = torch.zeros((cfg.n_channels, cfg.n_mdct_lines),
                        dtype=eng.consts(cfg=cfg)["basis"].dtype)
    rows = []
    for args in st["chunk_args"]:
        pcm, carry, _ = st["run"](*args, carry)
        rows.append(pcm)
    ola = torch.cat(rows + [q.float_to_pcm16(carry)[None]])[:b + 1].numpy()
    audio = ola[1:].transpose(1, 0, 2).reshape(cfg.n_channels, -1).T
    return audio[:st["num_samples"]]


def check_layout(pcm: np.ndarray, n: int, chans: int) -> None:
    assert pcm.dtype == np.int16 and pcm.shape == (n, chans)
    assert pcm.flags.c_contiguous


@pytest.mark.parametrize("length", list(LENGTHS))
@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("chans", [2, 1])
@pytest.mark.parametrize("fmt", ["wak", "pac"])
def test_decode_equals_host_assembly(engines, streams, fmt, chans, route,
                                     length):
    """decode gives the former assembly's samples, the header's
    numSamples of them (Q6 included), C-contiguous."""
    eng, data = engines[fmt, chans, route], streams[fmt, chans, length]
    num_samples = read_header(data)[1]
    fs, out = eng.decode(data)
    assert fs == 44100
    check_layout(out, num_samples, chans)
    if length == "q6":
        assert num_samples == LENGTHS[length] + N
    np.testing.assert_array_equal(out,
                                  host_assembly(engines, fmt, chans, data))


FIXTURES = {                       # pactpu's streams and pactpu's decodes
    "stereo-wak": ("torch_port_fixture.npz", "", "wak", 2),
    "mono-wak": ("torch_port_fixture_modes.npz", "mono_wak_", "wak", 1),
    "stereo-pac": ("torch_port_fixture_modes.npz", "stereo_pac_", "pac", 2),
}


def near(out: np.ndarray, gold: np.ndarray) -> None:
    """Within 1 LSB of pactpu's decode, >= 99.9% of samples identical (the
    inverse MDCT's float32 sums run in another order)."""
    assert out.shape == gold.shape
    d = np.abs(out.astype(np.int32) - gold.astype(np.int32))
    assert int(d.max()) <= 1 and (d == 0).mean() >= 0.999


@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("fixture", list(FIXTURES))
def test_decode_matches_pactpu(engines, fixture, route):
    """pactpu's stream (45 blocks): decode on the host-parse route, and
    on the device-parse route decode_range of 3 blocks across a chunk boundary, give
    pactpu's samples and the former assembly's."""
    name, key, fmt, chans = FIXTURES[fixture]
    with np.load(os.path.join(DATA, name)) as z:
        data, gold = z[key + "stream"].tobytes(), z[key + "decoded"]
    whole = host_assembly(engines, fmt, chans, data)
    eng = engines[fmt, chans, route]
    if route == "host":
        _, out = eng.decode(data)
        lo, hi = 0, gold.shape[0]
    else:
        lo, hi = 10 * N - 700, 13 * N - 700
        _, out = eng.decode_range(data, lo, hi - lo)
    check_layout(out, hi - lo, chans)
    near(out, gold[lo:hi])
    np.testing.assert_array_equal(out, whole[lo:hi])


@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("api", ["decode_many", "roundtrip_many"])
def test_batch_paths_equal_host_assembly(engines, streams, api, route):
    eng = engines["wak", 2, route]
    if api == "decode_many":
        datas = [streams["wak", 2, "plus_1"], streams["wak", 2, "minus_1"]]
        outs = eng.decode_many(datas)
    else:
        pcms = [pcm_of(2, LENGTHS["plus_1"], seed=6), pcm_of(2, 700, seed=7)]
        outs, datas = eng.roundtrip_many(pcms, return_streams=True)
    for (fs, out), data in zip(outs, datas):
        assert fs == 44100
        check_layout(out, read_header(data)[1], 2)
        np.testing.assert_array_equal(out,
                                      host_assembly(engines, "wak", 2, data))


WINDOWS = {                                  # (start, samples)
    "start": (0, 1500),
    "across_chunk_boundary": (CHUNK * N - 500, 1000),
    "end_of_stream": (-1500, 5000),          # from 1500 before the end
}


@pytest.mark.parametrize("window", list(WINDOWS))
@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("chans", [2, 1])
def test_decode_range_equals_host_assembly(engines, streams, chans, route,
                                           window):
    eng, data = engines["wak", chans, route], streams["wak", chans, "q6"]
    full = host_assembly(engines, "wak", chans, data)
    start, n = WINDOWS[window]
    if window == "end_of_stream":
        start += len(full)
    fs, out = eng.decode_range(data, start, n)
    lo, hi = start, min(len(full), start + n)
    assert fs == 44100
    check_layout(out, hi - lo, chans)
    np.testing.assert_array_equal(out, full[lo:hi])


@pytest.mark.parametrize("api, cblock", [
    ("decode", 0), ("decode", 3), ("decode", -1), ("decode_range", 3)])
def test_corrupt_channel_block_raises_with_its_number(engines, streams, api,
                                                      cblock):
    """On the device-parse route a channel-block of 0xFF bytes is flagged
    by the device and named, counted from the stream's first, by the
    flags that ride behind the interleaved PCM."""
    data = streams["wak", 2, "minus_1"]
    off = read_header(data)[2]
    spans, pos = [], off
    while pos < len(data):
        n = int.from_bytes(data[pos:pos + 4], "little")
        spans.append((pos + 4, pos + 4 + n))
        pos += 4 + n
    k = cblock % len(spans)
    bad = bytearray(data)
    bad[spans[k][0]:spans[k][1]] = b"\xff" * (spans[k][1] - spans[k][0])
    eng = engines["wak", 2, "device"]
    with pytest.raises(ValueError, match=f"at channel-block {k}$"):
        if api == "decode":
            eng.decode(bytes(bad))
        else:                     # blocks 1 and 2: channel-blocks 2 to 5
            eng.decode_range(bytes(bad), N + 10, N)


@pytest.mark.parametrize("api", ["decode", "decode_many", "roundtrip_many",
                                 "decode_range"])
def test_assemble_copies_nothing(engines, streams, api):
    """Under metrics.tracing() every assemble span counts copied 0 and the
    samples (a channel) the call returned."""
    eng = engines["wak", 2, "host"]
    data = streams["wak", 2, "plus_1"]
    M.reset()
    with M.tracing():
        if api == "decode":
            outs = [eng.decode(data)[1]]
        elif api == "decode_many":
            outs = [x for _, x in eng.decode_many([data, data])]
        elif api == "roundtrip_many":
            outs = [x for _, x in eng.roundtrip_many([pcm_of(2, N)])]
        else:
            outs = [eng.decode_range(data, 300, 600)[1]]
    spans = [s for s in M.spans() if s.name == "assemble"]
    M.reset()
    assert len(spans) == len(outs)
    assert [s.counts["copied"] for s in spans] == [0] * len(outs)
    assert [s.counts["samples"] for s in spans] == [len(x) for x in outs]
