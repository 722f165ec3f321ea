"""PyTorch port, the decoded PCM's layout: the decode's chunks are joined on
the device in the caller's layout (int16 [n, C], channels interleaved, the
MDCT-delay row dropped), so the host only slices the download.  Every
Engine decode path (decode, decode_many, roundtrip_many, decode_range; the
host-parse and device-parse routes; .wak and .pac; stereo and mono), the
StreamingDecoder and the distributed decode give the samples of the former
host assembly (the overlap-add [b + 1, C, N] transposed on the host) and
of pactpu; the device parser's corruption flags, downloaded behind the
PCM, still name their channel-block; the span "assemble" copies nothing.
The payload's channel-block framing has one walk (header.
scan_channel_blocks), whose faults frame_rows and decode_range name as
before and whose incomplete blocks a StreamingDecoder waits for."""

import os

import numpy as np
import pytest
import torch

from make_torch_port_fixture import fixture_pcm
from pactpu_torch import Engine, StreamingDecoder
from pactpu_torch.codec.header import read_header, scan_channel_blocks
from pactpu_torch.ops import huffman_decode as hd
from pactpu_torch.ops import quantize as q
from pactpu_torch.parallel import cluster, shard
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


def host_assembly(eng: Engine, data: bytes) -> np.ndarray:
    """The former assembly of a decode: the chunks' overlap-added PCM and
    the flush row joined as [b + 1, C, N], row 0 dropped, and transposed
    to [n, C] on the host.  eng: a host-parse Engine (the device-parse
    route's chunks give the same samples, test_torch_device_decode, and
    its plain walk takes tens of ms a block on the CPU)."""
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


def cblock_spans(data: bytes) -> list:
    """The (first, end) byte offsets in the stream of each channel-block's
    bytes, from a walk of its own over the byte-count prefixes."""
    spans, pos = [], read_header(data)[2]
    while pos < len(data):
        n = int.from_bytes(data[pos:pos + 4], "little")
        spans.append((pos + 4, pos + 4 + n))
        pos += 4 + n
    return spans


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
    np.testing.assert_array_equal(
        out, host_assembly(engines[fmt, chans, "host"], data))


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
    whole = host_assembly(engines[fmt, chans, "host"], data)
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
        np.testing.assert_array_equal(
            out, host_assembly(engines["wak", 2, "host"], data))


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
    full = host_assembly(engines["wak", chans, "host"], data)
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
    spans = cblock_spans(data)
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


def stream_decode(data: bytes, fmt: str, chunk_blocks: int, step: int):
    """A StreamingDecoder over `step`-byte pushes and its flush: each
    call's output, and the "download" spans each recorded."""
    dec = StreamingDecoder(fmt=fmt, chunk_blocks=chunk_blocks, device="cpu")
    calls = [lambda i=i: dec.push(data[i:i + step])
             for i in range(0, len(data), step)] + [dec.flush]
    outs, downloads = [], []
    for call in calls:
        M.reset()
        with M.tracing():
            outs.append(call())
        downloads.append(sum(x.name == "download" for x in M.spans()))
    M.reset()
    return outs, downloads


@pytest.mark.parametrize("length", list(LENGTHS))
@pytest.mark.parametrize("chunk_blocks", [1, 16])
@pytest.mark.parametrize("chans", [2, 1])
@pytest.mark.parametrize("fmt", ["wak", "pac"])
def test_streaming_decoder_equals_host_assembly(streams, fmt, chans,
                                                chunk_blocks, length):
    """StreamingDecoder's pushes and flush, joined, give the former host
    assembly's samples and Engine.decode's (the default chunking's, whose
    synthesis batches the stream's are); each call that returns samples
    downloads once and returns a C-contiguous view of that download."""
    data = streams[fmt, chans, length]
    eng = Engine(device="cpu", cfg=CodecConfig(n_channels=chans), fmt=fmt,
                 decode_parse="host")
    outs, downloads = stream_decode(data, fmt, chunk_blocks, step=777)
    for out, n in zip(outs, downloads):
        if out.size:
            assert n == 1 and out.dtype == np.int16
            assert out.flags.c_contiguous and not out.flags.owndata
    got = np.concatenate([o for o in outs if o.size])
    check_layout(got, read_header(data)[1], chans)
    np.testing.assert_array_equal(got, host_assembly(eng, data))
    np.testing.assert_array_equal(got, eng.decode(data)[1])


def pcm_range_host(mesh, outs, b, half, c, num_samples):
    """The former cluster._pcm_range: the shards' overlap-added blocks
    downloaded, joined and transposed on the host."""
    local = np.concatenate([q.float_to_pcm16(o).numpy() for o in outs])
    lo = mesh.shard_index(0) * outs[0].shape[0]
    t0, t1 = max(lo, 1), min(lo + local.shape[0], b + 1)
    pcm = local[t0 - lo:t1 - lo].transpose(1, 0, 2).reshape(c, -1).T
    start = (t0 - 1) * half
    return pcm[:max(0, num_samples - start)], start


@pytest.mark.parametrize("length", ["q6", "minus_1"])
@pytest.mark.parametrize("chans", [2, 1])
@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("n_shards", [1, 4])
def test_decode_distributed_equals_host_assembly(engines, streams,
                                                 monkeypatch, n_shards,
                                                 route, chans, length):
    """decode_distributed on 1 and 4 CPU shards, by the device parse and
    by the host route (_decode_distributed_dense), gives the former host
    assembly's samples from the same shard outputs, and assemble_pcm of
    its range is Engine.decode's within 1 LSB."""
    data = streams["wak", chans, length]
    mesh = shard.make_mesh(["cpu"] * n_shards)
    former = []
    real = cluster._pcm_range

    def both(*args):
        former.append(pcm_range_host(*args))
        return real(*args)

    monkeypatch.setattr(cluster, "_pcm_range", both)
    if route == "device":
        res = cluster.decode_distributed(data, mesh=mesh)
    else:
        cfg, _, off = read_header(data)
        res = cluster._decode_distributed_dense(data, off, cfg, mesh)
    (pcm, start), = former
    assert res.sample_start == start == 0
    assert res.pcm.dtype == np.int16 and res.pcm.flags.c_contiguous
    np.testing.assert_array_equal(res.pcm, pcm)
    got = cluster.assemble_pcm([(res.sample_start, res.pcm)],
                               res.num_samples)
    _, ref = engines["wak", chans, "host"].decode(data)
    assert got.shape == ref.shape
    assert int(np.abs(got.astype(np.int32) - ref).max()) <= 1


SCAN_FAULTS = {                # a payload's fault -> the parent's message
    "prefix_cut_short": "truncated channel-block header",
    "length_past_stream": "corrupt payload: channel-block length exceeds "
                          "the stream",
    "empty_payload": "no channel-blocks found in payload",
}


@pytest.mark.parametrize("case", [*SCAN_FAULTS, "one_byte_at_a_time"])
def test_channel_block_scan(engines, streams, case):
    """The one walk of the byte-count prefixes: on a payload cut inside a
    prefix, cut inside a channel-block's bytes, or empty, frame_rows and
    decode_range raise the parent's messages and the scan alone stops at
    the last whole channel-block; a StreamingDecoder fed one byte at a
    time returns no samples until the block after the first completes
    (the first's row is the MDCT delay), then every block's as it
    completes: Engine.decode's samples."""
    data = streams["wak", 2, "minus_1"]
    off = read_header(data)[2]
    spans = cblock_spans(data)
    if case == "one_byte_at_a_time":
        outs, _ = stream_decode(data, "wak", 1, step=1)
        # the push of byte i returns samples iff it completes a block
        # other than the first
        done = [end - 1 for _, end in spans[3::2]]
        assert [i for i, o in enumerate(outs[:-1]) if o.size] == done
        got = np.concatenate([o for o in outs if o.size])
        _, ref = Engine(device="cpu").decode(data)
        np.testing.assert_array_equal(got, ref)
        return
    cut = {"prefix_cut_short": spans[-1][0] - 2,
           "length_past_stream": spans[-1][1] - 1,
           "empty_payload": off}[case]
    bad = data[:cut]
    starts, sizes, end = scan_channel_blocks(bad, off)
    assert starts == [a for a, _ in spans[:len(starts)]]
    assert sizes == [z - a for a, z in spans[:len(starts)]]
    assert len(starts) == (0 if case == "empty_payload" else len(spans) - 1)
    assert end == (spans[-2][1] if starts else off)
    with pytest.raises(ValueError, match=f"^{SCAN_FAULTS[case]}$"):
        hd.frame_rows(bad[off:])
    with pytest.raises(ValueError, match=f"^{SCAN_FAULTS[case]}$"):
        engines["wak", 2, "host"].decode_range(bad, 0, 10 * N)
