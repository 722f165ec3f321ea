"""The port's native parse and repack over ranges of channel-blocks on
several host threads (pactpu_torch/csrc/wakbits_ranges.cc): equal, array
for array, to pactpu.native's serial parse and repack at 1, 2, 3 and 8
ranges, in the .wak and the .pac layout; a corrupt channel-block in a
later range named as the serial parse names it; and the number of ranges
a call ran, recorded on its span.

The long payloads repeat the whole-block payloads of a committed 1 s
stream (45 stereo blocks) until they hold thousands of channel-blocks,
less the last three: 3,597 channel-blocks, the last block's second
channel missing, so that no range count divides the 1,799 blocks."""

import ctypes
import os

import numpy as np
import pytest

from pactpu import native as jnative
from pactpu_torch import native as tnative
from pactpu_torch.codec.header import read_header
from pactpu_torch.utils import metrics as M
from test_torch_native_lut import count_codes
from torch_threads import torch_threads  # noqa: F401 (autouse)

FIXTURES = os.path.join(os.path.dirname(__file__), "data")
REPEATS = 40
N_CBLOCKS = 90 * REPEATS - 3
KEYS = ("overall", "table_id", "ba", "sf", "mant", "lrms", "n_cblocks")


def _offsets(payload: bytes) -> list:
    """Each channel-block's first byte (its byte count's) in `payload`."""
    out, pos = [], 0
    while pos + 4 <= len(payload):
        out.append(pos)
        pos += 4 + int.from_bytes(payload[pos:pos + 4], "little")
    assert pos == len(payload)
    return out


def _long(name: str, key: str):
    """(fields of the parse, payload): a committed stream's payload
    repeated REPEATS times, less its last three channel-blocks."""
    stream = np.load(os.path.join(FIXTURES, name))[key].tobytes()
    cfg, _, off = read_header(stream)
    payload = stream[off:] * REPEATS
    return cfg, payload[:_offsets(payload)[N_CBLOCKS]]


@pytest.fixture(scope="module")
def wak():
    return _long("torch_port_fixture.npz", "stream")


@pytest.fixture(scope="module")
def pac():
    return _long("torch_port_fixture_modes.npz", "stereo_pac_stream")


def _args(cfg, huff: bool) -> tuple:
    return (np.asarray(cfg.band_layout.n_lines, np.int32), cfg.n_scale_bits,
            cfg.n_mant_size_bits, cfg.n_table_id_bits if huff else 0)


def _parse(native, payload, cfg, huff, **kw):
    return native.unpack_file(payload, *_args(cfg, huff), read_lrms=huff,
                              n_channels=cfg.n_channels, **kw)


@pytest.mark.parametrize("layout", ["wak", "pac"])
@pytest.mark.parametrize("ranges", [1, 2, 3, 8])
def test_ranged_parse_equals_the_serial_parse(wak, pac, layout, ranges):
    """Every output of the ranged parse is the serial parse's, the last
    range's half block and its LRMS row included; .pac's is the
    raw-mantissa layout (no table id, no LRMS flags)."""
    cfg, payload = wak if layout == "wak" else pac
    huff = layout == "wak"
    gold = _parse(jnative, payload, cfg, huff)
    got = _parse(tnative, payload, cfg, huff, _ranges=ranges)
    assert gold["n_cblocks"] == N_CBLOCKS
    for k in KEYS:
        np.testing.assert_array_equal(got[k], gold[k], err_msg=k)


@pytest.mark.parametrize("ranges", [1, 2, 3, 8])
def test_ranged_repack_equals_the_serial_repack(wak, ranges):
    cfg, payload = wak
    parsed = _parse(jnative, payload, cfg, True)
    n_lines = _args(cfg, True)[0]
    gold = jnative.repack_codes(parsed["mant"], parsed["ba"], n_lines, 128)
    got = tnative.repack_codes(parsed["mant"], parsed["ba"], n_lines, 128,
                               _ranges=ranges)
    np.testing.assert_array_equal(got, gold)


def test_ranged_repack_overflow_raises_as_the_serial_one(wak):
    """A row too wide for its words in the last range raises."""
    cfg, payload = wak
    parsed = _parse(jnative, payload, cfg, True)
    n_lines = _args(cfg, True)[0]
    ba = parsed["ba"].copy()
    ba[-1] = 16
    with pytest.raises(RuntimeError, match="words buffer too small"):
        jnative.repack_codes(parsed["mant"], ba, n_lines, 128)
    with pytest.raises(RuntimeError, match="words buffer too small"):
        tnative.repack_codes(parsed["mant"], ba, n_lines, 128, _ranges=8)


def test_bad_table_id_in_a_later_range(wak):
    """A table id of 0 in channel-blocks of the sixth and the last of 8
    ranges: both parsers name the first of them."""
    cfg, payload = wak
    offs = _offsets(payload)
    bad = bytearray(payload)
    for i in (len(offs) * 5 // 8 + 3, len(offs) - 2):
        bad[offs[i] + 4] &= 0xF0         # overall scale, then table id 0
    first = len(offs) * 5 // 8 + 3
    for native, kw in ((jnative, {}), (tnative, {"_ranges": 8})):
        with pytest.raises(ValueError,
                           match=f"corrupt payload at channel-block {first}$"):
            _parse(native, bytes(bad), cfg, True, **kw)


def test_byte_count_past_the_end_in_a_later_range(wak):
    """A byte count in the seventh of 8 ranges that runs past the end of
    the payload.  The binding counts channel-blocks up to it, and both
    parsers return the same rows; given the count from before the
    corruption, the ranged entry returns the serial entry's -(i+1)."""
    cfg, payload = wak
    offs = _offsets(payload)
    i = len(offs) * 13 // 16
    bad = bytearray(payload)
    bad[offs[i]:offs[i] + 4] = (len(payload)).to_bytes(4, "little")
    bad = bytes(bad)
    gold = _parse(jnative, bad, cfg, True)
    got = _parse(tnative, bad, cfg, True, _ranges=8)
    assert gold["n_cblocks"] == i
    for k in KEYS:
        np.testing.assert_array_equal(got[k], gold[k], err_msg=k)

    n_lines, nsb, nmb, ntb = _args(cfg, True)
    r, total = len(offs), int(n_lines.sum())
    data = np.frombuffer(bad, np.uint8)

    def run(fn, *extra):
        out = [np.zeros(r, np.int32), np.zeros(r, np.int32),
               np.zeros((r, len(n_lines)), np.int32),
               np.zeros((r, len(n_lines)), np.int32),
               np.zeros((r, total), np.int32),
               np.zeros((-(-r // 2), len(n_lines)), np.int32)]
        i32p = ctypes.POINTER(ctypes.c_int32)
        return fn(data.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                  len(data), r, len(n_lines), n_lines.ctypes.data_as(i32p),
                  total, nsb, nmb, ntb, 1, 2,
                  *(a.ctypes.data_as(i32p) for a in out), *extra)

    serial = run(jnative._load().wak_unpack_file)
    assert serial == -(i + 1)
    assert run(tnative._load().wak_unpack_file_ranges, 8, None) == serial


def _traced(fn):
    M.reset()
    with M.tracing():
        fn()
    out = {s.name: s.counts for s in M.spans()}
    M.reset()
    return out


def test_a_pushs_32_channel_blocks_run_on_one_thread(wak):
    """A stream push's payload (16 stereo blocks) runs on the calling
    thread: both spans record threads 1; the parse ran the word loop (lut
    1) and counts the deep codes and escapes that a plain walk counts."""
    cfg, payload = wak
    offs = _offsets(payload)
    short = payload[:offs[32]]
    n_lines = _args(cfg, True)[0]

    parsed = _parse(tnative, short, cfg, True)
    assert parsed["n_cblocks"] == 32
    bits = int((parsed["ba"].astype(np.int64) @ n_lines).sum())

    def decode():
        _parse(tnative, short, cfg, True)
        tnative.repack_codes(parsed["mant"], parsed["ba"], n_lines, 128)

    counts = _traced(decode)
    deep, escapes = count_codes(short, cfg)
    assert counts["parse"] == {"bytes_in": len(short), "threads": 1,
                               "lut": 1, "deep": deep, "escapes": escapes}
    assert counts["repack"] == {"rows": 32, "words": 128, "bits": bits,
                                "threads": 1}


def test_thread_count_follows_cpus_and_min_range(wak):
    """Without `_ranges`, a call runs the smaller of the CPUs the process
    may use and its channel-blocks over MIN_RANGE."""
    cfg, payload = wak
    want = max(1, min(len(os.sched_getaffinity(0)),
                      N_CBLOCKS // tnative.MIN_RANGE))
    n_lines = _args(cfg, True)[0]

    def decode():
        parsed = _parse(tnative, payload, cfg, True)
        tnative.repack_codes(parsed["mant"], parsed["ba"], n_lines, 128)

    counts = _traced(decode)
    assert counts["parse"]["threads"] == counts["repack"]["threads"] == want
