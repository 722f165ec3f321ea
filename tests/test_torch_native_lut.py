"""The word-wide host parse and repack of the port's native runtime
(pactpu_torch/csrc/wakbits_ranges.cc) against csrc/wakbits.cc's serial
loop, both called from the one library under the one table set: the
result and every output array of wak_unpack_file_ranges equal to
wak_unpack_file's, and of wak_repack_codes_ranges to wak_repack_codes':

- valid input: .wak at 2.27 and 4.93 bits a sample, stereo and mono, and
  .pac (raw codes), at one range and at several; repack rows of every
  width, one that exactly fills its last word among them;
- corrupt input, where the result is the same and so are the rows of
  every channel-block before the first bad one (a block's lrms row, which
  its channel-blocks share, of every block before it): the payload cut at
  every byte of its last channel-blocks, and their byte counts cut to
  every shorter length; single-byte flips across a payload; a bad table
  id; a byte count past the end; a code that ends past its
  channel-block's last bit; a repack row one bit too wide (-1); and the
  parse of a payload that ends at an unreadable page loads nothing past
  its end;
- the span "parse" counts lut, deep and escapes, as a plain Python walk
  of the codes counts them;
- table sets the word loop cannot take (outside build_walk_lut's bounds,
  or a LUT that decodes a code otherwise than the trees) run the serial
  walk: lut 0, the same outputs.

The 4.93 streams are encoded here on the CPU (1 s of chip_smoke's music);
the others are the committed fixtures."""

import ctypes
import mmap
import os

import numpy as np
import pytest

import chip_smoke
from pactpu_torch import native as tnative
from pactpu_torch.codec import engine as te
from pactpu_torch.codec.header import read_header
from pactpu_torch.ops.huffman import load_tables
from pactpu_torch.ops.huffman_walk import K1, build_walk_lut
from pactpu_torch.utils import metrics as M
from pactpu_torch.utils.config import CodecConfig
from torch_threads import torch_threads  # noqa: F401 (autouse)

FIXTURES = os.path.join(os.path.dirname(__file__), "data")
STREAMS = ("wak-2.27-stereo", "wak-2.27-mono", "wak-4.93-stereo",
           "wak-4.93-mono", "pac-stereo")
ROWS = ("overall", "table_id", "ba", "sf", "mant")
I32 = ctypes.POINTER(ctypes.c_int32)
I64 = ctypes.POINTER(ctypes.c_int64)
U8 = ctypes.POINTER(ctypes.c_uint8)
U32 = ctypes.POINTER(ctypes.c_uint32)


@pytest.fixture(scope="module")
def lib():
    """The port's library with the serial entries' prototypes (on a handle
    of its own, so the binding's handle stays as it is)."""
    h = ctypes.CDLL(tnative._load()._name)
    h.wak_unpack_file.restype = ctypes.c_int64
    h.wak_unpack_file.argtypes = (
        [U8, ctypes.c_int64] + [ctypes.c_int] * 2 + [I32]
        + [ctypes.c_int] * 6 + [I32] * 6)
    h.wak_unpack_file_ranges.restype = ctypes.c_int64
    h.wak_unpack_file_ranges.argtypes = (
        h.wak_unpack_file.argtypes + [ctypes.c_int, I64])
    h.wak_repack_codes.restype = ctypes.c_int64
    h.wak_repack_codes.argtypes = ([ctypes.c_int] * 2 + [I32, ctypes.c_int]
                                   + [I32] * 2 + [U32, ctypes.c_int])
    h.wak_repack_codes_ranges.restype = ctypes.c_int64
    h.wak_repack_codes_ranges.argtypes = (h.wak_repack_codes.argtypes
                                          + [ctypes.c_int])
    return h


class Stream:
    """A stream's configuration, payload (past the header), layout
    (.wak: Huffman codes and LRMS flags) and channel-block spans."""

    def __init__(self, stream: bytes, huff: bool):
        self.cfg, _, off = read_header(stream)
        self.payload = stream[off:]
        self.huff = huff
        self.n_lines = np.asarray(self.cfg.band_layout.n_lines, np.int32)
        self.starts, pos = [], 0     # each channel-block's byte count
        while pos < len(self.payload):
            self.starts.append(pos)
            pos += 4 + int.from_bytes(self.payload[pos:pos + 4], "little")
        assert pos == len(self.payload)

    def head(self, n: int) -> bytes:
        """The payload of the first n channel-blocks."""
        return self.payload[:self.starts[n]]

    def fields(self) -> tuple:
        return (self.n_lines, self.cfg.n_scale_bits,
                self.cfg.n_mant_size_bits,
                self.cfg.n_table_id_bits if self.huff else 0)


@pytest.fixture(scope="module")
def streams():
    fx = np.load(os.path.join(FIXTURES, "torch_port_fixture.npz"))
    modes = np.load(os.path.join(FIXTURES, "torch_port_fixture_modes.npz"))
    out = {"wak-2.27-stereo": Stream(fx["stream"].tobytes(), True),
           "wak-2.27-mono": Stream(modes["mono_wak_stream"].tobytes(), True),
           "pac-stereo": Stream(modes["stereo_pac_stream"].tobytes(), False)}
    pcm = chip_smoke.synth(1.0, 11)
    for name, ch in (("stereo", 2), ("mono", 1)):
        eng = te.Engine(CodecConfig(target_bits_per_sample=4.93,
                                    n_channels=ch), "reservoir",
                        device="cpu")
        out[f"wak-4.93-{name}"] = Stream(eng.encode(pcm[:, :ch]), True)
    return out


def _parse(fn, s: Stream, payload: bytes, r: int, *extra) -> tuple:
    """fn's result over r channel-blocks of payload, and its outputs."""
    n_lines, nsb, nmb, ntb = s.fields()
    nb, total, c = len(n_lines), int(n_lines.sum()), s.cfg.n_channels
    out = dict(overall=np.zeros(r, np.int32), table_id=np.zeros(r, np.int32),
               ba=np.zeros((r, nb), np.int32), sf=np.zeros((r, nb), np.int32),
               mant=np.zeros((r, total), np.int32),
               lrms=np.zeros((-(-r // c), nb), np.int32))
    data = np.frombuffer(payload, np.uint8)
    rc = fn(data.ctypes.data_as(U8), len(data), r, nb,
            n_lines.ctypes.data_as(I32), total, nsb, nmb, ntb, int(s.huff),
            c, *(a.ctypes.data_as(I32) for a in out.values()), *extra)
    return rc, out


def _check(lib, s: Stream, payload: bytes, r: int, ranges: int = 1):
    """The word loop against the serial loop on r channel-blocks of
    payload: the same result, and the same rows before the first bad
    channel-block.  Returns (result, counts)."""
    want_rc, want = _parse(lib.wak_unpack_file, s, payload, r)
    counts = np.zeros(3, np.int64)
    got_rc, got = _parse(lib.wak_unpack_file_ranges, s, payload, r, ranges,
                         counts.ctypes.data_as(I64))
    assert got_rc == want_rc
    good = r if want_rc >= 0 else -want_rc - 1
    c = s.cfg.n_channels
    rows = dict.fromkeys(ROWS, good)
    rows["lrms"] = -(-good // c) if want_rc >= 0 else good // c
    for k, n in rows.items():
        if not np.array_equal(got[k][:n], want[k][:n]):
            np.testing.assert_array_equal(got[k][:n], want[k][:n], err_msg=k)
    return want_rc, counts


@pytest.fixture(autouse=True)
def shipped_tables():
    """Every test parses under the shipped set, whose LUT the library
    takes."""
    assert tnative.init_tables() == 1


# -- a plain walk of the codes ------------------------------------------------

def walk_codes(body: bytes, cfg, tables) -> list:
    """(first bit, end bit, length, escape) of each Huffman code of a valid
    .wak channel-block body, an escape's raw bits not counted in its
    length: a plain Python walk of the codes that reads the dense tables
    directly."""
    bits = "".join(f"{b:08b}" for b in body)
    pos = 0

    def read(n):
        nonlocal pos
        pos += n
        return int(bits[pos - n:pos] or "0", 2)

    lengths, codes, esc_len, esc_codes = tables
    read(cfg.n_scale_bits)
    t = read(cfg.n_table_id_bits) - 1
    book = {(int(lengths[t, s]), int(codes[t, s])): False
            for s in np.nonzero(lengths[t])[0]}
    book[(int(esc_len[t]), int(esc_codes[t]))] = True
    out = []
    for nl in cfg.band_layout.n_lines:
        a = read(cfg.n_mant_size_bits)
        read(cfg.n_scale_bits)
        if not a:
            continue
        read(nl)                                  # sign bits
        for _ in range(nl):
            first, n = pos, 1
            while (n, int(bits[first:first + n], 2)) not in book:
                n += 1
            pos = first + n
            esc = book[(n, int(bits[first:first + n], 2))]
            if esc:
                read(a + 1)
            out.append((first, pos, n, esc))
    return out


def count_codes(payload: bytes, cfg) -> tuple:
    """(codes longer than the LUT's root bits, escapes) of a valid .wak
    payload, by walk_codes."""
    tables = load_tables()
    deep = esc = 0
    pos = 0
    while pos < len(payload):
        n = int.from_bytes(payload[pos:pos + 4], "little")
        for _, _, length, e in walk_codes(payload[pos + 4:pos + 4 + n], cfg,
                                          tables):
            deep += length > K1
            esc += e
        pos += 4 + n
    return deep, esc


# -- valid input --------------------------------------------------------------

@pytest.mark.parametrize("ranges", [1, 4])
@pytest.mark.parametrize("name", STREAMS)
def test_parse_equals_the_serial_parse(lib, streams, name, ranges):
    s = streams[name]
    r = len(s.starts)
    rc, counts = _check(lib, s, s.payload, r, ranges)
    assert rc == len(s.payload)
    assert counts[0] == 1


@pytest.mark.parametrize("ranges", [1, 4])
@pytest.mark.parametrize("name", ["wak-4.93-stereo", "wak-2.27-mono",
                                  "pac-stereo"])
def test_parse_counts_lut_deep_and_escapes(streams, name, ranges):
    """The binding's span: lut 1, and the deep codes and escapes of a plain
    walk (none in .pac, which has no Huffman codes)."""
    s = streams[name]
    M.reset()
    with M.tracing():
        tnative.unpack_file(s.payload, *s.fields(), read_lrms=s.huff,
                            n_channels=s.cfg.n_channels, _ranges=ranges)
    counts = {sp.name: sp.counts for sp in M.spans()}["parse"]
    M.reset()
    deep, esc = count_codes(s.payload, s.cfg) if s.huff else (0, 0)
    assert (counts["lut"], counts["deep"], counts["escapes"]) == (1, deep,
                                                                  esc)
    if name == "wak-4.93-stereo":
        assert deep > 0 and esc > 0


def _repack(lib, s: Stream, ba, mant, n_words, ranges):
    """(result, words) of the serial and of the ranged repack."""
    out = []
    for fn, extra in ((lib.wak_repack_codes, ()),
                      (lib.wak_repack_codes_ranges, (ranges,))):
        ba_ = np.ascontiguousarray(ba, np.int32)
        m_ = np.ascontiguousarray(mant, np.int32)
        words = np.zeros((len(ba_), n_words), np.uint32)
        rc = fn(len(ba_), len(s.n_lines), s.n_lines.ctypes.data_as(I32),
                int(s.n_lines.sum()), ba_.ctypes.data_as(I32),
                m_.ctypes.data_as(I32), words.ctypes.data_as(U32), n_words,
                *extra)
        out.append((rc, words))
    return out


@pytest.mark.parametrize("ranges", [1, 4])
@pytest.mark.parametrize("name", ["wak-2.27-stereo", "wak-4.93-stereo",
                                  "wak-4.93-mono"])
def test_repack_equals_the_serial_repack(lib, streams, name, ranges):
    """The parsed codes at the engine's widest-row width, and with garbage
    above each line's bits (every bit allocation from 0 to 32)."""
    s = streams[name]
    _, parsed = _parse(lib.wak_unpack_file, s, s.payload, len(s.starts))
    bits = (parsed["ba"].astype(np.int64) @ s.n_lines.astype(np.int64))
    (want, ww), (got, gw) = _repack(lib, s, parsed["ba"], parsed["mant"],
                                    -(-int(bits.max()) // 32), ranges)
    assert want == got == bits.max()
    np.testing.assert_array_equal(gw, ww)

    rng = np.random.default_rng(5)
    ba = rng.integers(0, 33, parsed["ba"].shape)
    mant = rng.integers(-2 ** 31, 2 ** 31, parsed["mant"].shape)
    width = int((ba @ s.n_lines.astype(np.int64)).max())
    (want, ww), (got, gw) = _repack(lib, s, ba, mant, -(-width // 32) + 3,
                                    ranges)
    assert want == got == width
    np.testing.assert_array_equal(gw, ww)


def _ba_with_bits(s: Stream, rows: int, rem: int, seed: int) -> np.ndarray:
    """Bit allocations in [0, 16] whose rows hold bits = rem (mod 32)."""
    rng = np.random.default_rng(seed)
    out = []
    while len(out) < rows:
        ba = rng.integers(0, 17, len(s.n_lines))
        if int(ba @ s.n_lines) % 32 == rem:
            out.append(ba)
    return np.array(out)


@pytest.mark.parametrize("ranges", [1, 3])
def test_repack_row_that_fills_its_last_word(lib, streams, ranges):
    """Rows whose bits are a multiple of 32, the widest at exactly
    n_words words."""
    s = streams["wak-4.93-stereo"]
    ba = _ba_with_bits(s, 9, 0, 1)
    mant = np.random.default_rng(2).integers(
        -2 ** 31, 2 ** 31, (9, int(s.n_lines.sum())))
    width = int((ba @ s.n_lines).max())
    (want, ww), (got, gw) = _repack(lib, s, ba, mant, width // 32, ranges)
    assert want == got == width
    np.testing.assert_array_equal(gw, ww)


@pytest.mark.parametrize("ranges", [1, 3])
def test_repack_row_one_bit_too_wide(lib, streams, ranges):
    """A row of 32 * n_words + 1 bits: -1 from both, and the binding
    raises."""
    s = streams["wak-4.93-stereo"]
    ba = _ba_with_bits(s, 9, 1, 3)
    mant = np.zeros((9, int(s.n_lines.sum())), np.int32)
    width = int((ba @ s.n_lines).max())
    (want, _), (got, _) = _repack(lib, s, ba, mant, width // 32, ranges)
    assert want == got == -1
    with pytest.raises(RuntimeError, match="words buffer too small"):
        tnative.repack_codes(mant, ba, s.n_lines, width // 32,
                             _ranges=ranges)


def test_repack_outside_the_word_loop_runs_the_serial_loop(lib, streams):
    """A bit allocation past 32 or below 0 takes the serial loop for its
    range: the same words."""
    s = streams["wak-2.27-stereo"]
    rng = np.random.default_rng(4)
    ba = rng.integers(0, 9, (8, len(s.n_lines)))
    ba[5, 3], ba[6, 2] = 40, -2
    mant = rng.integers(0, 2 ** 8, (8, int(s.n_lines.sum())))
    (want, ww), (got, gw) = _repack(lib, s, ba, mant, 1024, 2)
    assert want == got
    np.testing.assert_array_equal(gw, ww)


# -- corrupt input ------------------------------------------------------------

def _with_count(payload: bytes, start: int, n: int) -> bytes:
    """payload with the channel-block at byte `start` cut to n bytes."""
    return (payload[:start] + n.to_bytes(4, "little")
            + payload[start + 4:start + 4 + n]
            + payload[start + 4 + int.from_bytes(payload[start:start + 4],
                                                 "little"):])


@pytest.mark.parametrize("name", STREAMS)
def test_truncations_at_every_byte_of_the_last_channel_blocks(lib, streams,
                                                              name):
    """Four channel-blocks: the payload cut at every byte of the last two,
    and each of those two cut to every shorter byte count."""
    s = streams[name]
    payload = s.head(4)
    first = s.starts[2]
    for cut in range(first, len(payload)):
        rc, _ = _check(lib, s, payload[:cut], 4)
        assert rc < 0
    for i in (2, 3):
        nbytes = int.from_bytes(payload[s.starts[i]:s.starts[i] + 4],
                                "little")
        for n in range(nbytes):
            rc, _ = _check(lib, s, _with_count(payload, s.starts[i], n), 4,
                           ranges=2)
            assert rc == -(i + 1)


@pytest.mark.parametrize("name", ["wak-2.27-stereo", "wak-4.93-stereo",
                                  "wak-4.93-mono", "pac-stereo"])
def test_single_byte_flips(lib, streams, name):
    """Every byte of four channel-blocks (byte counts included) flipped by
    a seeded nonzero mask, one at a time, at 1 and 2 ranges."""
    s = streams[name]
    payload = s.head(4)
    masks = np.random.default_rng(7).integers(1, 256, len(payload))
    bad = 0
    for p, m in enumerate(masks):
        flipped = bytearray(payload)
        flipped[p] ^= int(m)
        rc, _ = _check(lib, s, bytes(flipped), 4, ranges=1 + p % 2)
        bad += rc < 0
    assert 0 < bad < len(payload)


def test_parse_loads_nothing_past_the_payload(lib, streams):
    """Two channel-blocks, the last cut to every shorter byte count, placed
    so that the payload ends where an unreadable page begins: a load past
    the end would fault.  Results as the serial loop's."""
    s = streams["wak-4.93-stereo"]
    page = mmap.PAGESIZE
    area = mmap.mmap(-1, 4 * page)
    first = ctypes.c_char.from_buffer(area)
    base = ctypes.addressof(first)
    libc = ctypes.CDLL(None)
    libc.mprotect.argtypes = [ctypes.c_void_p, ctypes.c_size_t, ctypes.c_int]
    assert libc.mprotect(base + 3 * page, page, 0) == 0   # PROT_NONE
    payload = s.head(2)
    nbytes = int.from_bytes(payload[s.starts[1]:s.starts[1] + 4], "little")
    n_lines, nsb, nmb, ntb = s.fields()
    nb, total = len(n_lines), int(n_lines.sum())
    try:
        for n in range(nbytes + 1):
            cut = _with_count(payload, s.starts[1], n)
            at = base + 3 * page - len(cut)
            ctypes.memmove(at, cut, len(cut))
            want, _ = _check(lib, s, cut, 2)
            out = [np.zeros(2, np.int32), np.zeros(2, np.int32),
                   np.zeros((2, nb), np.int32), np.zeros((2, nb), np.int32),
                   np.zeros((2, total), np.int32), np.zeros((1, nb), np.int32)]
            got = lib.wak_unpack_file_ranges(
                ctypes.cast(at, U8), len(cut), 2, nb,
                n_lines.ctypes.data_as(I32), total, nsb, nmb, ntb, 1, 2,
                *(a.ctypes.data_as(I32) for a in out), 1, None)
            assert got == want == (len(cut) if n == nbytes else -2)
    finally:
        libc.mprotect(base + 3 * page, page,
                      mmap.PROT_READ | mmap.PROT_WRITE)
        del first
        area.close()


def _set_bits(body: bytearray, pos: int, n: int, value: int) -> None:
    for k in range(n):
        byte, bit = divmod(pos + k, 8)
        if (value >> (n - 1 - k)) & 1:
            body[byte] |= 0x80 >> bit
        else:
            body[byte] &= ~(0x80 >> bit) & 0xFF


@pytest.mark.parametrize("tid", [0, 11, 15])
@pytest.mark.parametrize("name", ["wak-2.27-stereo", "wak-4.93-mono"])
def test_bad_table_id(lib, streams, name, tid):
    """A table id outside [1, 10] in the fourth of six channel-blocks."""
    s = streams[name]
    bad = bytearray(s.head(6))
    _set_bits(bad, 8 * (s.starts[3] + 4) + s.cfg.n_scale_bits,
              s.cfg.n_table_id_bits, tid)
    for ranges in (1, 3):
        rc, _ = _check(lib, s, bytes(bad), 6, ranges)
        assert rc == -4


@pytest.mark.parametrize("name", STREAMS)
def test_byte_count_past_the_end(lib, streams, name):
    s = streams[name]
    bad = bytearray(s.head(6))
    bad[s.starts[4]:s.starts[4] + 4] = len(bad).to_bytes(4, "little")
    for ranges in (1, 3):
        rc, _ = _check(lib, s, bytes(bad), 6, ranges)
        assert rc == -5


@pytest.mark.parametrize("kind", ["root", "deep", "escape"])
def test_code_that_ends_past_the_last_bit(lib, streams, kind):
    """A channel-block's byte count cut inside one of its codes (one of at
    most 11 bits, one longer, or an escape's raw bits), found by the plain
    walk: its codes end past its last bit."""
    s = streams["wak-4.93-stereo"]
    tables = load_tables()
    payload = s.head(8)
    for i in range(8):
        body = payload[s.starts[i] + 4:
                       s.starts[i] + 4 + int.from_bytes(
                           payload[s.starts[i]:s.starts[i] + 4], "little")]
        for first, end, n, esc in walk_codes(body, s.cfg, tables):
            code_end = first + n
            straddle = (end if kind == "escape" else code_end) - 1
            if ((kind == "escape") == esc
                    and (kind == "deep") == (n > K1)
                    and first // 8 < straddle // 8
                    and (kind != "escape" or code_end <= 8 * (straddle // 8))):
                cut = straddle // 8            # bytes: ends mid-code
                rc, _ = _check(lib, s, _with_count(payload, s.starts[i], cut),
                               8)
                assert rc == -(i + 1)
                return
    pytest.fail(f"no {kind} code crosses a byte boundary")


# -- table sets the word loop cannot take -------------------------------------

def _copy_tables():
    return tuple(np.array(a, copy=True) for a in load_tables())


def test_table_set_outside_the_luts_bounds_runs_the_tree_walk(lib, streams):
    """A 32-bit code in one table: build_walk_lut returns None, the parse
    counts lut 0 and its outputs are the serial walk's."""
    tables = _copy_tables()
    sym = int(np.nonzero(tables[0][9] == 0)[0][-1])
    tables[0][9, sym], tables[1][9, sym] = 32, 0x7FFFFFFF
    assert build_walk_lut(tables) is None
    s = streams["wak-4.93-stereo"]
    assert tnative.init_tables(tables) == 0
    M.reset()
    with M.tracing():
        tnative.unpack_file(s.payload, *s.fields(), tables=tables,
                            _ranges=3)
    counts = {sp.name: sp.counts for sp in M.spans()}["parse"]
    M.reset()
    assert (counts["lut"], counts["deep"], counts["escapes"]) == (0, 0, 0)
    for ranges in (1, 3):
        rc, counts = _check(lib, s, s.payload, len(s.starts), ranges)
        assert rc == len(s.payload) and counts[0] == 0


def test_lut_that_decodes_otherwise_than_the_trees_is_refused(lib, streams):
    """A symbol given its table's escape code: the tree decodes the symbol
    (inserted after the escape), the LUT the escape.  The library takes no
    LUT, and the parse is the serial walk's."""
    tables = _copy_tables()
    sym = int(np.nonzero(tables[0][2] == 0)[0][-1])
    tables[0][2, sym], tables[1][2, sym] = tables[2][2], tables[3][2]
    assert build_walk_lut(tables) is not None
    assert tnative.init_tables(tables) == 0
    s = streams["wak-2.27-stereo"]
    for ranges in (1, 3):
        _, counts = _check(lib, s, s.payload, len(s.starts), ranges)
        assert counts[0] == 0
