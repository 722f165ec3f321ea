"""The port on spoken word coded mono at 22.05 kHz (the benchmark's
wak-mono-22k configuration), on the CPU, against pactpu's Engine and the
port's float64 oracle (`pactpu_torch.compat.refcodec`):

- the float32 reservoir encode against pactpu's at the same
  configuration: the same allocation and scale factors in every band
  that has lines (the two bands of no lines may part, as fault (b) lets
  them), the stream within 0.1 dB SNR and 1% size (or byte-equal), and
  pactpu's stream decoded by the port within 1 LSB of pactpu's decode;

- the float64 exact encode byte-equal to the oracle (fault (p): the
  oracle could not code a block of this layout, whose last two bands
  hold no line);
- the float32 reservoir encode's extraBits the oracle's reservoir replay
  of the encode's own measurement pass;
- the decode within 1 LSB of the oracle's decoder on the program's
  stream, and `decode_range` and 16-block `StreamingDecoder` pushes
  equal to it;
- the two bands of no lines carry no mantissa bit: their fields hold the
  water-fill's free grants, and the stream with both fields rewritten to
  0 decodes to the same samples;
- a streamed decode's root span `decode_push` holds its parse and
  repack;
- a streamed decode synthesizes each push at the row width of the first
  of the Engine's decode layouts that holds its widest row, not at the
  row's own bucket (fault (q): its program was keyed by each push's
  widest row, so a decoder captured programs in the middle of a
  stream).

The input is seeded pulse-train speech: a spurt, a pause at a -60 dBFS
noise floor, a spurt."""

import numpy as np
import pytest

import chip_smoke
from pactpu.codec import engine as je
from pactpu.utils.config import CodecConfig as JaxConfig
from pactpu_torch.codec import engine as te
from pactpu_torch.codec.stream import StreamingDecoder
from pactpu_torch.compat import refcodec as rc
from pactpu_torch.utils import metrics as M
from pactpu_torch.utils.config import CodecConfig
from torch_threads import torch_threads  # noqa: F401 (autouse)

FS = 22050
CFG = CodecConfig(sample_rate=FS, n_channels=1)


def speech(seed: int = 5, seconds: float = 3.2) -> np.ndarray:
    """int16 [n, 1]: a glottal pulse train at a drifting F0 through two
    resonators, at about -18 dBFS, with a pause of 0.6 s holding a -60
    dBFS noise floor from 1.3 s."""
    rng = np.random.default_rng(seed)
    n = int(seconds * FS)
    t = np.arange(n) / FS
    f0 = 120 * 2 ** (0.1 * np.sin(2 * np.pi * t / 1.7 + rng.uniform(0, 6)))
    pulse = (np.diff(np.floor(np.cumsum(f0 / FS)), prepend=0) > 0) * 1.0
    x = pulse
    for f, bw in ((700.0, 80.0), (1700.0, 120.0)):
        r = np.exp(-np.pi * bw / FS)
        a1, a2 = -2 * r * np.cos(2 * np.pi * f / FS), r * r
        y = np.zeros(n)
        for i in range(n):
            y[i] = x[i] - a1 * y[i - 1] - a2 * y[i - 2]
        x = y
    x += 0.3 * rng.standard_normal(n) * np.std(x) * (rng.random(n) < 0.05)
    x *= 32767 * 10 ** (-18 / 20) / np.sqrt(np.mean(x ** 2))
    x[int(1.3 * FS):int(1.9 * FS)] = 0.0
    x += 32767 * 10 ** (-60 / 20) * rng.standard_normal(n)
    return np.clip(np.round(x), -32767, 32767).astype(np.int16)[:, None]


@pytest.fixture(scope="module")
def pcm():
    return speech()


@pytest.fixture(scope="module")
def coded(pcm):
    """The float32 reservoir encode: (Engine, stream, its decode)."""
    eng = te.Engine(CFG, "reservoir", device="cpu")
    stream = eng.encode(pcm)
    return eng, stream, eng.decode(stream)[1]


def test_layout_has_two_bands_of_no_lines():
    assert tuple(CFG.band_layout.n_lines[-2:]) == (0, 0)
    assert sum(CFG.band_layout.n_lines) == CFG.n_mdct_lines


def side_info(stream: bytes) -> tuple:
    """Each block's allocation and scale factors, [blocks, C, bands]."""
    cfg, _, off = rc.read_header(stream)
    tabs = rc.HuffmanTables.load()
    ba, sf = [], []
    while off < len(stream):
        got = rc.unpack_block(stream, off, cfg, tabs)
        ba.append(got[0])
        sf.append(got[1])
        off = got[-1]
    return np.asarray(ba), np.asarray(sf)


def test_reservoir_against_pactpu(pcm, coded):
    """As tests/test_torch_generality.py's cases at 22.05 kHz stereo hold
    the port: the streams part in a float stage of the analysis (ROADMAP
    queue 3 (f)), so byte-equal passes, else the SNR and size rule; the
    side information is equal in every band that has lines."""
    _, mine, mine_pcm = coded
    jeng = je.Engine(cfg=JaxConfig(sample_rate=FS, n_channels=1),
                     rate_mode="reservoir")
    gold = jeng.encode(pcm)
    _, gold_pcm = jeng.decode(gold)
    if mine != gold:
        snr = [chip_smoke.snr_db(pcm, x) for x in (mine_pcm, gold_pcm)]
        assert abs(snr[0] - snr[1]) <= 0.1
        assert abs(len(mine) - len(gold)) <= 0.01 * len(gold)
    lines = np.asarray(CFG.band_layout.n_lines) > 0
    for a, b in zip(side_info(mine), side_info(gold)):
        assert a.shape == b.shape
        np.testing.assert_array_equal(a[..., lines], b[..., lines])
    _, cross = te.Engine(CFG, "reservoir", device="cpu").decode(gold)
    assert cross.shape == gold_pcm.shape == mine_pcm.shape
    assert np.abs(cross.astype(np.int32)
                  - gold_pcm.astype(np.int32)).max() <= 1


def test_f64_exact_equals_the_oracle(pcm):
    mine = te.Engine(CFG, "exact", precision="f64", device="cpu").encode(
        pcm[:FS * 2])
    assert mine == rc.encode_file(pcm[:FS * 2], FS, CFG)


def test_reservoir_extras_are_the_oracles_replay(coded):
    eng, _, _ = coded
    savings, leftover = (np.asarray(a, np.int64) for a in eng.last_measure)
    res = rc.Reservoir(divisor=CFG.reservoir_withdraw_divisor)
    want, extra = [], 0
    for s, left in zip(savings, leftover):
        extra += res.take()
        want.append(extra)
        for v in s:
            res.put(int(v))
        extra = int(left)
    np.testing.assert_array_equal(np.asarray(eng.last_extras, np.int64),
                                  want)
    # the pause deposits, the spurt after it borrows
    assert max(want) > 0


def test_decode_within_one_lsb_of_the_oracle(coded, pcm):
    _, stream, out = coded
    fs, gold = rc.decode_file(stream)
    assert fs == FS and out.shape == gold.shape == pcm.shape
    assert np.abs(out.astype(np.int32) - gold).max() <= 1


def test_range_and_streamed_decode_equal_the_decode(coded):
    eng, stream, out = coded
    lo, hi = 20_000, 51_000
    _, part = eng.decode_range(stream, lo, hi - lo)
    np.testing.assert_array_equal(part, out[lo:hi])
    dec = StreamingDecoder(chunk_blocks=16, device="cpu")
    pieces = [dec.push(stream[i:i + 3001])
              for i in range(0, len(stream), 3001)] + [dec.flush()]
    np.testing.assert_array_equal(np.concatenate(pieces), out)


def repacked(stream: bytes, fields) -> bytes:
    """stream with each block re-packed by the oracle after
    fields(ba, sf) rewrote its allocation and scale factors."""
    cfg, _, off = rc.read_header(stream)
    tabs = rc.HuffmanTables.load()
    n_lines = np.asarray(cfg.band_layout.n_lines)
    out = bytearray(stream[:off])
    while off < len(stream):
        ba, sf, mant, osc, lrms, off = rc.unpack_block(stream, off, cfg,
                                                       tabs)
        fields(ba, sf)
        blk = rc.EncodedBlock(list(osc), [], [], [], [], [], [], lrms)
        for c in range(cfg.n_channels):
            bits = np.repeat(ba[c], n_lines)
            sel = bits > 0
            m, b = mant[c][sel], bits[sel]
            tid, codes, lens = tabs.encode_best(
                m & ((np.int64(1) << (b - 1)) - 1), b)
            for key, v in (("table_id", tid), ("bit_alloc", ba[c]),
                           ("scale_factor", sf[c]),
                           ("sign_bits", m >> (b - 1)),
                           ("huff_codes", codes), ("huff_lengths", lens)):
                getattr(blk, key).append(v)
        out += rc.pack_block(blk, cfg)
    return bytes(out)


def test_bands_of_no_lines_carry_no_mantissa_bit(coded):
    eng, stream, out = coded
    empty = np.asarray(CFG.band_layout.n_lines) == 0
    cfg, _, off = rc.read_header(stream)
    ba, sf = rc.unpack_block(stream, off, cfg, rc.HuffmanTables.load())[:2]
    assert (ba[0][empty] > 0).all()     # the free grants

    def zero(ba, sf):
        ba[:, empty] = 0
        sf[:, empty] = 0
    assert repacked(stream, lambda ba, sf: None) == stream
    quiet = repacked(stream, zero)
    assert quiet != stream and len(quiet) == len(stream)
    np.testing.assert_array_equal(eng.decode(quiet)[1], out)


def test_streamed_decode_has_a_root_span(coded):
    _, stream, _ = coded
    dec = StreamingDecoder(chunk_blocks=16, device="cpu")
    M.reset()
    with M.tracing():
        dec.push(stream[:9000])
        dec.flush()
    spans = M.spans()
    M.reset()
    roots = [s for s in spans if s.name == "decode_push"]
    assert len(roots) == 2 and all(s.parent is None for s in roots)
    assert sum(s.counts["blocks"] for s in roots) > 16
    names = {s.name for s in spans if s.parent in {r.id for r in roots}}
    assert {"parse", "repack", "download"} <= names


def test_streamed_decode_keeps_one_row_width(pcm, monkeypatch):
    """Silence (rows of no mantissa bit), then speech (rows of 96 words)."""
    eng = te.Engine(CFG, "reservoir", device="cpu")
    stream = eng.encode(np.concatenate([np.zeros((40 * 1024, 1), np.int16),
                                        pcm[:FS]]))
    out = eng.decode(stream)[1]
    dec = StreamingDecoder(chunk_blocks=16, device="cpu")
    dec.push(stream[:200])
    eng = dec._eng
    parse, run_stage = eng._host_parse, eng._run_stage
    rows, widths = [], []

    def host_parse(payload, cfg, **kw):
        got = parse(payload, cfg, **kw)
        # the words of the push's widest row
        rows.append(-(-int(got[2].max(initial=0)) // 32))
        return got

    def stage(name, programmed, blocks, key, fn, args):
        widths.append(args[2].shape[-1])
        return run_stage(name, programmed, blocks, key, fn, args)
    monkeypatch.setattr(eng, "_host_parse", host_parse)
    monkeypatch.setattr(eng, "_run_stage", stage)
    pieces = [dec.push(stream[i:i + 3001])
              for i in range(200, len(stream), 3001)] + [dec.flush()]
    buckets = [next(w for w in te._WORD_BUCKETS if w >= r) for r in rows]
    assert len(set(buckets)) > len(set(widths)), (buckets, widths)
    assert widths == [te.decode_layout(r)[1] for r in rows]
    np.testing.assert_array_equal(np.concatenate(pieces), out)
