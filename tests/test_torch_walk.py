"""PyTorch port, device-side Huffman parse: host framing, the two-level
LUT, the plain-tensor walk (huffman_decode.parse_rows) and the kernel's
route on the CPU (huffman_walk.parse_rows_walk = plain K5 + post-pass)
against pactpu's XLA walk, bit for bit in all seven outputs, on clean and
corrupt rows, and once against the Pallas walk kernel in interpret mode."""

import numpy as np
import pytest
import torch

from pactpu.codec import engine as je
from pactpu.compat import refcodec as rc
from pactpu.ops import huffman_decode as jhd
from pactpu.ops import huffman_walk as jhw
from pactpu.utils.config import CodecConfig
from pactpu_torch import Engine
from pactpu_torch.ops import huffman_decode as hd
from pactpu_torch.ops import huffman_walk as hw
from pactpu_torch.ops import kernels as K
from pactpu_torch.ops.huffman import load_tables
from pactpu_torch.ops.psycho import layout_tensors
from pactpu_torch.utils.config import CodecConfig as TorchConfig

KEYS = ("overall", "tid", "ba", "sf", "mant", "lrms", "bad")


def _tone_pcm(n=5 * 1024 + 321, seed=3):
    rng = np.random.default_rng(seed)
    t = np.arange(n) / 44100.0
    sig = (np.stack([np.sin(2 * np.pi * f * t) for f in (440, 661)], 1)
           * 20000 + rng.standard_normal((n, 2)) * 400)
    return np.clip(sig, -32768, 32767).astype(np.int16)


@pytest.fixture(scope="module")
def streams():
    """pactpu Engine.encode of tone input at the default rate and at
    4.93 bits/sample (long codes and escapes)."""
    out = {}
    for name, bps, seed in (("default", 2.27, 3), ("high_rate", 4.93, 11)):
        cfg = CodecConfig(target_bits_per_sample=bps)
        out[name] = je.Engine(cfg=cfg, chunk_blocks=16).encode(
            _tone_pcm(seed=seed))
    return out


def _rows(stream: bytes):
    cfg, _, off = rc.read_header(stream)
    return cfg, stream[off:]


def _clean(words, nbits):
    return words, nbits


def _flipped(words, nbits):
    """Every third row gets one word XORed with random bits."""
    words = words.copy()
    rng = np.random.default_rng(0)
    for r in range(0, words.shape[0], 3):
        w = rng.integers(0, max(1, nbits[r] // 32))
        words[r, w] ^= np.uint32(rng.integers(1, 1 << 32))
    return words, nbits


def _zero_and_short(words, nbits):
    words, nbits = words.copy(), nbits.copy()
    nbits[0] = 0
    words[0] = 0
    nbits[2] = 16                                # truncated row -> bad
    return words, nbits


def _bad_table_id(words, nbits):
    """tid is the 4 bits after the 4-bit overall scale: force 15 and 0."""
    words = words.copy()
    words[0] = (words[0] & ~np.uint32(0x0F000000)) | np.uint32(0x0F000000)
    words[1] = words[1] & ~np.uint32(0x0F000000)
    return words, nbits


def _assert_equal(got: dict, ref: dict):
    for k in KEYS:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(ref[k]),
                                      err_msg=k)


@pytest.mark.parametrize("stream", ["default", "high_rate"])
def test_frame_rows_matches(streams, stream):
    _, payload = _rows(streams[stream])
    words, nbits = jhd.frame_rows(payload)
    mine_w, mine_n = hd.frame_rows(payload)
    assert mine_w.dtype == np.uint32 and mine_n.dtype == np.int32
    np.testing.assert_array_equal(mine_w, words)
    np.testing.assert_array_equal(mine_n, nbits)
    assert hd.frame_rows(payload, word_cap=4) == (None, None)
    with pytest.raises(ValueError):
        hd.frame_rows(payload[:-3])
    with pytest.raises(ValueError):
        hd.frame_rows(b"")


def test_walk_lut_decodes_every_codeword():
    """Each codeword of the shipped tables (and each escape code),
    left-aligned in a 32-bit peek with ones behind it, resolves through
    the two-level LUT to its symbol and length."""
    lengths, codes, esc_len, esc_codes = load_tables()
    lut = hw.build_walk_lut()
    assert lut["l1"].shape == (10, 2048) and lut["l1b"].shape == (10, 128)
    assert lut["l2"].shape[1] <= 13056
    n = 0
    for t in range(lengths.shape[0]):
        syms = np.nonzero(lengths[t])[0]
        ln = np.append(lengths[t, syms], esc_len[t]).astype(np.int64)
        cw = np.append(codes[t, syms], esc_codes[t]).astype(np.int64)
        want = np.append(syms << 6, 0x20) | ln
        peek = (cw << (32 - ln)) | ((1 << (32 - ln)) - 1)
        e1 = lut["l1"][t, peek >> (32 - hw.K1)].astype(np.int64)
        b2 = lut["l1b"][t, e1 & 0x7F].astype(np.int64)
        tail = ((peek << hw.K1) & 0xFFFFFFFF) >> (32 - (b2 & 15))
        e2 = lut["l2"][t, np.minimum((b2 >> 4) + tail,
                                     lut["l2"].shape[1] - 1)]
        got = np.where(e1 >= 2 ** 31, e2, e1)
        np.testing.assert_array_equal(got, want, err_msg=f"table {t}")
        n += len(ln)
    assert n > 1000


@pytest.mark.parametrize("stream,mutate", [
    ("default", _clean), ("high_rate", _clean), ("default", _flipped),
    ("high_rate", _flipped), ("default", _zero_and_short),
    ("default", _bad_table_id)],
    ids=["clean", "high_rate", "flipped", "high_rate_flipped",
         "zero_and_short", "bad_table_id"])
def test_parse_matches_xla_walk(streams, stream, mutate):
    """parse_rows (plain tensor walk) and parse_rows_walk (the kernel
    route; on the CPU the kernel's plain version) equal pactpu's
    parse_rows_fn bit for bit."""
    cfg, payload = _rows(streams[stream])
    words, nbits = mutate(*hd.frame_rows(payload))
    ref = jhd.parse_rows_fn(cfg, True)(words, nbits, jhd.build_lut())
    tcfg = TorchConfig()
    got = hw.parse_rows_walk(tcfg, words, nbits, None, "cpu")
    assert got is not None
    _assert_equal(got, ref)
    if mutate is not _clean:
        assert bool(got["bad"].any())
    lay = layout_tensors(tcfg.band_layout, "cpu")
    _assert_equal(hd.parse_rows(
        tcfg, torch.from_numpy(words.view(np.int32)),
        torch.from_numpy(nbits), hw.device_walk_lut(None, "cpu"), lay), ref)


def test_parse_matches_pallas_walk(streams):
    """One case against pactpu's Pallas walk kernel in interpret mode.  The
    rows of a real stream are parsed under a 64-line layout, which keeps
    the interpreted kernel small: the first band decodes real codes, the
    rest is structured garbage, and one row is bit-flipped."""
    bands = (4, 4, 8, 16, 32)
    _, payload = _rows(streams["high_rate"])
    words, nbits = _flipped(*hd.frame_rows(payload))
    cfg = CodecConfig(band_line_counts=bands)
    ref = jhw.parse_rows_pallas(cfg, words, nbits, interpret=True)
    got = hw.parse_rows_walk(TorchConfig(band_line_counts=bands), words,
                             nbits, None, "cpu")
    _assert_equal(got, ref)
    _assert_equal(got, jhd.parse_rows_fn(cfg, True)(words, nbits,
                                                    jhd.build_lut()))


@pytest.mark.parametrize("case", ["wide_rows", "five_size_bits"])
def test_wide_rows_and_five_size_bits(streams, case):
    """Rows of 1,024 words and n_mant_size_bits = 5 (bit allocations up to
    32) are within the walk's contract: parse_rows_walk and parse_rows
    equal pactpu's XLA walk.  Under the 5-bit reading the default stream's
    rows are garbage with allocations past 16 bits, which holds the 64-bit
    arithmetic to the reference's int32 wrap-around."""
    _, payload = _rows(streams["default"])
    words, nbits = hd.frame_rows(payload)
    kw = {}
    if case == "wide_rows":
        words = np.pad(words, ((0, 0), (0, 1024 - words.shape[1])))
    else:
        kw = dict(n_mant_size_bits=5)
    cfg, tcfg = CodecConfig(**kw), TorchConfig(**kw)
    ref = jhd.parse_rows_fn(cfg, True)(words, nbits, jhd.build_lut())
    _assert_equal(hw.parse_rows_walk(tcfg, words, nbits, None, "cpu"), ref)
    got = hd.parse_rows(tcfg, torch.from_numpy(words.view(np.int32)),
                        torch.from_numpy(nbits),
                        hw.device_walk_lut(None, "cpu"),
                        layout_tensors(tcfg.band_layout, "cpu"))
    _assert_equal(got, ref)
    if case == "five_size_bits":
        assert int(got["ba"].max()) > 16


def test_walk_wrapper_refuses_fields_its_records_cannot_hold():
    words = torch.zeros((2, 32), dtype=torch.int32)
    lut = hw.device_walk_lut(None, "cpu")
    n_lines = TorchConfig().band_layout.n_lines
    for bits in ((4, 6, 4), (9, 4, 4), (4, 4, 17)):
        with pytest.raises(ValueError):
            K.huffman_walk(words, lut, n_lines, *bits)
        with pytest.raises(ValueError):
            K.huffman_walk_plain(words, lut, n_lines, *bits)


def test_unfit_tables_have_no_walk_lut(streams):
    lengths = np.zeros((1, 64), np.int32)
    lengths[0, 1] = 32                           # a 32-bit code
    codes = np.zeros((1, 64), np.int32)
    tables = (lengths, codes, np.asarray([7], np.int32),
              np.asarray([3], np.int32))
    assert hw.build_walk_lut(tables) is None
    assert hw.device_walk_lut(tables, "cpu") is None
    _, payload = _rows(streams["default"])
    words, nbits = hd.frame_rows(payload)
    assert hw.parse_rows_walk(TorchConfig(), words, nbits, tables,
                              "cpu") is None


def test_engine_device_route_with_five_size_bits(monkeypatch):
    """A stream with 5 mantissa-size bits on the device-parse route: the
    route is decided before staging (no None reaches the staging code, as
    it does in pactpu), every chunk goes through the kernel's wrapper (on
    the CPU its plain version) and the PCM equals the host route's."""
    cfg = TorchConfig(n_mant_size_bits=5)
    pcm = _tone_pcm(n=3 * 1024 + 100, seed=21)
    stream = Engine(device="cpu", cfg=cfg, chunk_blocks=16).encode(pcm)
    calls = []
    real = K.huffman_walk
    monkeypatch.setattr(
        K, "huffman_walk",
        lambda *a, **k: calls.append("wrapper") or real(*a, **k))
    _, dev_pcm = Engine(device="cpu", chunk_blocks=16,
                        decode_parse="device").decode(stream)
    assert calls == ["wrapper"]
    _, host_pcm = Engine(device="cpu", chunk_blocks=16,
                         decode_parse="host").decode(stream)
    np.testing.assert_array_equal(dev_pcm, host_pcm)
