"""The port's CUDA kernels on the card, at edge shapes the main path does
not produce (ragged rows and tiles, tiny and empty inputs), each against
its plain PyTorch version on the same tensors.  These tests need a CUDA
device and skip without one; the card's machine runs them with

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

(--noconftest: the repository's conftest imports JAX, which that machine
does not have).  Nothing here imports JAX or pactpu."""

import numpy as np
import pytest
import torch

import chip_smoke
from pactpu_torch.ops import huffman_walk as hw
from pactpu_torch.ops import kernels as K
from pactpu_torch.ops.huffman import load_tables
from pactpu_torch.utils.config import CodecConfig

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _i32(rng, shape, lo=-2 ** 31, hi=2 ** 31):
    return torch.from_numpy(rng.integers(lo, hi, shape, dtype=np.int64)
                            .astype(np.int32))


@pytest.mark.parametrize("rows,n_words,n_lines", [(1, 1, 32), (7, 3, 100),
                                                  (33, 20, 256)])
def test_extract_codes_edges(cuda, rows, n_words, n_lines):
    """Widths 0..32, offsets past the last word (they read zero)."""
    rng = np.random.default_rng(rows)
    words = _i32(rng, (rows, n_words)).to(cuda)
    off = _i32(rng, (rows, n_lines), 0, 32 * n_words + 40).to(cuda)
    width = _i32(rng, (rows, n_lines), 0, 33).to(cuda)
    out = K.extract_codes(words, off, width)
    torch.cuda.synchronize()
    assert torch.equal(out, K.extract_codes_plain(words, off, width))


@pytest.mark.parametrize("rows,n_bands,max_mant", [
    (1, 25, 16), (13, 7, 4), (515, 32, 16), (6, 1, 16), (130, 25, 1),
    (9, 32, 1)])
def test_water_fill_edges(cuda, rows, n_bands, max_mant):
    """Rows that do not fill the last block's warps, one band, narrow and
    full-warp band counts, caps of 1, 4 and 16 bits, zero and huge
    budgets, ties."""
    rng = np.random.default_rng(n_bands)
    smr = torch.from_numpy(rng.uniform(-30, 70, (rows, n_bands))
                           .astype(np.float32))
    smr[::5] = 10.0
    lrms = torch.from_numpy(rng.random((rows, n_bands)) < 0.5)
    n_lines = torch.from_numpy(rng.integers(0, 60, n_bands).astype(np.int32))
    total = torch.from_numpy(rng.integers(0, 5000, rows).astype(np.int32))
    total[::3] = 0
    total[1::7] = 10 ** 7
    args = [a.to(cuda) for a in (total,)] + [max_mant] + [
        a.to(cuda) for a in (n_lines, smr, lrms)]
    bits, left = K.water_fill(*args)
    pbits, pleft = K.water_fill_plain(*args)
    torch.cuda.synchronize()
    assert torch.equal(bits, pbits) and torch.equal(left, pleft)


@pytest.mark.parametrize("name", chip_smoke.K2_EDGES)
def test_water_fill_cases(cuda, name):
    """The named edge inputs of chip_smoke.k2_edge, bit for bit: -0.0
    beside +0.0 (they tie, the first band wins), ties, 1 and 32 bands, zero
    budgets, every band at the cap, a one-bit cap, NaN SMRs, SMRs at and
    below the dead bands' key."""
    args = [torch.from_numpy(a).to(cuda) if isinstance(a, np.ndarray) else a
            for a in chip_smoke.k2_edge(name)]
    bits, left = K.water_fill(*args)
    pbits, pleft = K.water_fill_plain(*args)
    torch.cuda.synchronize()
    assert torch.equal(bits, pbits) and torch.equal(left, pleft)
    if name == "to-the-cap":
        assert bool((bits == 16).all())
    if name == "zero-budget":                 # only zero-line bands are free
        assert not bits[:, args[2] > 0].any()
    if name == "max-mant-1":
        assert not bits.any()                 # a lone bit is refunded


@pytest.mark.parametrize("rows,items,n_words", [(1, 5, 1), (3, 255, 968),
                                                (9, 1300, 37)])
def test_pack_words_edges(cuda, rows, items, n_words):
    rng = np.random.default_rng(items)
    p0, p1 = _i32(rng, (rows, items)), _i32(rng, (rows, items))
    w0 = _i32(rng, (rows, items), -3, n_words + 3)
    p0, p1, w0 = p0.to(cuda), p1.to(cuda), w0.to(cuda)
    out = K.pack_words(p0, p1, w0, n_words)
    torch.cuda.synchronize()
    assert torch.equal(out, K.pack_words_plain(p0, p1, w0, n_words))


@pytest.mark.parametrize("rows,k,l", [(1, 128, 300), (17, 100, 1024),
                                      (2, 4096, 1024), (3, 37, 1100),
                                      (4, 1, 31), (2, 1000, 2049)])
def test_spread_up_edges(cuda, rows, k, l):
    """Line counts that are no multiple of a warp's 32-line span or of the
    1,024-line tile (one, two and three passes), masker counts that are no
    power of two, one masker, 4,096 maskers (64 KB of shared memory);
    rtol 1e-5 (the sum's order and a fused multiply-add only)."""
    rng = np.random.default_rng(k)
    zvec = torch.from_numpy(np.sort(rng.uniform(0, 25, l)).astype(np.float32))
    bark = torch.from_numpy(np.sort(rng.uniform(0, 25, k)).astype(np.float32))
    mspl = torch.from_numpy(rng.uniform(-30, 100, (rows, k))
                            .astype(np.float32))
    ip = torch.from_numpy(np.where(rng.random((rows, k)) < 0.2,
                                   rng.random((rows, k)), 0.0)
                          .astype(np.float32))
    args = [a.to(cuda) for a in (ip, mspl, bark, zvec)]
    out = K.spread_maskers_up(*args)
    plain = K.spread_maskers_up_plain(*args)
    torch.cuda.synchronize()
    assert (plain > 0).any()
    torch.testing.assert_close(out, plain, rtol=1e-5, atol=0)


@pytest.mark.parametrize("name", chip_smoke.K4_EDGES)
def test_spread_up_cases(cuda, name):
    """The named edge inputs of chip_smoke.k4_edge: a row with no peak
    sums to zero, rows where every bin is a peak (the compacted list is
    the whole row, at 4,096 too), ragged shapes, one masker at the lowest
    bark (its far lines are denormal or zero, as in the plain version) and
    at the highest (no line is above it)."""
    ip, mspl, bark, zvec = (torch.from_numpy(a).to(cuda)
                            for a in chip_smoke.k4_edge(name))
    out = K.spread_maskers_up(ip, mspl, bark, zvec)
    plain = K.spread_maskers_up_plain(ip, mspl, bark, zvec)
    torch.cuda.synchronize()
    torch.testing.assert_close(out, plain, rtol=1e-5, atol=0)
    if name == "no-peak":
        assert not out[1].any() and bool((out[0] > 0).any())
    if name == "highest-bark":
        assert not out.any()
    if name == "lowest-bark":
        assert bool((out > 0).any())
    if name in ("all-peaks", "k4096"):
        assert bool((ip[0] != 0).all())


def _walk_both(cuda, words: np.ndarray, n_mant_size_bits: int = 4):
    cfg = CodecConfig()
    args = (torch.from_numpy(words.view(np.int32)).to(cuda),
            hw.device_walk_lut(None, cuda), cfg.band_layout.n_lines,
            cfg.n_scale_bits, n_mant_size_bits, cfg.n_table_id_bits)
    rec = K.huffman_walk(*args)
    torch.cuda.synchronize()
    plain = K.huffman_walk_plain(*args)
    for name, a, b in zip(("code", "basf", "soff", "misc"), rec, plain):
        assert torch.equal(a, b), name
    return rec


@pytest.mark.parametrize("rows,n_words,size_bits", [
    (1, 32, 4), (33, 32, 4), (70, 512, 4), (70, 1024, 4), (33, 32, 5),
    (70, 1024, 5)])
def test_huffman_walk_garbage_rows(cuda, rows, n_words, size_bits):
    """Random words: every table id, dead codes, cursors that run far past
    a 32-word row (words there read as zero), a last block of threads that
    is not full; rows of 1,024 words; 5 mantissa-size bits (allocations up
    to 32 bits, raw escape mantissas that fill an int32)."""
    rng = np.random.default_rng(rows)
    words = rng.integers(0, 2 ** 32, (rows, n_words), dtype=np.uint64).astype(
        np.uint32)
    rec = _walk_both(cuda, words, size_bits)
    if size_bits == 5:
        assert int((rec[1] & 0xFF).max()) == 31           # ba = 32 occurs
    if n_words == 32 and rows > 1:
        assert int(rec[3][:, 4].max()) > 32 * n_words     # ran past the row


def test_huffman_walk_all_escape_rows(cuda):
    """Rows whose every transmitted line is an escape code followed by a
    raw mantissa, one row per table: 16-bit mantissas in band 0 and 2-bit
    mantissas after."""
    cfg = CodecConfig()
    n_lines = cfg.band_layout.n_lines
    _, _, esc_len, esc_code = load_tables()
    rng = np.random.default_rng(5)
    words = np.zeros((len(esc_len), 512), np.uint32)
    want = []
    for t in range(len(esc_len)):
        bits, vals = [], []

        def put(v, n):
            bits.extend((int(v) >> (n - 1 - i)) & 1 for i in range(n))

        put(3, 4)
        put(t + 1, 4)
        for b, nl in enumerate(n_lines):
            ba = 16 if b == 0 else 2 if b < 14 else 0
            put(ba - 1 if ba else 0, 4)
            put(5, 4)
            if ba:
                put(0, nl)                               # sign bits
                for _ in range(nl):
                    v = int(rng.integers(0, 1 << ba))
                    put(esc_code[t], int(esc_len[t]))
                    put(v, ba)
                    vals.append(v)
        assert len(bits) <= 32 * 512
        bits += [0] * (-len(bits) % 32)
        packed = np.packbits(np.asarray(bits, np.uint8)).view(">u4")
        words[t, :packed.shape[0]] = packed
        want.append(vals)
    rec = _walk_both(cuda, words)
    code = rec[0].cpu().numpy()
    for t, vals in enumerate(want):
        np.testing.assert_array_equal(code[t, :len(vals)], vals)
        assert not code[t, len(vals):].any()
    assert not rec[3][:, 2].any()                        # no row is bad


def test_huffman_walk_32_bit_escapes(cuda):
    """n_mant_size_bits = 5 on well-formed rows: band 0 allocates 32 bits
    and every line is an escape code followed by a raw 32-bit mantissa, so
    one step advances up to 63 bits and the decoded value wraps in int32
    as the plain version's does."""
    cfg = CodecConfig()
    n_lines = cfg.band_layout.n_lines
    _, _, esc_len, esc_code = load_tables()
    rng = np.random.default_rng(6)
    words = np.zeros((len(esc_len), 64), np.uint32)
    want = []
    for t in range(len(esc_len)):
        bits = []

        def put(v, n):
            bits.extend((int(v) >> (n - 1 - i)) & 1 for i in range(n))

        put(3, 4)
        put(t + 1, 4)
        vals = [int(v) for v in rng.integers(0, 1 << 32, n_lines[0])]
        vals[0] = 0xFFFFFFFF
        for b, nl in enumerate(n_lines):
            put(31 if b == 0 else 0, 5)
            put(5, 4)
            if b == 0:
                put(0, nl)                               # sign bits
                for v in vals:
                    put(esc_code[t], int(esc_len[t]))
                    put(v, 32)
        assert len(bits) <= 32 * words.shape[1]
        bits += [0] * (-len(bits) % 32)
        packed = np.packbits(np.asarray(bits, np.uint8)).view(">u4")
        words[t, :packed.shape[0]] = packed
        want.append(np.asarray(vals, np.uint32).view(np.int32))
    rec = _walk_both(cuda, words, 5)
    code = rec[0].cpu().numpy()
    for t, vals in enumerate(want):
        np.testing.assert_array_equal(code[t, :len(vals)], vals)
        assert not code[t, len(vals):].any()
    assert not rec[3][:, 2].any()                        # no row is bad


def test_huffman_walk_refuses_six_size_bits(cuda):
    words = torch.zeros((2, 32), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):
        K.huffman_walk(words, hw.device_walk_lut(None, cuda),
                       CodecConfig().band_layout.n_lines, 4, 6, 4)


@pytest.mark.parametrize("rows,k,l", [(3, 1, 1024), (17, 513, 1024),
                                      (5, 100, 300)])
def test_spread_maskers_edges(cuda, rows, k, l):
    """One slot, the aidan path's 513 slots, a ragged last line tile; a
    row with every slot invalid sums to zero; rtol 1e-5 (the terms are
    equal, the order of the slot sum is not)."""
    rng = np.random.default_rng(k)
    zvec = torch.from_numpy(np.sort(rng.uniform(0, 25, l)).astype(np.float32))
    mspl = rng.uniform(-30, 100, (rows, k)).astype(np.float32)
    lev = (0.37 * np.maximum(mspl - 40, 0)).astype(np.float32)
    bark = rng.uniform(0, 25, (rows, k)).astype(np.float32)
    valid = (rng.random((rows, k)) < 0.5).astype(np.float32)
    valid[0] = 0
    valid[-1] = 1
    drop = rng.choice([0.0, 15.0], rows).astype(np.float32)
    args = [torch.from_numpy(a).to(cuda)
            for a in (mspl, lev, bark, valid, drop)] + [zvec.to(cuda)]
    out = K.spread_maskers(*args)
    plain = K.spread_maskers_plain(*args)
    torch.cuda.synchronize()
    assert not out[0].any() and bool((out[-1] > 0).any())
    torch.testing.assert_close(out, plain, rtol=1e-5, atol=0)


def test_empty_and_mixed_devices(cuda):
    """Empty inputs launch nothing; tensors on two devices are refused."""
    K.reset_launches()
    e = torch.zeros((0, 8), dtype=torch.int32, device=cuda)
    assert K.extract_codes(e, e, e).shape == (0, 8)
    assert K.LAUNCHES["extract_codes"] == 0
    a = torch.zeros((2, 8), dtype=torch.int32)
    with pytest.raises(ValueError):
        K.extract_codes(a.to(cuda), a, a)
