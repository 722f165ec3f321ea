"""The port's CUDA kernels on the card, at edge shapes the main path does
not produce (ragged rows and tiles, tiny and empty inputs), each against
its plain PyTorch version on the same tensors.  These tests need a CUDA
device and skip without one; the card's machine runs them with

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

(--noconftest: the repository's conftest imports JAX, which that machine
does not have).  Nothing here imports JAX or pactpu."""

import time

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


@pytest.mark.parametrize("name", chip_smoke.K1_EDGES)
def test_extract_codes_cases(cuda, name):
    """K1's named edge inputs (chip_smoke.k1_edge): every path of the
    kernel (rows staged in shared memory or read from device memory,
    16-byte or scalar field loads, many rows a block)."""
    words, off, width = (torch.from_numpy(a.view(np.int32)).to(cuda)
                         for a in chip_smoke.k1_edge(name))
    out = K.extract_codes(words, off, width)
    torch.cuda.synchronize()
    assert torch.equal(out, K.extract_codes_plain(words, off, width))


def test_extract_codes_misaligned_rows(cuda):
    """Fields, widths and output that are no 16-byte aligned views, and a
    words tensor whose rows start off a 16-byte boundary."""
    rng = np.random.default_rng(7)
    base = _i32(rng, (9, 101)).to(cuda)
    words = base[:, 1:].contiguous()[1:]              # 8 x 100
    off = _i32(rng, (8 * 513 + 1,), 0, 3300).to(cuda)[1:].view(8, 513)
    width = _i32(rng, (8 * 513 + 1,), 0, 33).to(cuda)[1:].view(8, 513)
    out = K.extract_codes(words, off, width)
    torch.cuda.synchronize()
    assert torch.equal(out, K.extract_codes_plain(words, off, width))


MODES = {name: (fields, fmt) for name, fields, fmt in chip_smoke.MODES}


@pytest.mark.parametrize("mode", list(MODES))
def test_modes_match_the_cpu(cuda, mode):
    """Each codec mode on the card against the port on the CPU: the card
    decodes the CPU's stream within 1 LSB of the CPU's decode by both
    parse routes, and its own stream of the same 1 s input is within
    0.1 dB SNR and 1% size of the CPU's."""
    from pactpu_torch import Engine
    fields, fmt = MODES[mode]
    cfg = CodecConfig(**fields)
    pcm = np.ascontiguousarray(chip_smoke.synth(1.0, 9)[:, :cfg.n_channels])
    cpu = Engine(device="cpu", cfg=cfg, fmt=fmt)
    stream = cpu.encode(pcm)
    _, gold = cpu.decode(stream)
    for route in ("host", "device"):
        _, out = Engine(device=cuda, cfg=cfg, fmt=fmt,
                        decode_parse=route).decode(stream)
        assert int(np.abs(out.astype(np.int32) - gold).max()) <= 1
    card = Engine(device=cuda, cfg=cfg, fmt=fmt)
    mine = card.encode(pcm)
    _, out = card.decode(mine)
    snr = [chip_smoke.snr_db(pcm, x) for x in (out, gold)]
    assert abs(snr[0] - snr[1]) <= 0.1
    assert abs(len(mine) - len(stream)) <= 0.01 * len(stream)


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


def _layout():
    cfg = CodecConfig()
    return (cfg.band_layout.n_lines, cfg.n_scale_bits, cfg.n_mant_size_bits,
            cfg.n_table_id_bits)


def _pack_both(fields, n_words):
    from pactpu_torch.ops import bitpack
    lay = _layout()
    got = bitpack.pack_payload_bits(*fields, *lay, n_words)
    torch.cuda.synchronize()
    return got, bitpack.pack_payload_bits_plain(*fields, *lay, n_words)


@pytest.mark.parametrize("n_words", chip_smoke.K3_WORDS)
@pytest.mark.parametrize("name", chip_smoke.K3_EDGES)
def test_pack_payload_edges(cuda, name, n_words):
    """K3's payload pack on chip_smoke.k3_edge's rows: every band off,
    every line at 29 bits, values past their widths, rows past 256
    words."""
    fields = chip_smoke.k3_tensors(
        torch, chip_smoke.k3_edge(name, _layout()[0]), cuda)
    got, want = _pack_both(fields, n_words)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.parametrize("n_words", chip_smoke.K3_WORDS)
@pytest.mark.parametrize("rows,wide", [(1, False), (7, True), (1024, False),
                                       (1031, True)])
def test_pack_payload_random(cuda, rows, wide, n_words):
    """Seeded fields as the final pass gives them, and (wide) every field
    over all 32 bits with lens 0-29."""
    rng = np.random.default_rng(rows + n_words)
    f = chip_smoke.k3_fields(rng, rows, _layout()[0])
    if wide:
        f = {k: _i32(rng, v.shape).numpy() for k, v in f.items()}
        f["lens"] = rng.integers(0, 30, f["lens"].shape).astype(np.int32)
    got, want = _pack_both(chip_smoke.k3_tensors(torch, f, cuda), n_words)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


# band layouts past the default's: 150 bands of 7 lines (1,050 lines, no
# multiple of 4: scalar staging; 1,652 items: 16 a thread), 32 bands of 64
# (2,048 lines: quads past the first two a thread, signs beyond the bit
# words; 2,210 items: 32 a thread), three bands of 48 lines
PACK_LAYOUTS = {"150-bands": (7,) * 150, "2048-lines": (64,) * 32,
                "48-lines": (3, 5, 40)}


@pytest.mark.parametrize("name", list(PACK_LAYOUTS))
def test_pack_payload_layouts(cuda, name):
    """Each form of the kernel (9, 16 and 32 items a thread), staging by
    quads and by lines, rows of 0/1 signs and of wider ones."""
    from pactpu_torch.ops import bitpack
    n_lines = PACK_LAYOUTS[name]
    rng = np.random.default_rng(len(n_lines))
    f = chip_smoke.k3_fields(rng, 40, n_lines)
    f["sign"][::3] = rng.integers(-2, 5, f["sign"][::3].shape)
    fields = chip_smoke.k3_tensors(torch, f, cuda)
    got = bitpack.pack_payload_bits(*fields, n_lines, 4, 4, 4, 968)
    torch.cuda.synchronize()
    want = bitpack.pack_payload_bits_plain(*fields, n_lines, 4, 4, 4, 968)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


def test_pack_payload_unaligned(cuda):
    """Line fields that start 4 bytes past a 16-byte boundary: the kernel
    stages them line by line."""
    from pactpu_torch.ops import bitpack
    lay = _layout()
    f = chip_smoke.k3_fields(np.random.default_rng(5), 16, lay[0])
    fields = list(chip_smoke.k3_tensors(torch, f, cuda))
    for i in (4, 5, 6):
        big = torch.zeros(fields[i].numel() + 1, dtype=torch.int32,
                          device=cuda)
        big[1:] = fields[i].reshape(-1)
        fields[i] = big[1:].view(fields[i].shape)
        assert fields[i].data_ptr() % 16 == 4
    got, want = _pack_both(fields, 256)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


def test_pack_payload_once_a_finalize(cuda):
    """finalize with packing launches K3's payload pack once and the
    parts' K3 never; without packing neither."""
    from pactpu_torch.codec import engine as E
    cfg = CodecConfig()
    tables = E.device_tables(cfg, cuda)
    pcm = chip_smoke.synth(1.0, 8)
    frames = chip_smoke.chunk_frames(torch, pcm, 44, cuda)
    a = E.analyze(cfg, frames, tables)
    extra = torch.zeros(44, device=cuda)
    for pack_words, want in ((E.PACK_WORDS, 1), (0, 0)):
        K.reset_launches()
        E.finalize(cfg, a, extra, tables, pack_words=pack_words)
        torch.cuda.synchronize()
        assert K.LAUNCHES["pack_payload"] == want
        assert K.LAUNCHES["pack_words"] == 0


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
            hw.device_walk_lut(device=cuda), cfg.band_layout.n_lines,
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


def _walk_edge(cuda, name):
    """A named edge input of chip_smoke.k5_edge through the kernel and its
    plain version; the well-formed ones decode to what they were built
    from, with no row flagged."""
    edge = chip_smoke.k5_edge(name)
    rec = _walk_both(cuda, edge["words"], edge["size_bits"])
    if edge["want"] is not None:
        np.testing.assert_array_equal(rec[0].cpu().numpy(), edge["want"])
        assert not rec[3][:, 2].any()                    # no row is bad
    return rec, edge


def test_huffman_walk_all_escape_rows(cuda):
    """Rows whose every transmitted line is an escape code followed by a
    raw mantissa, one row per table: 16-bit mantissas in band 0 and 2-bit
    mantissas after (chip_smoke.k5_edge("all-escape"))."""
    rec, edge = _walk_edge(cuda, "all-escape")
    assert int(edge["want"][:, :5].max()) > 255          # 16-bit values


def test_huffman_walk_32_bit_escapes(cuda):
    """n_mant_size_bits = 5 on well-formed rows: band 0 allocates 32 bits
    and every line is an escape code followed by a raw 32-bit mantissa, so
    one step advances up to 63 bits and the decoded value wraps in int32
    as the plain version's does (chip_smoke.k5_edge("escape-32"))."""
    rec, edge = _walk_edge(cuda, "escape-32")
    assert (edge["want"][:, 0] == -1).all()              # 0xFFFFFFFF
    assert int((rec[1][:, 0] & 0xFF).max()) == 31        # ba = 32


@pytest.mark.parametrize("name", chip_smoke.K5_EDGES)
def test_huffman_walk_cases(cuda, name):
    """The named edge inputs of chip_smoke.k5_edge, bit for bit: garbage at
    4 and 5 size bits, every code an escape, 32-bit escapes, a cursor that
    jumps 163 and 304 sign bits, rows of zero words, rows that end inside a
    code, rows of 1, 1,024, 1,500 and 40,000 words (the last are read from
    global memory, not staged in shared memory)."""
    rec, edge = _walk_edge(cuda, name)
    if edge["want"] is None:
        assert bool(rec[3][:, 2].any())                  # some row is bad


def test_huffman_walk_many_tables(cuda):
    """Thirty tables (the shipped ten, three times over): their level-1
    tables no longer fit a block's shared memory, so the kernel reads them
    from global memory; random rows reach every table id."""
    cfg = CodecConfig()
    tables = tuple(np.concatenate([a] * 3) for a in load_tables())
    lut = {k: torch.from_numpy(v.view(np.int32)).to(cuda)
           for k, v in hw.build_walk_lut(tables).items()}
    assert lut["l1"].shape == (30, 2048)
    rng = np.random.default_rng(30)
    words = rng.integers(0, 2 ** 32, (40, 64), dtype=np.uint64).astype(
        np.uint32)
    args = (torch.from_numpy(words.view(np.int32)).to(cuda), lut,
            cfg.band_layout.n_lines, cfg.n_scale_bits, cfg.n_mant_size_bits,
            5)
    rec = K.huffman_walk(*args)
    torch.cuda.synchronize()
    for name, a, b in zip(("code", "basf", "soff", "misc"), rec,
                          K.huffman_walk_plain(*args)):
        assert torch.equal(a, b), name
    assert int(rec[3][:, 1].max()) > 20                  # table ids past 20


def test_huffman_walk_refuses_six_size_bits(cuda):
    words = torch.zeros((2, 32), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):
        K.huffman_walk(words, hw.device_walk_lut(device=cuda),
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


@pytest.mark.parametrize("name", chip_smoke.K6_EDGES)
def test_spread_maskers_cases(cuda, name):
    """The named edge inputs of chip_smoke.k6_edge: rows with no valid
    slot, every slot valid, one slot at either end of the bark scale,
    ascending, descending and shuffled slot order (the kernel leaves,
    reverses or sorts the list), 1, 37, 513 and 4,096 slots, 300, 1,000
    and 2,500 lines, rising upslopes, far lines below 2^-126; rtol 1e-5
    (+1e-30), as chip_smoke.py holds them."""
    args = [torch.from_numpy(a).to(cuda) for a in chip_smoke.k6_edge(name)]
    out = K.spread_maskers(*args)
    plain = K.spread_maskers_plain(*args)
    torch.cuda.synchronize()
    assert bool(((out - plain).abs()
                 <= chip_smoke.K6_RTOL * plain.abs() + 1e-30).all())
    if name == "no-valid":
        assert not out[1:3].any() and bool((out[0] > 0).all())


def test_empty_and_mixed_devices(cuda):
    """Empty inputs launch nothing; tensors on two devices are refused."""
    K.reset_launches()
    e = torch.zeros((0, 8), dtype=torch.int32, device=cuda)
    assert K.extract_codes(e, e, e).shape == (0, 8)
    assert K.LAUNCHES["extract_codes"] == 0
    a = torch.zeros((2, 8), dtype=torch.int32)
    with pytest.raises(ValueError):
        K.extract_codes(a.to(cuda), a, a)


@pytest.mark.parametrize("name", chip_smoke.K2_EDGES)
def test_water_fill_f64_cases(cuda, name):
    """K2's float64 form (precision="f64") on the named edge inputs, their
    SMRs in float64, bit for bit with the plain version in float64."""
    args = [torch.from_numpy(a).to(cuda) if isinstance(a, np.ndarray) else a
            for a in chip_smoke.k2_edge(name)]
    args[3] = args[3].double()
    bits, left = K.water_fill(*args)
    pbits, pleft = K.water_fill_plain(*args)
    torch.cuda.synchronize()
    assert torch.equal(bits, pbits) and torch.equal(left, pleft)


@pytest.mark.parametrize("n_bands", [33, 40, 64, 96, 200, 1024])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_water_fill_many_bands(cuda, n_bands, dtype):
    """Past 32 bands a lane holds several: 2 and 4 slots in registers, 7
    and 32 in the wide form, ties within a lane and across lanes,
    zero-line bands, in both types."""
    rng = np.random.default_rng(n_bands)
    rows = 37
    smr = rng.uniform(-30, 70, (rows, n_bands))
    smr[::3] = np.round(smr[::3] / 10) * 10                  # many ties
    smr[1::3, 32:] = smr[1::3, :n_bands - 32]
    lrms = rng.random((rows, n_bands)) < 0.5
    n_lines = rng.integers(0, 12, n_bands).astype(np.int32)
    total = rng.integers(0, 4000, rows).astype(np.int32)
    total[::5] = 10 ** 6
    args = [torch.from_numpy(total).to(cuda), 16,
            torch.from_numpy(n_lines).to(cuda),
            torch.from_numpy(smr).to(dtype).to(cuda),
            torch.from_numpy(lrms).to(cuda)]
    bits, left = K.water_fill(*args)
    pbits, pleft = K.water_fill_plain(*args)
    torch.cuda.synchronize()
    assert torch.equal(bits, pbits) and torch.equal(left, pleft)


@pytest.mark.parametrize("name", chip_smoke.K4_EDGES)
def test_spread_up_f64_cases(cuda, name):
    """K4's float64 form on the named edge inputs in float64, within
    chip_smoke.K4_F64_RTOL of the plain version in float64."""
    args = [torch.from_numpy(a).to(cuda).double()
            for a in chip_smoke.k4_edge(name)]
    out = K.spread_maskers_up(*args)
    plain = K.spread_maskers_up_plain(*args)
    torch.cuda.synchronize()
    assert out.dtype == torch.float64
    assert bool(((out - plain).abs()
                 <= chip_smoke.K4_F64_RTOL * plain.abs()).all())


def test_huffman_walk_96_bands(cuda):
    """K5 past the 64 bands it once took by value: random rows and a real
    stream's rows under the 96-band layout chip_smoke.WIDE_BANDS."""
    from pactpu_torch import Engine
    from pactpu_torch.codec.header import read_header
    from pactpu_torch.ops import huffman_decode as hd
    cfg = CodecConfig(band_line_counts=chip_smoke.WIDE_BANDS)
    stream = Engine(device=cuda, cfg=cfg).encode(chip_smoke.synth(0.5, 96))
    rows, _ = hd.frame_rows(stream[read_header(stream)[2]:])
    rng = np.random.default_rng(96)
    garbage = rng.integers(0, 2 ** 32, (40, 64), dtype=np.uint64).astype(
        np.uint32)
    for words in (rows, garbage):
        args = (torch.from_numpy(words.view(np.int32)).to(cuda),
                hw.device_walk_lut(device=cuda), cfg.band_layout.n_lines,
                cfg.n_scale_bits, cfg.n_mant_size_bits, cfg.n_table_id_bits)
        rec = K.huffman_walk(*args)
        torch.cuda.synchronize()
        for name, a, b in zip(("code", "basf", "soff", "misc"), rec,
                              K.huffman_walk_plain(*args)):
            assert torch.equal(a, b), name
    assert not rec[3][:, 2].all() and rows.shape[0] > 0


@pytest.mark.parametrize("precision", ["f32", "f64"])
@pytest.mark.parametrize("layout", ["stereo", "mono", "40-bands", "96-bands",
                                    "200-bands"])
def test_exact_scan(cuda, precision, layout):
    """K7 against its plain version on a 48-block chunk: all blocks from a
    zero carry, then 30 real blocks (the rest padding) from the first
    call's carry; extras and carry bit-equal.  96 bands take the register
    form of three slots a lane, 200 bands the wide form."""
    from pactpu_torch.codec import engine as E
    cfg = {"stereo": CodecConfig(), "mono": CodecConfig(n_channels=1),
           "40-bands": CodecConfig(band_line_counts=chip_smoke.BANDS_40),
           "96-bands": CodecConfig(band_line_counts=chip_smoke.WIDE_BANDS),
           "200-bands": CodecConfig(band_line_counts=(5,) * 176 + (6,) * 24)
           }[layout]
    tables = E.device_tables(cfg, cuda, precision)
    pcm = chip_smoke.synth(48 * 1024 / chip_smoke.FS, 7)
    args = chip_smoke.k7_args(torch, cfg, tables, pcm, 48)
    K.reset_launches()
    ex, carry = K.exact_scan(*args)
    assert K.LAUNCHES["exact_scan"] == 1
    pex, pcarry = K.exact_scan_plain(*args)
    assert torch.equal(ex, pex) and torch.equal(carry, pcarry)
    assert int(carry[0]) != 0
    tail = (*args[:3], 30, carry, *args[5:])
    got, want = K.exact_scan(*tail), K.exact_scan_plain(*tail)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert not got[0][30:].any()


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("name", chip_smoke.K8_EDGES)
def test_closed_form_cases(cuda, name, dtype):
    """K8 on the named edge inputs of chip_smoke.k8_edge, in both types,
    bit-equal with its plain version."""
    budget, smr, n_lines, max_mant = chip_smoke.k8_edge(name)
    args = (torch.from_numpy(budget).to(cuda),
            torch.from_numpy(smr).to(cuda, dtype),
            torch.from_numpy(n_lines).to(cuda), max_mant)
    K.reset_launches()
    out = K.closed_form(*args)
    torch.cuda.synchronize()
    assert K.LAUNCHES["closed_form"] == 1
    assert torch.equal(out, K.closed_form_plain(*args))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("name", chip_smoke.K8_NONFINITE)
def test_closed_form_nonfinite(cuda, name, dtype):
    """K8 on chip_smoke.k8_nonfinite's NaN and infinite SMRs, in both
    types, bit-equal with its plain version (the NaN-lowest key, a live
    +inf band tied with a retired one)."""
    budget, smr, n_lines, max_mant = chip_smoke.k8_nonfinite(name)
    args = (torch.from_numpy(budget).to(cuda),
            torch.from_numpy(smr).to(cuda, dtype),
            torch.from_numpy(n_lines).to(cuda), max_mant)
    out = K.closed_form(*args)
    torch.cuda.synchronize()
    assert torch.equal(out, K.closed_form_plain(*args))


@pytest.mark.parametrize("n_bands", [1, 33, 96, 200, 203, 1024])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_closed_form_many_bands(cuda, n_bands, dtype):
    """K8 at one band, two and three slots a lane, and the wide form (203
    bands: with a tail past the whole octets), on ragged row counts, with
    budgets from below zero to past the cap."""
    rng = np.random.default_rng(n_bands)
    rows = 37
    n_lines = rng.integers(0, 30, n_bands).astype(np.int32)
    lines = max(1, int(n_lines.sum()))
    args = (torch.from_numpy(rng.integers(-lines, 17 * lines, rows)
                             .astype(np.int32)).to(cuda),
            torch.from_numpy(rng.uniform(-30, 90, (rows, n_bands)))
            .to(cuda, dtype),
            torch.from_numpy(n_lines).to(cuda), 16)
    out = K.closed_form(*args)
    torch.cuda.synchronize()
    assert torch.equal(out, K.closed_form_plain(*args))


@pytest.mark.parametrize("name", chip_smoke.K9_EDGES)
def test_grant_fill_cases(cuda, name):
    """K9 on the named edge inputs of chip_smoke.k9_edge (NaN and infinite
    levels, a walk that stops on a band it cannot grant, zero-line bands)
    bit-equal with its plain version."""
    from pactpu_torch.ops import bitalloc
    total, level, n_lines, max_mant, cap = chip_smoke.k9_edge(name)
    args = (torch.from_numpy(total).to(cuda), torch.from_numpy(level).to(cuda),
            torch.from_numpy(n_lines).to(cuda), max_mant,
            bitalloc._legacy_iter_bound(cap, n_lines, n_lines.shape[0]))
    K.reset_launches()
    out = K.grant_fill(*args)
    torch.cuda.synchronize()
    assert K.LAUNCHES["grant_fill"] == 1
    assert torch.equal(out, K.grant_fill_plain(*args))


@pytest.mark.parametrize("n_bands", [25, 40, 96])
def test_grant_fill_jump_rows(cuda, n_bands):
    """K9 on rows its jump takes (finite levels, ties on a 6 dB grid,
    budgets from zero past every line's cap, zero-line bands), bit-equal
    with the plain version's steps; the plain mirror of the kernel's walk
    jumps on them."""
    from pactpu_torch.ops import bitalloc
    rng = np.random.default_rng(n_bands)
    rows = 64
    n_lines = rng.integers(1, 60, n_bands).astype(np.int32)
    n_lines[[2, n_bands - 1]] = 0
    lines = int(n_lines.sum())
    level = rng.uniform(-20.0, 100.0, (rows, n_bands)).astype(np.float32)
    level[::3] = np.round(level[::3] / 6.0) * 6.0
    total = rng.integers(0, 17 * lines, rows).astype(np.int32)
    total[:3] = (0, 16 * lines, lines)
    args = (torch.from_numpy(total).to(cuda),
            torch.from_numpy(level).to(cuda),
            torch.from_numpy(n_lines).to(cuda), 16,
            bitalloc._legacy_iter_bound(4 * int(total.max()), n_lines,
                                        n_bands))
    out = K.grant_fill(*args)
    torch.cuda.synchronize()
    assert torch.equal(out, K.grant_fill_plain(*args))
    stats = {}
    K.grant_fill_jump_plain(*args, stats=stats)
    assert stats["jumped"] > stats["steps"]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("name", chip_smoke.K8_NONFINITE)
def test_closed_form_nonfinite(cuda, name, dtype):
    """K8 on chip_smoke.k8_nonfinite's NaN and infinite SMRs, in both
    types, bit-equal with its plain version (the NaN-lowest key, a live
    +inf band tied with a retired one)."""
    budget, smr, n_lines, max_mant = chip_smoke.k8_nonfinite(name)
    args = (torch.from_numpy(budget).to(cuda),
            torch.from_numpy(smr).to(cuda, dtype),
            torch.from_numpy(n_lines).to(cuda), max_mant)
    out = K.closed_form(*args)
    torch.cuda.synchronize()
    assert torch.equal(out, K.closed_form_plain(*args))


@pytest.mark.parametrize("n_bands", [1, 33, 96, 200, 203, 1024])
def test_grant_fill_many_bands(cuda, n_bands):
    """K9 at one band, two and three slots a lane and the wide form, and
    with a step cap that stops every row early."""
    rng = np.random.default_rng(n_bands)
    rows = 37
    n_lines = rng.integers(0, 30, n_bands).astype(np.int32)
    lines = max(1, int(n_lines.sum()))
    base = (torch.from_numpy(rng.integers(-5, 17 * lines, rows)
                             .astype(np.int32)).to(cuda),
            torch.from_numpy(rng.uniform(-30, 90, (rows, n_bands))
                             .astype(np.float32)).to(cuda),
            torch.from_numpy(n_lines).to(cuda), 16)
    for steps in (40 * lines, 7):
        out = K.grant_fill(*base, steps)
        torch.cuda.synchronize()
        assert torch.equal(out, K.grant_fill_plain(*base, steps))


@pytest.mark.parametrize("name", chip_smoke.K6_EDGES)
def test_spread_maskers_f64_cases(cuda, name):
    """K6's float64 form on the named edge inputs of chip_smoke.k6_edge,
    within chip_smoke.K6_F64_RTOL of its plain version."""
    args = [torch.from_numpy(a).to(cuda).double()
            for a in chip_smoke.k6_edge(name)]
    out = K.spread_maskers(*args)
    plain = K.spread_maskers_plain(*args)
    torch.cuda.synchronize()
    assert out.dtype == torch.float64
    assert bool(((out - plain).abs()
                 <= chip_smoke.K6_F64_RTOL * plain.abs() + 1e-300).all())


@pytest.mark.parametrize("precision", ["f32", "f64"])
@pytest.mark.parametrize("alloc", ["closed_form", "uniform", "const_snr",
                                   "const_mnr"])
def test_allocators_match_the_cpu(cuda, alloc, precision):
    """Each allocator on the rows of one analysis (made on the CPU): the
    card's allocation (K8, K9 or the prefix compare) equals the CPU's; and
    an engine with it on the card decodes the CPU engine's stream within
    1 LSB by both routes, its own stream within 0.1 dB and 1%, launching
    its allocator's kernel."""
    from pactpu_torch import Engine
    from pactpu_torch.codec import engine as E
    from pactpu_torch.ops import bitalloc
    cfg = CodecConfig(alloc_mode=alloc)
    pcm = chip_smoke.synth(48 * 1024 / chip_smoke.FS, 5)
    tables = E.device_tables(cfg, "cpu", precision)
    a = E.analyze(cfg, chip_smoke.chunk_frames(torch, pcm, 48, "cpu"),
                  tables)
    pk = E.psycho.band_max(torch.abs(a["mixed"]), tables["lay"], fill=0.0)
    level = {"const_snr": E.psycho.spl(4.0 * pk * pk)
             - 6.02 * a["overall"][..., None].to(pk.dtype),
             "const_mnr": a["smr"]}.get(alloc)
    n_lines = cfg.band_layout.n_lines
    total = (torch.arange(48, dtype=torch.int32) * 97 + 1500)

    def allocate(dev, ch):
        t = total.to(dev)
        if alloc == "closed_form":
            return bitalloc.alloc_closed_form(t, 16, n_lines,
                                              a["smr"][:, ch].to(dev))
        if alloc == "uniform":
            return bitalloc.alloc_uniform_batch(t, 16, n_lines, 9000)
        return getattr(bitalloc, f"alloc_{alloc}_batch")(
            t, 16, n_lines, level[:, ch].to(dev), 9000)

    for ch in range(2):
        assert torch.equal(allocate(cuda, ch).cpu(), allocate("cpu", ch))
    cpu = Engine(device="cpu", cfg=cfg, precision=precision)
    stream = cpu.encode(pcm)
    _, gold = cpu.decode(stream)
    for route in ("host", "device"):
        _, out = Engine(device=cuda, cfg=cfg, precision=precision,
                        decode_parse=route).decode(stream)
        assert int(np.abs(out.astype(np.int32) - gold).max()) <= 1
    card = Engine(device=cuda, cfg=cfg, precision=precision)
    K.reset_launches()
    mine = card.encode(pcm)
    kern = {"closed_form": "closed_form", "uniform": None,
            "const_snr": "grant_fill", "const_mnr": "grant_fill"}[alloc]
    if kern:
        assert K.LAUNCHES[kern] == 4         # 2 channels x 2 passes
    assert K.LAUNCHES["water_fill"] == 0
    _, out = card.decode(mine)
    snr = [chip_smoke.snr_db(pcm, x) for x in (out, gold)]
    assert abs(snr[0] - snr[1]) <= 0.1
    assert abs(len(mine) - len(stream)) <= 0.01 * len(stream)


def test_engine_surface_on_the_card(cuda):
    """device_pack=False: the same bytes and no K3 launch; a trained table
    set decodes by both routes to the shipped cbr stream's samples; a set
    outside K5's LUT raises on the device route only."""
    from pactpu_torch import Engine
    from pactpu_torch.ops import huffman_train
    pcm = chip_smoke.synth(1.0, 8)
    main = Engine(device=cuda).encode(pcm)
    K.reset_launches()
    assert Engine(device=cuda, device_pack=False).encode(pcm) == main
    assert K.LAUNCHES["pack_words"] == K.LAUNCHES["pack_payload"] == 0
    shipped = Engine(device=cuda, rate_mode="cbr")
    _, ref = shipped.decode(shipped.encode(pcm))
    hist = np.zeros(huffman_train.NUM_SYMBOLS, np.int64)
    hist[:200] = np.arange(200, 0, -1) * 50
    tabs = huffman_train.train_tables({t: hist for t in range(1, 11)})
    stream = Engine(device=cuda, rate_mode="cbr", tables=tabs).encode(pcm)
    for route in ("host", "device"):
        _, out = Engine(device=cuda, rate_mode="cbr", tables=tabs,
                        decode_parse=route).decode(stream)
        assert np.array_equal(out, ref)
    unfit = chip_smoke.unfit_tables()
    stream = Engine(device=cuda, rate_mode="cbr", tables=unfit).encode(pcm)
    _, out = Engine(device=cuda, rate_mode="cbr", tables=unfit).decode(stream)
    assert np.array_equal(out, ref)
    with pytest.raises(ValueError, match="decode_parse='host'"):
        Engine(device=cuda, rate_mode="cbr", tables=unfit,
               decode_parse="device").decode(stream)


def _random_tables(rng, n_tab: int, n_sym: int):
    """A table set of n_tab tables over n_sym symbols with lengths 0..31
    (0: no code, the escape's length + the allocation) and escape lengths
    1..31, as int32 tensors (lengths, escape lengths)."""
    lens = rng.integers(0, 32, (n_tab, n_sym)).astype(np.int32)
    lens[rng.random((n_tab, n_sym)) < 0.3] = 0
    esc = rng.integers(1, 32, n_tab).astype(np.int32)
    return torch.from_numpy(lens), torch.from_numpy(esc)


@pytest.mark.parametrize("precision", ["f32", "f64"])
@pytest.mark.parametrize("layout", ["stereo", "mono", "40-bands", "96-bands",
                                    "6-size-bits"])
def test_cost_table(cuda, precision, layout):
    """K10 against its plain version on a 24-block chunk of a synthetic
    file, bit for bit."""
    from pactpu_torch.codec import engine as E
    cfg = {"stereo": CodecConfig(), "mono": CodecConfig(n_channels=1),
           "40-bands": CodecConfig(band_line_counts=chip_smoke.BANDS_40),
           "96-bands": CodecConfig(band_line_counts=chip_smoke.WIDE_BANDS),
           "6-size-bits": CodecConfig(n_mant_size_bits=6)}[layout]
    tables = E.device_tables(cfg, cuda, precision)
    pcm = chip_smoke.synth(24 * 1024 / chip_smoke.FS, 9)
    args = chip_smoke.k10_args(torch, cfg, tables, pcm, 24)
    K.reset_launches()
    out = K.cost_table(*args)
    torch.cuda.synchronize()
    assert K.LAUNCHES["cost_table"] == 1
    assert torch.equal(out, K.cost_table_plain(*args))


@pytest.mark.parametrize("n_tab,n_sym", [(1, 32768), (5, 100), (10, 4096),
                                         (16, 32768), (13, 5000)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_cost_table_tables(cuda, n_tab, n_sym, dtype):
    """K10 on random table sets of 1 to 16 tables (one to four 4-table
    words a symbol) over fewer symbols than the staged prefix and more,
    on lines that reach every symbol (loud lines near each band's peak,
    zeros, -0.0, overload at and past 1.0)."""
    from pactpu_torch.codec import engine as E
    rng = np.random.default_rng(n_tab * n_sym)
    cfg = CodecConfig()
    lay = E.device_tables(cfg, cuda)["lay"]
    lens, esc = _random_tables(rng, n_tab, n_sym)
    x = rng.uniform(-1.0, 1.0, (8, 2, 1024)) ** 3
    x[0, :, :64] = 0.0
    x[0, 1, 5] = -0.0
    x[1, :, ::50] = 1.0
    x[2, 0, 3] = -1.5
    mixed = torch.from_numpy(x).to(dtype).to(cuda)
    args = (mixed, lay, lens.to(cuda), esc.to(cuda), 4, 16)
    out = K.cost_table(*args)
    torch.cuda.synchronize()
    assert torch.equal(out, K.cost_table_plain(*args))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_cost_table_full_tables(cuda, dtype):
    """K10 on a table set with a code on every symbol (chip_smoke.
    full_tables): its packed set does not fit shared memory, and the
    kernel reads it from device memory; loud lines reach the symbols near
    the end of the set."""
    from pactpu_torch.codec import engine as E
    cfg = CodecConfig()
    lay = E.device_tables(cfg, cuda)["lay"]
    lens, _, esc, _ = chip_smoke.full_tables()
    packed, n_pack = K.pack_tables(torch.from_numpy(lens),
                                   torch.from_numpy(esc))
    assert n_pack == lens.shape[1] and packed.numel() * 4 > 232_448
    rng = np.random.default_rng(31)
    x = rng.uniform(-1.0, 1.0, (6, 2, 1024)) ** 3
    x[1, :, ::9] = 0.999
    x[2, 0, 3] = -1.5
    mixed = torch.from_numpy(x).to(dtype).to(cuda)
    args = (mixed, lay, torch.from_numpy(lens).to(cuda),
            torch.from_numpy(esc).to(cuda), 4, 16)
    out = K.cost_table(*args)
    torch.cuda.synchronize()
    assert torch.equal(out, K.cost_table_plain(*args))


def test_cost_table_packed_once(cuda):
    """The exact mode's cost table reads the table set its device tables
    packed once (exact.packed_tables): the same bits as the plain version
    and as packing on the call; a pack of another device or width is
    refused."""
    from pactpu_torch.codec import engine as E
    from pactpu_torch.codec import exact
    cfg = CodecConfig()
    tables = E.device_tables(cfg, cuda)
    pcm = chip_smoke.synth(24 * 1024 / chip_smoke.FS, 5)
    args = chip_smoke.k10_args(torch, cfg, tables, pcm, 24)
    packed = exact.packed_tables(tables)
    assert exact.packed_tables(tables) is packed
    out = exact.cost_table(cfg, dict(mixed=args[0]), tables)
    assert torch.equal(out, K.cost_table_plain(*args))
    assert torch.equal(out, K.cost_table(*args))
    with pytest.raises(ValueError, match="table set"):
        K.cost_table(*args, (packed[0].cpu(), packed[1]))
    with pytest.raises(ValueError, match="table set"):
        K.cost_table(*args, (packed[0].repeat(1, 2), packed[1]))


def test_cost_table_refuses_on_the_card(cuda):
    """More than 1,024 lines, 16 tables or an allocation past 16: raises,
    no launch."""
    from pactpu_torch.codec import engine as E
    lay = E.device_tables(CodecConfig(), cuda)["lay"]
    lens, esc = (t.to(cuda) for t in _random_tables(
        np.random.default_rng(0), 17, 64))
    mixed = torch.zeros((2, 2, 1024), device=cuda)
    K.reset_launches()
    with pytest.raises(ValueError):
        K.cost_table(mixed, lay, lens, esc, 4, 16)
    with pytest.raises(ValueError):
        K.cost_table(mixed, lay, lens[:4], esc[:4], 5, 16)
    assert K.LAUNCHES["cost_table"] == 0


@pytest.mark.parametrize("precision", ["f32", "f64"])
@pytest.mark.parametrize("case", ["nan", "neg-inf", "near-neg", "ties",
                                  "stop-binds", "zero-lines"])
def test_exact_scan_jump_edges(cuda, precision, case):
    """K7's jump on chunks whose SMRs the jump must leave to the steps (a
    NaN band, -inf and SMRs down to the retired bands' key) or take with
    care (all bands tied, thresholds above most statistics, zero-line
    bands): extras and carry bit-equal to the plain version's greedy
    steps."""
    from pactpu_torch.codec import engine as E
    cfg = (CodecConfig(band_line_counts=(0, 4, 0) + (40,) * 25 + (20,))
           if case == "zero-lines" else CodecConfig())
    tables = E.device_tables(cfg, cuda, precision)
    pcm = chip_smoke.synth(32 * 1024 / chip_smoke.FS, 11)
    args = list(chip_smoke.k7_args(torch, cfg, tables, pcm, 32))
    smr = args[0].clone()
    if case == "nan":
        smr[::3, :, 4] = float("nan")
    elif case == "neg-inf":
        smr[::2, 1, 7] = float("-inf")
    elif case == "near-neg":
        smr[:, 0, 2] = -1e30 + 80.0
    elif case == "ties":
        smr[::2] = 20.0
    elif case == "stop-binds":
        args[8], args[9] = 25.0, 15.0
    args[0] = smr.contiguous()
    got = K.exact_scan(*args)
    torch.cuda.synchronize()
    want = K.exact_scan_plain(*args, jump=False)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


# -- K11 reservoir_scan and the program layer ------------------------------

@pytest.mark.parametrize("name", chip_smoke.K11_EDGES)
def test_reservoir_scan_cases(cuda, name):
    """K11 on k11_edge's inputs: extras (as float32 bit patterns) and the
    carry bit-equal to the plain version's."""
    s, lf, v, c, d = (torch.from_numpy(a).to(cuda)
                      if isinstance(a, np.ndarray) else a
                      for a in chip_smoke.k11_edge(name))
    got = K.reservoir_scan(s, lf, v, c, d)
    torch.cuda.synchronize()
    want = K.reservoir_scan_plain(s, lf, v, c, d)
    assert torch.equal(got[0].view(torch.int32), want[0].view(torch.int32))
    assert torch.equal(got[1], want[1])


@pytest.mark.parametrize("blocks", [1, 31, 32, 33, 512, 4099])
def test_reservoir_scan_chunks(cuda, blocks):
    """K11 at chunk sizes around its 32-block pass, with a prefix count of
    valid blocks (the Engine's tail), chained twice from a carry."""
    rng = np.random.default_rng(blocks)
    sav = torch.from_numpy(rng.integers(-3000, 6000, (blocks, 2))
                           .astype(np.int32)).to(cuda)
    left = torch.from_numpy(rng.integers(-300, 300, blocks)
                            .astype(np.int32)).to(cuda)
    carry_k = carry_p = torch.tensor([25, -4], dtype=torch.int32,
                                     device=cuda)
    for n_valid in (blocks, blocks * 2 // 3):
        got = K.reservoir_scan(sav, left, n_valid, carry_k, 100)
        want = K.reservoir_scan_plain(sav, left, n_valid, carry_p, 100)
        torch.cuda.synchronize()
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
        carry_k, carry_p = got[1], want[1]


@pytest.mark.parametrize("rate_mode", ["reservoir", "cbr"])
def test_programs_equal_the_eager_chain(cuda, rate_mode):
    """A file of two full 64-block chunks and a 32-block tail, encoded and
    decoded twice by an Engine whose stages are programs: the second run
    (replays only) gives chip_smoke.eager_encode's bytes and
    eager_decode's samples by both parse routes, and so does
    roundtrip_many."""
    from pactpu_torch import Engine
    pcm = chip_smoke.synth(150 * 1024 / chip_smoke.FS, 12)
    eng = Engine(device=cuda, rate_mode=rate_mode, chunk_blocks=64)
    dev = Engine(device=cuda, rate_mode=rate_mode, chunk_blocks=64,
                 decode_parse="device")
    want = chip_smoke.eager_encode(eng, pcm)
    want_pcm = chip_smoke.eager_decode(eng, want)[1]
    for _ in range(2):
        got = eng.encode(pcm)
        assert got == want
        assert np.array_equal(eng.decode(got)[1], want_pcm)
        assert np.array_equal(dev.decode(got)[1], want_pcm)
    (fs, out), = eng.roundtrip_many([pcm])
    assert np.array_equal(out, want_pcm)
    sizes = sorted(k[1][0][0][0] for k, p in eng.programs.items("final"))
    assert sizes == [32, 64]
    assert all(p.replays > 0 for st in ("analyze", "final", "decode")
               for _, p in eng.programs.items(st))


def test_programs_count_the_eager_launches(cuda):
    """LAUNCHES after replays equal those of the same encode and decodes
    launch by launch, kernel by kernel."""
    from pactpu_torch import Engine
    pcm = chip_smoke.synth(150 * 1024 / chip_smoke.FS, 13)

    def run(eng, dev):
        K.reset_launches()
        s = eng.encode(pcm)
        eng.decode(s)
        dev.decode(s)
        torch.cuda.synchronize()
        return s, dict(K.LAUNCHES)

    make = lambda **kw: Engine(device=cuda, chunk_blocks=64, **kw)  # noqa
    eng, dev = make(), make(decode_parse="device")
    run(eng, dev)                                    # builds the programs
    got = run(eng, dev)
    eng, dev = make(), make(decode_parse="device")
    eng.use_programs = dev.use_programs = False      # launch by launch
    want = run(eng, dev)
    assert got[0] == want[0]
    assert got[1] == want[1] and got[1]["reservoir_scan"] == 3


def test_a_stage_that_syncs_raises_at_capture(cuda):
    """A stage with a host sync (.item()) cannot be captured: the program
    raises CaptureError naming the stage, and nothing runs in its place."""
    from pactpu_torch.codec import programs
    progs = programs.Programs(cuda)
    x = torch.arange(8.0, device=cuda)

    def stage(t):
        return t * float(t.sum().item())

    with pytest.raises(programs.CaptureError, match="'syncs'"):
        progs.run("syncs", (), stage, (x,))
    assert progs.items("syncs") == []
    # the card takes work after the failed capture, and so do captures
    assert float((x + 1).sum().item()) == 36.0
    for _ in range(2):
        assert torch.equal(progs.run("doubles", (), lambda t: t * 2, (x,)),
                           x * 2)
    (_, prog), = progs.items("doubles")
    assert prog.replays == 1


def test_programs_outlive_the_table_caches(cuda):
    """An Engine's programs, built, then the module caches of device
    tables that their graphs read filled with more keys than they once
    held and the freed memory handed out and overwritten: the replays
    still give the eager stage chain's bytes and samples."""
    import gc
    from pactpu_torch import Engine
    from pactpu_torch.ops import bitpack
    pcm = chip_smoke.synth(150 * 1024 / chip_smoke.FS, 15)
    eng = Engine(device=cuda, chunk_blocks=64)
    dev = Engine(device=cuda, chunk_blocks=64, decode_parse="device")
    want = chip_smoke.eager_encode(eng, pcm)
    want_pcm = chip_smoke.eager_decode(eng, want)[1]
    s = eng.encode(pcm)                              # builds the programs
    eng.decode(s)
    dev.decode(s)
    for k in range(20):
        lay = (4 + k, 8, 12)
        bitpack.device_plan(lay, 4, 4, 4, cuda)
        bitpack._plan_tensors(lay, 4, 4, 4, cuda)
        K._band_tensor(lay, torch.device(cuda))
        K._exp2_ks(torch.device(cuda), torch.float32, 9 + k, 15)
    gc.collect()
    torch.cuda.empty_cache()
    junk = [torch.full((1 << 16,), -1, dtype=torch.int32, device=cuda)
            for _ in range(256)]
    got = eng.encode(pcm)
    assert got == want
    assert np.array_equal(eng.decode(got)[1], want_pcm)
    assert np.array_equal(dev.decode(got)[1], want_pcm)
    assert all(p.replays > 0 for st in ("analyze", "measure", "final")
               for _, p in eng.programs.items(st))
    del junk


def test_capture_counts_its_own_launches(cuda):
    """A program captured while another thread launches K11 on its own
    stream: the program keeps the two launches of its stage, LAUNCHES
    the other thread's and the warm-up's, and each replay adds two."""
    import threading
    from pactpu_torch.codec import programs
    sav = torch.ones((64, 2), dtype=torch.int32, device=cuda)
    left = torch.zeros(64, dtype=torch.int32, device=cuda)
    valid = torch.ones(64, dtype=torch.bool, device=cuda)
    carry = torch.zeros(2, dtype=torch.int32, device=cuda)

    def stage(s):
        ex, c = K.reservoir_scan(s, left, valid, carry, 100)
        return K.reservoir_scan(s, left, valid, c, 100)

    want = K.reservoir_scan_plain(sav.cpu(), left.cpu(), valid.cpu(),
                                  K.reservoir_scan_plain(
                                      sav.cpu(), left.cpu(), valid.cpu(),
                                      carry.cpu(), 100)[1], 100)
    done, started = threading.Event(), threading.Event()
    n_other = [0]

    def other():
        with torch.cuda.stream(torch.cuda.Stream(cuda)):
            while not done.is_set():
                K.reservoir_scan(sav, left, valid, carry, 100)
                n_other[0] += 1
                started.set()
            torch.cuda.current_stream().synchronize()

    K.reset_launches()
    t = threading.Thread(target=other)
    t.start()
    started.wait()
    try:
        prog, warm = programs.Program.build("two_scans", stage, (sav,),
                                            torch.device(cuda))
    finally:
        done.set()
        t.join()
    assert prog.launches == {"reservoir_scan": 2}
    assert K.LAUNCHES["reservoir_scan"] == n_other[0] + 2
    got = prog(sav)
    torch.cuda.synchronize()
    assert K.LAUNCHES["reservoir_scan"] == n_other[0] + 4
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)


def test_reservoir_dispatch_makes_no_sync(cuda):
    """The reservoir encode's dispatch half, its programs built, under
    set_sync_debug_mode("error"): no host sync, no device-to-host copy;
    the payload then downloaded gives the Engine's bytes."""
    from pactpu_torch import Engine
    from pactpu_torch.codec.header import write_header
    pcm = chip_smoke.synth(150 * 1024 / chip_smoke.FS, 14)
    eng = Engine(device=cuda, chunk_blocks=64)
    want = eng.encode(pcm)
    up = eng._upload_pcm(pcm, eng._analysis_batches)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        st = eng._encode_dispatch(up)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert write_header(eng.cfg, pcm.shape[0])[0] + \
        eng._finish_encode(st) == want


PROGRAM_MODES = dict(chip_smoke.PROGRAM_MODES)


@pytest.mark.parametrize("name", list(PROGRAM_MODES))
def test_program_modes_equal_launch_by_launch(cuda, name):
    """Each configuration of chip_smoke.PROGRAM_MODES (the exact mode in
    both precisions, the other allocators, device_pack=False) on a file of
    two full 64-block chunks and a 32-block tail, encoded twice through
    programs: the same bytes and last_extras as the same Engine launch by
    launch, the decode by both parse routes the eager decode's samples,
    every stage of chip_smoke.program_stages a program that replayed, and
    the dispatch half with no host sync."""
    from pactpu_torch import CodecConfig as Config
    from pactpu_torch import Engine
    from pactpu_torch.codec import programs
    from pactpu_torch.codec.header import write_header
    kw = dict(PROGRAM_MODES[name], chunk_blocks=64)
    if "alloc_mode" in kw:
        kw["cfg"] = Config(alloc_mode=kw.pop("alloc_mode"))
    pcm = chip_smoke.synth(150 * 1024 / chip_smoke.FS, 15)
    eng = Engine(device=cuda, **kw)
    dev = Engine(device=cuda, decode_parse="device", **kw)
    eng.use_programs = False
    want = eng.encode(pcm)
    want_extras = eng.last_extras
    want_pcm = eng.decode(want)[1]
    eng.use_programs = True
    for _ in range(2):
        assert eng.encode(pcm) == want
        assert np.array_equal(eng.last_extras, want_extras)
        assert np.array_equal(eng.decode(want)[1], want_pcm)
        assert np.array_equal(dev.decode(want)[1], want_pcm)
    stages = chip_smoke.program_stages(kw)
    assert {s for s, on in programs.encode_programs(eng).items()
            if on} == stages
    for stage in stages:
        sizes = sorted(k[1][0][0][0] for k, _ in eng.programs.items(stage)
                       if stage != "analyze")
        assert stage == "analyze" or sizes == [32, 64], stage
        assert all(p.replays > 0 for _, p in eng.programs.items(stage))
    up = eng._upload_pcm(pcm, eng._analysis_batches)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        st = eng._encode_dispatch(up)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert write_header(eng.cfg, pcm.shape[0])[0] + \
        eng._finish_encode(st) == want


@pytest.mark.parametrize("precision", ["f32", "f64"])
def test_exact_scan_valid_mask(cuda, precision):
    """K7 reading its valid mask from device memory: every prefix length
    (none, part, all) from a mask, from a mask that starts off any
    alignment (a view one byte in) and from the count, bit-equal to its
    plain version with the same mask."""
    from pactpu_torch.codec import engine as E
    cfg = CodecConfig()
    tables = E.device_tables(cfg, cuda, precision)
    pcm = chip_smoke.synth(48 * 1024 / chip_smoke.FS, 8)
    args = chip_smoke.k7_args(torch, cfg, tables, pcm, 48)
    carry = torch.tensor([5000, -12], dtype=torch.int32, device=cuda)
    for n in (0, 1, 17, 33, 47, 48):
        valid = torch.arange(48, device=cuda) < n
        shifted = torch.zeros(49, dtype=torch.bool, device=cuda)
        shifted[1:] = valid
        want = K.exact_scan_plain(*args[:3], valid, carry, *args[5:])
        for v in (valid, shifted[1:], n):
            got = K.exact_scan(*args[:3], v, carry, *args[5:])
            torch.cuda.synchronize()
            assert torch.equal(got[0], want[0]), (n, v)
            assert torch.equal(got[1], want[1]), (n, v)
        assert not want[0][n:].any()


def test_cost_replays_beside_scan_replays(cuda):
    """The exact mode's cost program (K10) replays on the side stream
    beside the main stream's exact_scan program (K7): the two take
    separate memory pools, the bytes are the eager chain's, and the
    replays did run at once on the card (a cost replay's span, by CUDA
    events on its stream, overlaps a K7 replay's)."""
    from pactpu_torch import Engine
    from pactpu_torch.codec import programs
    pcm = chip_smoke.synth(2000 * 1024 / chip_smoke.FS, 16)
    eng = Engine(device=cuda, rate_mode="exact", chunk_blocks=512)
    eng.use_programs = False
    want = eng.encode(pcm)
    eng.use_programs = True
    assert eng.encode(pcm) == want                # builds the programs
    spans, host = [], []
    call = programs.Program.__call__

    def traced(self, *args):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        out = call(self, *args)
        ev[1].record()
        spans.append((self.stage, *ev))
        host.append((self.stage, time.perf_counter()))
        return out

    programs.Program.__call__ = traced
    try:
        for _ in range(2):
            assert eng.encode(pcm) == want
    finally:
        programs.Program.__call__ = call
    torch.cuda.synchronize()
    t0 = spans[0][1]
    ms = [(st, t0.elapsed_time(a), t0.elapsed_time(b)) for st, a, b in spans]
    cost = [(a, b) for st, a, b in ms if st == "cost"]
    scan = [(a, b) for st, a, b in ms if st == "exact_scan"]
    assert any(a < d and c < b for a, b in cost for c, d in scan), (ms, [
        (st, t - host[0][1]) for st, t in host])
    pools = eng.programs._pools
    assert set(pools) == {"main", "side"} and pools["main"] != pools["side"]
    reserved = eng.programs.reserved()
    assert reserved["side"] > 0 and reserved["main"] > 0


def test_capture_off_the_current_device(cuda):
    """An Engine on the second card used while the first is current: its
    programs capture there, and their replays give the bytes of the same
    Engine launch by launch (the card's machine has one card: skipped
    there)."""
    from pactpu_torch import Engine
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    pcm = chip_smoke.synth(150 * 1024 / chip_smoke.FS, 17)
    eng = Engine(device="cuda:1", chunk_blocks=64)
    eng.use_programs = False
    want = eng.encode(pcm)
    eng.use_programs = True
    with torch.cuda.device(0):
        got = [eng.encode(pcm) for _ in range(3)]
    assert got == [want] * 3


def test_stream_push_replays_with_no_sync(cuda):
    """A StreamingEncoder's pushes through its Engine's programs (the
    analysis, the measurement pass with K11, the final pass): the stream
    of 1 s pushes is the bytes of the same stream launch by launch and of
    Engine.encode, a push's dispatch (StreamingEncoder._dispatch) runs
    with no host sync, and the streamed decode's synthesis replays a
    program and gives the launch-by-launch samples."""
    from pactpu_torch import Engine, StreamingEncoder
    from pactpu_torch.codec import programs
    fs = chip_smoke.FS
    pcm = chip_smoke.synth(4.0, 16)
    gold = Engine(device=cuda).encode(pcm)
    cuts = list(range(0, pcm.shape[0], fs)) + [pcm.shape[0]]
    with programs.launch_by_launch():
        ref = chip_smoke.stream_encode(pcm, cuts)
        ref_pcm = chip_smoke.stream_decode(gold, 16)
    engines = []
    assert chip_smoke.stream_encode(pcm, cuts, engines=engines) == ref == gold
    assert all(engines[0].programs.replays()[st] > 0
               for st in ("analyze", "measure", "final"))
    enc = StreamingEncoder(device=cuda)
    parts = [enc.header(pcm.shape[0]), enc.push(pcm[:fs])]
    enc._dispatch = chip_smoke.no_sync(torch, enc._dispatch)
    parts.append(enc.push(pcm[fs:2 * fs]))
    del enc._dispatch
    parts += [enc.push(pcm[2 * fs:]), enc.flush()]
    assert b"".join(parts) == gold
    decoders = []
    assert np.array_equal(chip_smoke.stream_decode(gold, 16,
                                                   engines=decoders), ref_pcm)
    assert decoders[0].programs.replays()["synthesize"] > 0


def test_shard_encode_replays_with_no_sync(cuda):
    """encode_distributed on a mesh of three shards of one card through
    the shard devices' owner: the bytes of the same encode launch by
    launch and of the cbr Engine; a second call captures nothing; the
    shards' dispatch (shard.sharded_encode) runs with no host sync; and
    decode_distributed gives the launch-by-launch samples."""
    from pactpu_torch import Engine
    from pactpu_torch.codec import programs
    from pactpu_torch.parallel import cluster, shard
    pcm = chip_smoke.synth(8.0, 18)
    mesh = shard.make_mesh(["cuda:0"] * 3)
    gold = Engine(device=cuda, rate_mode="cbr").encode(pcm)

    def dist():
        res = cluster.encode_distributed(pcm, mesh=mesh, rate_mode="cbr")
        return cluster.assemble_stream(res.header, [(0, res.payload)])

    def dist_dec():
        res = cluster.decode_distributed(gold, mesh=mesh)
        return res.pcm

    with programs.launch_by_launch():
        ref, ref_pcm = dist(), dist_dec()
    assert dist() == ref == gold
    own = shard.mesh_owners(CodecConfig(), mesh)[0]
    captured = own.programs.captures
    sharded = shard.sharded_encode
    shard.sharded_encode = chip_smoke.no_sync(torch, sharded)
    try:
        assert dist() == gold
    finally:
        shard.sharded_encode = sharded
    assert own.programs.captures == captured
    assert np.array_equal(dist_dec(), ref_pcm)
    replays = own.programs.replays()
    assert all(replays[st] > 0 for st in ("analyze", "shard_final",
                                          "shard_decode"))


@pytest.mark.parametrize("channels", [2, 1])
def test_pac_replays_with_no_sync(cuda, channels):
    """The .pac coder through programs ("baseline", and the decode by host
    and device parse): the bytes and samples of the same Engines launch
    by launch; the encode's dispatch (Engine._baseline_dispatch) and the
    device-parse decode's (Engine._decode_queue) run with no host sync."""
    from pactpu_torch import Engine
    from pactpu_torch.codec import programs
    cfg = CodecConfig(n_channels=channels)
    pcm = np.ascontiguousarray(chip_smoke.synth(6.0, 19)[:, :channels])
    eng = Engine(device=cuda, cfg=cfg, fmt="pac")
    dev = Engine(device=cuda, cfg=cfg, fmt="pac", decode_parse="device")
    with programs.launch_by_launch():
        want = eng.encode(pcm)
        want_pcm = eng.decode(want)[1]
        assert np.array_equal(dev.decode(want)[1], want_pcm)
    for _ in range(2):
        assert eng.encode(pcm) == want
        assert np.array_equal(eng.decode(want)[1], want_pcm)
        assert np.array_equal(dev.decode(want)[1], want_pcm)
    eng._baseline_dispatch = chip_smoke.no_sync(torch,
                                                eng._baseline_dispatch)
    dev._decode_queue = chip_smoke.no_sync(torch, dev._decode_queue)
    assert eng.encode(pcm) == want
    assert np.array_equal(dev.decode(want)[1], want_pcm)
    assert eng.programs.replays()["baseline"] > 0
    assert dev.programs.replays()["decode_device_parse"] > 0
