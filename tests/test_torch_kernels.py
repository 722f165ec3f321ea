"""PyTorch port, kernels K1-K4: on the CPU each wrapper runs its plain
PyTorch version, which must compute what the JAX package's Pallas kernel
(in interpret mode) or its XLA reference computes, on the same numpy
inputs."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from pactpu import native as jnative
from pactpu.ops import bitalloc as jba
from pactpu.ops import bitpack as jbp
from pactpu.ops import pallas_ops as po
from pactpu.ops import psycho as jpsy
from pactpu.ops.windows import sine_window
from pactpu.utils.config import CodecConfig
from pactpu_torch import native as tnative
from pactpu_torch.codec import engine as te
from pactpu_torch.ops import bitpack as tbp
from pactpu_torch.ops import kernels as K
from pactpu_torch.ops import psycho as tpsy
from pactpu_torch.utils.config import BandLayout
from pactpu_torch.utils.config import CodecConfig as TorchConfig

t = lambda a: torch.from_numpy(np.array(a))  # noqa: E731


@pytest.fixture(scope="module")
def dev():
    return te.device_tables(TorchConfig(), "cpu")


def test_extract_codes_matches_pallas():
    """K1: repacked mantissa fields (native.repack_codes) come back
    exactly, as from pactpu's extract_codes kernel in interpret mode,
    fields spanning two words included.  Eight bands of 32 lines keep the
    interpreted kernel small."""
    n_lines = np.full(8, 32, np.int32)
    lay = tpsy.layout_tensors(BandLayout(tuple(int(n) for n in n_lines)),
                              "cpu")
    seg = lay["seg"].numpy()
    rng = np.random.default_rng(3)
    r, total = 9, int(n_lines.sum())
    ba = rng.integers(0, 17, (r, len(n_lines))).astype(np.int32)
    ba[ba == 1] = 0
    ba[0] = 16                                   # a full 128-word row
    width = ba[:, seg]
    mant = np.where(width > 0, rng.integers(0, 2 ** 16, (r, total))
                    & ((1 << width) - 1), 0).astype(np.int32)
    words = jnative.repack_codes(mant, ba, n_lines, 128)
    np.testing.assert_array_equal(
        tnative.repack_codes(mant, ba, n_lines, 128), words)
    off, wid, total_bits = te._line_bit_offsets(t(ba), lay)
    np.testing.assert_array_equal(wid.numpy(), width)
    np.testing.assert_array_equal(off.numpy(), np.cumsum(width, 1) - width)
    assert ((off.numpy() & 31) + width > 32).any()
    gold = po.extract_codes(jnp.asarray(words), jnp.asarray(off.numpy()),
                            jnp.asarray(width), interpret=True)
    mine = K.extract_codes(t(words.view(np.int32)), off, wid)
    np.testing.assert_array_equal(mine.numpy(), np.asarray(gold))
    np.testing.assert_array_equal(mine.numpy(), mant)


def test_extract_codes_reads_zero_past_the_row():
    """A field that runs off the last word reads zeros (the flat decode's
    over-read of a row's final word stays harmless)."""
    words = t(np.array([[0x80000001, 0x7]], np.uint32).view(np.int32))
    off = t(np.array([[0, 31, 60, 62, 64]], np.int32))
    width = t(np.array([[1, 2, 4, 4, 8]], np.int32))
    out = K.extract_codes(words, off, width).numpy()
    np.testing.assert_array_equal(out, [[1, 2, 7, 12, 0]])


def test_water_fill_matches_xla_loop():
    """K2: bit-identical with bitalloc.water_fill's XLA loop at R = 13,
    with a zero budget, tied SMRs and a budget that reaches the cap."""
    n_lines = np.asarray(CodecConfig().band_layout.n_lines, np.int32)
    rng = np.random.default_rng(5)
    r = 13
    smr = rng.uniform(-20, 60, (r, 25)).astype(np.float32)
    smr[3] = 12.5                                # every band tied
    smr[4, ::2] = smr[4, 1]                      # pairwise ties
    lrms = rng.random((r, 25)) < 0.4
    totals = rng.integers(0, 3000, r).astype(np.int32)
    totals[0] = 0
    totals[5] = 200000                           # bands hit 16 bits
    gold_bits, gold_left = jba.water_fill(jnp.asarray(totals), 16, n_lines,
                                          jnp.asarray(smr),
                                          jnp.asarray(lrms), use_pallas=False)
    bits, left = K.water_fill(t(totals), 16, t(n_lines), t(smr), t(lrms))
    np.testing.assert_array_equal(bits.numpy(), np.asarray(gold_bits))
    np.testing.assert_array_equal(left.numpy(), np.asarray(gold_left))
    assert not bits[0].any() and int(bits[5].max()) == 16


@pytest.mark.parametrize("name", [n for n in chip_smoke.K2_EDGES
                                  if n not in ("nan", "dead-key")])
def test_water_fill_edge_inputs_match_xla_loop(name):
    """K2's edge inputs (chip_smoke.k2_edge; the CUDA kernel is held to
    water_fill_plain on them on the card): the plain version is
    bit-identical with bitalloc.water_fill's XLA loop on -0.0 beside +0.0,
    ties, 1 and 32 bands, zero budgets, every band at the cap and a
    one-bit cap."""
    total, max_mant, n_lines, smr, lrms = chip_smoke.k2_edge(name)
    gold_bits, gold_left = jba.water_fill(
        jnp.asarray(total), max_mant, n_lines, jnp.asarray(smr),
        jnp.asarray(lrms), use_pallas=False)
    bits, left = K.water_fill(t(total), max_mant, t(n_lines), t(smr),
                              t(lrms))
    np.testing.assert_array_equal(bits.numpy(), np.asarray(gold_bits))
    np.testing.assert_array_equal(left.numpy(), np.asarray(gold_left))
    if name == "neg-zero":
        # -0.0 bands ahead of +0.0 ones and of 6.0 bands that meet them at
        # key 0 once they hold a bit: the order of the ties decides which
        # bands reach a second bit before the budget ends
        assert np.signbit(smr[:, 0]).all() and not np.signbit(smr).all()
        assert int(bits.max()) >= 2
    if name == "to-the-cap":
        assert (bits.numpy() == 16).all()


@pytest.mark.parametrize("name", ["no-peak", "all-peaks"])
def test_spread_up_edge_rows_match_pallas(name):
    """K4's edge rows (chip_smoke.k4_edge): the plain upslope sum against
    pactpu's kernel in interpret mode on a row with no peak and on a row
    where every bin is a peak, rtol 1e-5 as in
    test_spread_up_matches_pallas."""
    ip, mspl, bark, zvec = chip_smoke.k4_edge(name)
    gold = np.asarray(po.spread_maskers_up(jnp.asarray(ip),
                                           jnp.asarray(mspl), bark, zvec,
                                           interpret=True))
    mine = K.spread_maskers_up(t(ip), t(mspl), t(bark), t(zvec)).numpy()
    assert (gold > 0).any()
    if name == "no-peak":
        assert not mine[1].any() and not gold[1].any()
    else:
        assert (ip[0] != 0).all()
    np.testing.assert_allclose(mine, gold, rtol=1e-5, atol=0)


@pytest.mark.parametrize("n_words", [16, 40])
def test_pack_words_matches_scatter_add(n_words):
    """K3: bit-identical with the scatter-add of bitpack.pack_payload_bits,
    parts past the last word dropped."""
    rng = np.random.default_rng(7)
    r, m = 5, 300
    part0 = rng.integers(0, 2 ** 32, (r, m), dtype=np.uint64).astype(
        np.uint32)
    part1 = rng.integers(0, 2 ** 32, (r, m), dtype=np.uint64).astype(
        np.uint32)
    w0 = np.sort(rng.integers(0, 40, (r, m))).astype(np.int32)
    gold = jnp.zeros((r, n_words), jnp.uint32)
    rows = jnp.broadcast_to(jnp.arange(r)[:, None], w0.shape)
    gold = gold.at[rows, w0].add(part0, mode="drop")
    gold = gold.at[rows, w0 + 1].add(part1, mode="drop")
    mine = K.pack_words(t(part0.view(np.int32)), t(part1.view(np.int32)),
                        t(w0), n_words)
    np.testing.assert_array_equal(mine.numpy().view(np.uint32),
                                  np.asarray(gold))


def test_compact_rows_matches():
    rng = np.random.default_rng(9)
    words = rng.integers(0, 2 ** 32, (6, 8), dtype=np.uint64).astype(
        np.uint32)
    nbits = np.array([0, 1, 255, 256, 100, 33], np.int32)
    for cap in (40, 12):                         # fits / overflows
        gold = np.asarray(jbp.compact_rows(jnp.asarray(words),
                                           jnp.asarray(nbits), cap))
        mine = tbp.compact_rows(t(words.view(np.int32)), t(nbits), cap)
        np.testing.assert_array_equal(mine.numpy().view(np.uint32), gold)


@pytest.fixture(scope="module")
def blocks() -> np.ndarray:
    """Four windowed test blocks (those of tests/test_pallas_ops.py)."""
    rng = np.random.default_rng(11)
    n = 2048
    s = np.arange(n)
    x = np.stack([
        0.4 * np.sin(2 * np.pi * 441 * s / 44100.0)
        + 0.2 * np.sin(2 * np.pi * 3000 * s / 44100.0),
        rng.normal(0, 0.05, n),
        0.6 * np.sin(2 * np.pi * 880 * s / 44100.0)
        + rng.normal(0, 0.01, n),
        np.zeros(n),
    ]).astype(np.float32)
    return x * sine_window(n).astype(np.float32)


def test_spread_up_matches_pallas(blocks, dev):
    """K4 alone: the plain upslope sum against pactpu's kernel in
    interpret mode, on the same masker levels.  rtol 1e-5 on the
    intensity: only the order of the masker sum and the exp2 rounding
    differ (a few float32 ulp)."""
    mspl, peak = jpsy.masker_levels(jnp.asarray(blocks), 44100)
    drop = jnp.asarray([15.0, 15.0, 0.0, 15.0], jnp.float32)
    iprime = jnp.where(peak, jnp.exp2(po._LOG2_10_OVER_10 * (
        mspl - drop[:, None] - 96.0)), 0.0)
    _, zvec, bark = jpsy._consts(2048, 44100)[:3]
    gold = np.asarray(po.spread_maskers_up(iprime, mspl, bark, zvec,
                                           interpret=True))
    mine = K.spread_maskers_up(t(iprime), t(mspl), dev["psy"]["bin_bark"],
                               dev["psy"]["zvec"]).numpy()
    assert (gold > 0).any()
    np.testing.assert_allclose(mine, gold, rtol=1e-5, atol=0)


def test_masked_threshold_matches_pallas_path(blocks, dev, monkeypatch):
    """The port's dense threshold (nonup product + plain K4) from pactpu's
    own masker levels against pactpu's masked_threshold(use_pallas=True)
    with its upslope kernel in interpret mode: within 1e-4 dB."""
    mspl, peak = jpsy.masker_levels(jnp.asarray(blocks), 44100)
    drop = np.asarray([15.0, 0.0, 15.0, 15.0], np.float32)
    real = po.spread_maskers_up
    monkeypatch.setattr(po, "spread_maskers_up",
                        lambda *a, **k: real(*a, interpret=True, **k))
    gold = np.asarray(jpsy.masked_threshold(jnp.asarray(blocks),
                                            jnp.asarray(drop), 44100,
                                            use_pallas=True))
    mine = tpsy.threshold_from_maskers(t(mspl), t(peak), t(drop),
                                       dev["psy"]).numpy()
    np.testing.assert_allclose(mine, gold, rtol=0, atol=1e-4)


def test_masked_threshold_matches_xla_path(blocks, dev):
    """From the same masker levels, the port's dense threshold against
    pactpu's compact XLA path, at that path's existing 1e-4 tolerance
    (tests/test_pallas_ops.py)."""
    mspl, peak = jpsy.masker_levels(jnp.asarray(blocks), 44100)
    drop = np.asarray([15.0, 15.0, 0.0, 15.0], np.float32)
    gold = np.asarray(jpsy.masked_threshold(jnp.asarray(blocks),
                                            jnp.asarray(drop), 44100,
                                            use_pallas=False))
    mine = tpsy.threshold_from_maskers(t(mspl), t(peak), t(drop),
                                       dev["psy"]).numpy()
    np.testing.assert_allclose(mine, gold, rtol=1e-4, atol=1e-4)


def test_masker_levels(blocks, dev):
    """The port's own masker levels: the same peaks as pactpu's, SPLs
    equal to a float64 evaluation of the same FFT to 1e-3 dB, and the
    thresholds within 0.05 dB of pactpu's.  pactpu takes the 6-bin window
    sums as differences of a float32 running sum, which cancel above a
    loud low bin (up to ~0.4 dB on these blocks); the port takes them in
    float64."""
    mspl_j, peak_j = (np.asarray(a) for a in jpsy.masker_levels(
        jnp.asarray(blocks), 44100))
    mspl, peak = tpsy.masker_levels(t(blocks), dev["psy"]["hann"])
    np.testing.assert_array_equal(peak.numpy(), peak_j)
    spec = torch.fft.rfft(t(blocks) * dev["psy"]["hann"])[..., :1024]
    p2 = (spec.real ** 2 + spec.imag ** 2).double().numpy()
    cs = np.concatenate([np.zeros((4, 1)), np.cumsum(p2, -1)], 1)
    idx = np.arange(1024)
    win = np.where(idx >= 3, cs[:, np.minimum(idx + 2, 1023) + 1]
                   - cs[:, np.maximum(idx - 4, -1) + 1], 0.0)
    i = np.maximum((8.0 / 3.0) * 4.0 / 2048 ** 2 * win, 10 ** -12.6)
    gold64 = np.maximum(96.0 + 10.0 * np.log10(i), -30.0)
    np.testing.assert_allclose(mspl.numpy(), gold64, rtol=0, atol=1e-3)
    drop = np.asarray([15.0, 15.0, 0.0, 15.0], np.float32)
    gold = np.asarray(jpsy.masked_threshold(jnp.asarray(blocks),
                                            jnp.asarray(drop), 44100,
                                            use_pallas=False))
    mine = tpsy.masked_threshold(t(blocks), t(drop), dev["psy"]).numpy()
    np.testing.assert_allclose(mine, gold, rtol=0, atol=0.05)


def test_wrappers_refuse_bad_inputs():
    a = torch.zeros((2, 4), dtype=torch.int32)
    with pytest.raises(TypeError):
        K.extract_codes(a.float(), a, a)
    with pytest.raises(ValueError):
        K.extract_codes(a, a.t(), a.t())         # not contiguous
    with pytest.raises(ValueError):
        K.pack_words(a, a, a[:1], 4)
    with pytest.raises(ValueError):
        K.extract_codes(a.to("meta"), a.to("meta"), a.to("meta"))
