"""Bit-exact float64 oracle of the reference WAK codec (pactpu.compat.
refcodec, restated inside the port).

A from-formulas Python 3 / numpy re-statement of the exact numerical
semantics of the reference encoder/decoder (reference codec/*.py, Python 2),
**including its observed quirks**, so that:

- the port's f64 engine (Engine(rate_mode="exact", precision="f64")) can be
  held byte for byte to the reference's serial encode on a machine that
  cannot import the JAX package,
- the reference's golden `.wak` bitstreams can be decoded and
  byte-reproduced,
- SNR parity of the fast float32 path can be measured against reference
  output.

It reads the port's CodecConfig and its copy of the shipped Huffman tables
(pactpu_torch/data/huffman_tables.npz); it is numpy only, the independent
reference, not device code.

Quirks deliberately reproduced (see SURVEY.md §8 plus two found during this
port):

Q1  M/S decode aliasing: the decoder emits L' = M - S and R' = M (not the
    paper's L=M+S/R=M-S) because the L buffer is overwritten before R is
    computed (reference codec/codec.py:46-56).
Q2  In-place window mutation compounding: the psych side chain sees
    hann*sine windowed L/R; the M/S arrays are built *after* L/R were
    hann-windowed, so BTHR_M/S see hann^2*sine*M/S and the no-drop MLD
    variants see hann^3*sine*M/S (codec/window.py:37,51;
    codec/codec.py:239-240; codec/psychoac.py:428,540-562).
Q3  findpeaks parabolic interpolation is dead in Py2 ((1/2)==0): peak freq =
    bin * (sampleRate/N) (codec/psychoac.py:186-189).
Q4  **Py2 integer division in peak frequencies**: sampleRate and N are ints,
    so (sampleRate/N) = 44100/2048 = 21 — every masker sits on a 21 Hz grid
    instead of 21.53 Hz (codec/psychoac.py:188).
Q5  masker SPL window `X[i-3:i+3]` is an *empty* slice when i < 3 (negative
    python slice start), giving a -30 dB floor masker (codec/psychoac.py:245).
Q6  header zero-padding condition inverted: numSamples is grown by one block
    exactly when it is already divisible by nMDCTLines (codec/pacfile.py:240).
Q7  bitstream field order ba-then-scaleFactor; ba stored minus 1 when
    nonzero (codec/pacfile.py:330-332).
Q8  sign bits first, then Huffman codes, per band; escape emits the
    bitAlloc-bit raw unsigned mantissa (codec/pacfile.py:334-342,
    codec/Huffman.py:294-298).
Q9  LRMS flags written once per channel and re-read into the same array
    (codec/pacfile.py:214-217, 345-348).
Q10 reservoir: withdraw floor(deposit/100) when deposit > 10, the whole
    (negative) deposit when deposit < 0; channel 0's allocation surplus
    funds channel 1 in the same block (codec/Huffman.py:363-371,
    codec/codec.py:229,258-260).
Q11 BitAlloc's stop test uses the *global* max residual max(SMR-(bits-1)*6)
    with a threshold chosen by the current argmax band's LRMS flag, and the
    candidate still receives the bit on the iteration that invalidates it
    (codec/bitalloc.py:163-176).
Q12 one-bit allocations are zeroed and refunded after the loop
    (codec/bitalloc.py:179-180).
Q13 scale factors are computed and written even for zero-bit bands
    (codec/codec.py:273-274, codec/pacfile.py:332).
Q14 the LRMS decision uses complex squares of the unwindowed block FFT:
    |sum(L_k^2 - R_k^2)| < 0.8 |sum(L_k^2 + R_k^2)| (codec/codec.py:97-102).
Q15 MDCT M/S mixing averages channel lines *after* each channel was scaled
    by its own 2^overallScale (codec/psychoac.py:551).
"""

from __future__ import annotations

import os
import struct
from dataclasses import dataclass, field
from typing import List, Optional, Tuple

import numpy as np

from pactpu_torch.codec.wav import float_to_pcm16_np, pcm16_to_float_np
from pactpu_torch.utils.config import CodecConfig, assign_mdct_lines

# this package's copy of the shipped Huffman tables
TABLES_NPZ = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "data",
    "huffman_tables.npz")

# --------------------------------------------------------------------------
# exact quantizer math (reference codec/quantize.py)
# --------------------------------------------------------------------------


def quantize_uniform_scalar(a: float, nbits: int) -> int:
    """Scalar midtread quantize of |a| >= 0 (no sign bit applied)."""
    if nbits <= 0:
        return 0
    sbm = 1 << (nbits - 1)
    if abs(a) >= 1.0:
        return sbm - 1
    return int(((float((sbm << 1) - 1)) * abs(a) + 1.0) / 2.0)


def quantize_uniform_vec(x: np.ndarray, nbits: int) -> np.ndarray:
    sign = np.signbit(x)
    a = np.abs(np.asarray(x, np.float64))
    sbm = 1 << (nbits - 1)
    largest = float((sbm << 1) - 1)
    q = np.empty(x.shape, dtype=np.uint64)
    in_range = a < 1.0
    q[in_range] = ((a[in_range] * largest + 1.0) / 2.0).astype(np.uint64)
    q[~in_range] = sbm - 1
    q[sign] += np.uint64(sbm)
    return q


def dequantize_uniform_vec(q: np.ndarray, nbits: int) -> np.ndarray:
    q = q.astype(np.int64).copy()
    sbm = 1 << (nbits - 1)
    largest = float((sbm << 1) - 1)
    neg = (q & sbm) == sbm
    q[neg] -= sbm
    out = 2.0 * q / largest
    out[neg] = -out[neg]
    return out


def scale_factor_scalar(a: float, n_scale_bits: int = 4,
                        n_mant_bits: int = 5) -> int:
    """Leading zeros of the quantized magnitude, capped at 2^Rs - 1
    (reference codec/quantize.py:148-177)."""
    if n_mant_bits <= 0:
        return 0
    largest_scale = (1 << n_scale_bits) - 1
    r = n_mant_bits + largest_scale
    q = quantize_uniform_scalar(abs(a), r) << 1
    mask = 1 << (r - 1)
    scale = 0
    while scale < largest_scale and (q & mask) == 0:
        q <<= 1
        scale += 1
    return scale


def bfp_mantissa_vec(x: np.ndarray, scale: int, n_scale_bits: int,
                     n_mant_bits: int) -> np.ndarray:
    largest_scale = (1 << n_scale_bits) - 1
    r = n_mant_bits + largest_scale
    sign = np.signbit(x)
    m = quantize_uniform_vec(np.abs(x), r)
    m = (m << np.uint64(scale + 1)) >> np.uint64(r - n_mant_bits + 1)
    m[sign] += np.uint64(1 << (n_mant_bits - 1))
    return m


def bfp_dequantize_vec(scale: int, mant: np.ndarray, n_scale_bits: int,
                       n_mant_bits: int) -> np.ndarray:
    largest_scale = (1 << n_scale_bits) - 1
    r = n_mant_bits + largest_scale
    sbm = 1 << (n_mant_bits - 1)
    m = mant.astype(np.int64).copy()
    neg = (m & sbm) == sbm
    m[neg] -= sbm
    aq = m << (largest_scale - scale)
    if scale < largest_scale:
        aq[m > 0] += 1 << (largest_scale - scale - 1)
    aq[neg] += 1 << (r - 1)
    return dequantize_uniform_vec(aq, r)


# --------------------------------------------------------------------------
# windows + MDCT (reference codec/window.py, codec/mdct.py)
# --------------------------------------------------------------------------


def sine_window(n: int) -> np.ndarray:
    t = np.arange(n, dtype=np.float64)
    return np.sin((t + 0.5) * np.pi / n)


def hann_window(n: int) -> np.ndarray:
    t = np.arange(n, dtype=np.float64)
    return 0.5 * (1.0 - np.cos(2.0 * (t + 0.5) * np.pi / n))


def mdct_forward(x: np.ndarray) -> np.ndarray:
    """FFT-based forward MDCT, 2/N normalization on the forward transform
    (reference codec/mdct.py:49-70)."""
    n = x.shape[-1]
    half = n // 2
    n0 = (half + 1) / 2.0
    nn = np.arange(n, dtype=np.float64)
    kk = np.arange(half, dtype=np.float64)
    pre = x * np.exp(1j * -2.0 * np.pi * nn / (2.0 * n))
    f = np.fft.fft(pre)
    return (2.0 / n) * np.real(
        f[..., :half] * np.exp(1j * (-2.0 * np.pi / n) * n0 * (kk + 0.5)))


def mdct_inverse(lines: np.ndarray) -> np.ndarray:
    """FFT-based inverse MDCT with the x N factor on the inverse
    (reference codec/mdct.py:72-79)."""
    half = lines.shape[-1]
    n = 2 * half
    n0 = (half + 1) / 2.0
    kk = np.arange(n, dtype=np.float64)
    ext = np.concatenate([lines, -lines[..., ::-1]], axis=-1)
    pre = ext * np.exp(1j * 2.0 * np.pi * kk * n0 / n)
    f = np.fft.ifft(pre)
    return n * np.real(f * np.exp(1j * 2.0 * np.pi / (2.0 * n) * (kk + n0)))


# --------------------------------------------------------------------------
# psychoacoustics (reference codec/psychoac.py)
# --------------------------------------------------------------------------

_I_FLOOR = 10.0 ** ((-30.0 - 96.0) / 10.0)  # Intensity(-30)


def spl_of(intensity):
    i = np.maximum(intensity, _I_FLOOR)
    return np.maximum(96.0 + 10.0 * np.log10(i), -30.0)


def thresh_quiet(f):
    khz = np.clip(f, 10.0, np.inf) / 1000.0
    return (3.64 * khz ** -0.8
            - 6.5 * np.exp(-0.6 * (khz - 3.3) ** 2)
            + 0.001 * khz ** 4)


def bark(f):
    khz = np.asarray(f, np.float64) / 1000.0
    return 13.0 * np.arctan(0.76 * khz) + 3.5 * np.arctan((khz / 7.5) ** 2)


def find_peak_bins(x_fft: np.ndarray) -> np.ndarray:
    """Local maxima of |X| above -30 dB amplitude, interior bins only
    (reference codec/psychoac.py:158-191, with the Q3 p=0 quirk the peak is
    fully described by its bin index)."""
    mag = np.abs(x_fft)
    with np.errstate(divide="ignore"):
        loud = 10.0 * np.log10(mag[1:-1]) > -30.0
    is_peak = (mag[1:-1] > mag[:-2]) & (mag[1:-1] > mag[2:]) & loud
    return np.nonzero(is_peak)[0] + 1


def masked_threshold(x_windowed: np.ndarray, n_mdct_lines: int,
                     sample_rate: int, no_drop: bool = False) -> np.ndarray:
    """Masked threshold at the MDCT line frequencies (SPL, dB).

    x_windowed must already carry the window state the reference mutated
    into it; this function applies one further Hann window, exactly like
    calcBTHR / getMaskedThreshold (reference codec/psychoac.py:215-251,
    409-456).
    """
    n = len(x_windowed)
    x_fft = np.fft.fft(hann_window(n) * x_windowed)[: n // 2]
    freqs = sample_rate / 2.0 / n_mdct_lines * (
        np.arange(n_mdct_lines, dtype=np.float64) + 0.5)
    total = (10.0 ** ((thresh_quiet(freqs) - 96.0) / 10.0)).copy()
    zvec = bark(freqs)
    drop = 0.0 if no_drop else 15.0
    # Q4: Py2 integer division — masker grid step is sampleRate//N Hz
    grid = float(int(sample_rate) // n)
    scale = 8.0 / 3.0 * 4.0 / float(n) ** 2
    for i in find_peak_bins(x_fft):
        lo = i - 3
        power = 0.0 if lo < 0 else float(
            np.sum(np.abs(x_fft[lo:i + 3]) ** 2.0))  # Q5 empty when i < 3
        mspl = float(spl_of(scale * power))
        f = float(i) * grid
        dz = zvec - bark(f)
        leveling = 0.367 * max(mspl - 40.0, 0.0)
        spread = (((dz >= 0) * leveling) - 27.0) * (
            (np.abs(dz) - 0.5) * (np.abs(dz) > 0.5))
        total += 10.0 ** ((mspl + spread - drop - 96.0) / 10.0)
    return spl_of(total)


def calc_smrs(data_windowed: np.ndarray, mdct_lines: np.ndarray,
              mdct_scale: int, sample_rate: int,
              layout) -> np.ndarray:
    """Mono per-band max SMR (reference codec/psychoac.py:253-318)."""
    true_lines = mdct_lines / (2.0 ** mdct_scale)
    mdct_spl = spl_of(4.0 * true_lines ** 2.0)
    thr = masked_threshold(data_windowed, len(mdct_lines), sample_rate)
    smr = np.zeros(layout.n_bands, dtype=np.float64)
    for b in range(layout.n_bands):
        lo, hi = layout.lower_line[b], layout.upper_line[b] + 1
        if lo < hi:
            smr[b] = np.max(mdct_spl[lo:hi] - thr[lo:hi])
    return smr


def mld_factor(f: np.ndarray) -> np.ndarray:
    """Masking-level-difference factor over linear frequency, normalized to
    max 1 (reference codec/psychoac.py:349-372)."""
    out = np.power(10.0, 1.25 * (
        1.0 - np.cos(np.pi * (np.minimum(f, 3000.0) / 3000.0)) - 2.5))
    return out / np.amax(out)


def _band_max_smr(threshold: np.ndarray, mdct_spl: np.ndarray,
                  layout) -> np.ndarray:
    smr = np.empty(layout.n_bands, dtype=np.float64)
    for b in range(layout.n_bands):
        lo, hi = layout.lower_line[b], layout.upper_line[b] + 1
        diff = mdct_spl[lo:hi] - threshold[lo:hi]
        smr[b] = -96.0 if diff.size == 0 else np.amax(diff)
    return smr


def stereo_mask_threshold(sine_windowed: List[np.ndarray],
                          scaled_lines: List[np.ndarray],
                          overall_scale: List[int], sample_rate: int,
                          layout, lrms: np.ndarray
                          ) -> Tuple[np.ndarray, np.ndarray]:
    """Stereo SMRs and channel-mixed MDCT lines
    (reference codec/psychoac.py:506-682), with the Q2 window compounding:
    L/R thresholds see hann*sine data, M/S see hann^2*sine, the no-drop MLD
    variants see hann^3*sine.
    """
    n = len(sine_windowed[0])
    n_lines = len(scaled_lines[0])
    hann = hann_window(n)

    mdct_spl = [
        spl_of(4.0 * scaled_lines[c] ** 2) - 6.02 * overall_scale[c]
        for c in range(2)]

    bthr_l = masked_threshold(sine_windowed[0], n_lines, sample_rate)
    bthr_r = masked_threshold(sine_windowed[1], n_lines, sample_rate)

    # Q2: the reference mutated L/R to hann*sine before building M/S
    hl, hr = hann * sine_windowed[0], hann * sine_windowed[1]
    ms_time = [(hl + hr) / 2.0, (hl - hr) / 2.0]
    ms_lines = [(scaled_lines[0] + scaled_lines[1]) / 2.0,     # Q15
                (scaled_lines[0] - scaled_lines[1]) / 2.0]

    ms_spl = [spl_of(4.0 * ms_lines[0] ** 2) - 6.02 * overall_scale[0],
              spl_of(4.0 * ms_lines[1] ** 2) - 6.02 * overall_scale[1]]

    bthr_m = masked_threshold(ms_time[0], n_lines, sample_rate)
    bthr_s = masked_threshold(ms_time[1], n_lines, sample_rate)
    # Q2 again: the M/S arrays are now hann^2*sine in the reference
    bthr_m_mld = masked_threshold(hann * ms_time[0], n_lines, sample_rate,
                                  no_drop=True)
    bthr_s_mld = masked_threshold(hann * ms_time[1], n_lines, sample_rate,
                                  no_drop=True)

    freqs = ((np.arange(n_lines, dtype=np.float64) + 0.5) / n_lines
             * (sample_rate / 2.0))
    mld = mld_factor(freqs)
    thr_ms = [np.maximum(bthr_m, np.minimum(bthr_s, mld * bthr_s_mld)),
              np.maximum(bthr_s, np.minimum(bthr_m, mld * bthr_m_mld))]
    thr_lr = [bthr_l, bthr_r]

    smr_lr = [_band_max_smr(thr_lr[c], mdct_spl[c], layout) for c in range(2)]
    smr_ms = [_band_max_smr(thr_ms[c], ms_spl[c], layout) for c in range(2)]

    smr = np.zeros((2, layout.n_bands), dtype=np.float64)
    mixed = np.zeros((2, n_lines), dtype=np.float64)
    for c in range(2):
        for b in range(layout.n_bands):
            lo, hi = layout.lower_line[b], layout.upper_line[b] + 1
            if lrms[b]:
                smr[c, b] = smr_ms[c][b]
                mixed[c, lo:hi] = ms_lines[c][lo:hi]
            else:
                smr[c, b] = smr_lr[c][b]
                mixed[c, lo:hi] = scaled_lines[c][lo:hi]
    return smr, mixed


# --------------------------------------------------------------------------
# bit allocation (reference codec/bitalloc.py:129-184)
# --------------------------------------------------------------------------


def bit_alloc(bit_budget: float, extra_bits: int, max_mant_bits: int,
              n_bands: int, n_lines: np.ndarray, smr: np.ndarray,
              lrms: np.ndarray) -> Tuple[np.ndarray, int]:
    bits = np.zeros(n_bands, dtype=np.int64)
    valid = np.ones(n_bands, dtype=bool)
    total = int(bit_budget + extra_bits)
    while valid.any():
        resid = smr - bits * 6.0
        cand = int(np.arange(n_bands)[valid][np.argmax(resid[valid])])
        stop = -5.0 if lrms[cand] else -15.0               # Q11
        if np.max(smr - (bits - 1) * 6.0) < stop:
            valid[cand] = False
        if total - n_lines[cand] >= 0:                     # grant regardless
            bits[cand] += 1
            total -= int(n_lines[cand])
            if bits[cand] >= max_mant_bits:
                valid[cand] = False
        else:
            valid[cand] = False
    total += int(np.sum(n_lines[bits == 1]))               # Q12
    bits[bits == 1] = 0
    return bits, total - extra_bits


# --------------------------------------------------------------------------
# Huffman coding (reference codec/Huffman.py) over the ported dense tables
# --------------------------------------------------------------------------


class HuffmanTables:
    """Ported static tables: dense (length, code) arrays per table id."""

    _cached: Optional["HuffmanTables"] = None

    def __init__(self, npz_path: Optional[str] = None):
        if npz_path is None:
            npz_path = TABLES_NPZ
        z = np.load(npz_path)
        self.lengths = z["lengths"].astype(np.int64)     # [10, 32768]
        self.codes = z["codes"].astype(np.int64)
        self.escape_lengths = z["escape_lengths"].astype(np.int64)
        self.escape_codes = z["escape_codes"].astype(np.int64)
        self.num_tables = self.lengths.shape[0]
        self._decode_trees: dict = {}

    @classmethod
    def load(cls) -> "HuffmanTables":
        if cls._cached is None:
            cls._cached = cls()
        return cls._cached

    @classmethod
    def from_arrays(cls, tables) -> "HuffmanTables":
        """Wrap a (lengths, codes, escape_lengths, escape_codes) tuple —
        e.g. a freshly trained set (a trained table set) — without
        touching the shipped npz."""
        self = cls.__new__(cls)
        self.lengths = np.asarray(tables[0], np.int64)
        self.codes = np.asarray(tables[1], np.int64)
        self.escape_lengths = np.asarray(tables[2], np.int64)
        self.escape_codes = np.asarray(tables[3], np.int64)
        self.num_tables = self.lengths.shape[0]
        self._decode_trees = {}
        return self

    def decode_tree(self, table_id: int) -> np.ndarray:
        """Flattened binary tree int32[n_nodes, 3]: (zero_child, one_child,
        symbol); child < 0 means absent, symbol of -2 means internal,
        -1 is the escape symbol."""
        if table_id in self._decode_trees:
            return self._decode_trees[table_id]
        t = table_id - 1
        nodes = [[-1, -1, -2]]
        entries = [(-1, int(self.escape_codes[t]),
                    int(self.escape_lengths[t]))]
        for sym in np.nonzero(self.lengths[t])[0]:
            entries.append((int(sym), int(self.codes[t, sym]),
                            int(self.lengths[t, sym])))
        for sym, code, length in entries:
            cur = 0
            for bitpos in range(length - 1, -1, -1):
                b = (code >> bitpos) & 1
                nxt = nodes[cur][b]
                if nxt < 0:
                    nodes.append([-1, -1, -2])
                    nxt = len(nodes) - 1
                    nodes[cur][b] = nxt
                cur = nxt
            nodes[cur][2] = sym
        tree = np.asarray(nodes, dtype=np.int32)
        self._decode_trees[table_id] = tree
        return tree

    def encode_best(self, unsigned_mantissas: np.ndarray,
                    line_bits: np.ndarray
                    ) -> Tuple[int, np.ndarray, np.ndarray]:
        """Choose the cheapest of the 10 tables (lowest id wins ties — the
        reference iterates ids ascending with a strict-less update,
        codec/Huffman.py:284-308) and return (table_id, codes, lengths)
        for the transmitted lines.

        unsigned_mantissas: symbols for transmitted lines, in stream order.
        line_bits: the band bit allocation of each transmitted line (escape
        emission appends that many raw bits, Q8).
        """
        syms = unsigned_mantissas.astype(np.int64)
        lens = self.lengths[:, syms]                      # [10, n]
        in_table = lens > 0
        esc = self.escape_lengths[:, None] + line_bits[None, :]
        all_lens = np.where(in_table, lens, esc)
        totals = all_lens.sum(axis=1)
        best = int(np.argmin(totals))                     # first min wins
        tid = best + 1
        codes = np.where(in_table[best], self.codes[best, syms],
                         (self.escape_codes[best] << line_bits) + syms)
        return tid, codes, all_lens[best]


@dataclass
class Reservoir:
    """Bit deposit shared across blocks (reference codec/Huffman.py:353-374).

    `divisor` is the withdrawal trickle (the reference hardcodes 100 =
    1%/block); drivers pass cfg.reservoir_withdraw_divisor so the oracle
    honors the same knob as the engine's reservoir scan."""
    deposit: int = 0
    divisor: int = 100

    def put(self, bits: int) -> None:
        self.deposit += int(bits)

    def take(self) -> int:
        if self.deposit > 10:
            w = self.deposit // self.divisor
            self.deposit -= w
            return w
        if self.deposit < 0:
            w = self.deposit
            self.deposit = 0
            return w
        return 0


# --------------------------------------------------------------------------
# MSB-first bit IO (reference codec/bitpack.py)
# --------------------------------------------------------------------------


class BitWriter:
    def __init__(self):
        self._chunks: List[Tuple[int, int]] = []
        self._total_bits = 0

    def write(self, value: int, nbits: int) -> None:
        if nbits > 0:
            self._chunks.append((int(value) & ((1 << nbits) - 1), nbits))
            self._total_bits += nbits

    @property
    def bit_length(self) -> int:
        return self._total_bits

    def to_bytes(self, nbytes: Optional[int] = None) -> bytes:
        acc = 0
        for value, nbits in self._chunks:
            acc = (acc << nbits) | value
        if nbytes is None:
            nbytes = (self._total_bits + 7) // 8
        pad = nbytes * 8 - self._total_bits
        if pad < 0:
            raise ValueError("bit overflow")
        acc <<= pad
        return acc.to_bytes(nbytes, "big")


class BitReader:
    """MSB-first bit reader (reference codec/bitpack.py ReadBits).  Unlike
    the reference, an overrun raises ValueError instead of a raw IndexError
    so public decode APIs always fail cleanly on corrupt payloads."""

    def __init__(self, data: bytes):
        self._data = data
        self._nbits = 8 * len(data)
        self._pos = 0  # bit position

    def read(self, nbits: int) -> int:
        if nbits <= 0:
            return 0
        pos = self._pos
        if pos + nbits > self._nbits:
            raise ValueError("corrupt payload: bit stream overrun")
        out = 0
        for _ in range(nbits):
            byte = self._data[pos >> 3]
            out = (out << 1) | ((byte >> (7 - (pos & 7))) & 1)
            pos += 1
        self._pos = pos
        return out

    def read_bit(self) -> int:
        pos = self._pos
        if pos >= self._nbits:
            raise ValueError("corrupt payload: bit stream overrun")
        b = (self._data[pos >> 3] >> (7 - (pos & 7))) & 1
        self._pos = pos + 1
        return b


# --------------------------------------------------------------------------
# block encode / decode (reference codec/codec.py)
# --------------------------------------------------------------------------


@dataclass
class EncodedBlock:
    overall_scale: List[int]
    table_id: List[int]
    bit_alloc: List[np.ndarray]
    scale_factor: List[np.ndarray]
    sign_bits: List[np.ndarray]
    huff_codes: List[np.ndarray]
    huff_lengths: List[np.ndarray]
    lrms: np.ndarray


def lrms_decision(full_block: np.ndarray, layout,
                  factor: float = 0.8) -> np.ndarray:
    """Per-band L/R-vs-M/S flags from complex FFT band sums (Q14,
    reference codec/codec.py:94-102)."""
    sl = np.fft.fft(full_block[0])
    sr = np.fft.fft(full_block[1])
    lrms = np.zeros(layout.n_bands, dtype=np.int64)
    for b in range(layout.n_bands):
        lo, hi = layout.lower_line[b], layout.upper_line[b] + 1
        diff = np.abs(np.sum(sl[lo:hi] ** 2 - sr[lo:hi] ** 2))
        tot = np.abs(np.sum(sl[lo:hi] ** 2 + sr[lo:hi] ** 2))
        lrms[b] = int(diff < factor * tot)
    return lrms


def encode_block(full_block: np.ndarray, cfg: CodecConfig,
                 reservoir: Reservoir, extra_bits_state: List[int],
                 tables: HuffmanTables) -> EncodedBlock:
    """Encode one [C, 2N] block exactly like reference codec.Encode +
    EncodeDualChannel (codec/codec.py:83-129, 212-281).  Mono (C = 1) is
    the EncodeSingleChannel pipeline (codec/codec.py:131-210) with the
    same Huffman/reservoir tail: mono psych model, no L/R-vs-M/S
    decision (lrms all zero) — the oracle restatement of the engine's
    mono extension, enabling oracle-vs-engine equality tests where the
    reference ships no mono golden artifacts."""
    layout = cfg.band_layout
    n_lines_arr = np.asarray(layout.n_lines, dtype=np.int64)
    half = cfg.n_mdct_lines
    max_mant = min(1 << cfg.n_mant_size_bits, 16)
    n_ch = cfg.n_channels

    if n_ch == 2:
        lrms = lrms_decision(full_block, layout, cfg.ms_decision_factor)
    else:
        lrms = np.zeros(layout.n_bands, dtype=np.int64)

    budget = cfg.target_bits_per_sample * half
    budget -= cfg.n_scale_bits * (layout.n_bands + 1)
    budget -= cfg.n_mant_size_bits * layout.n_bands
    budget -= cfg.n_table_id_bits
    extra_bits_state[0] += reservoir.take()

    sw = sine_window(2 * half)
    sine_data = [sw * full_block[c] for c in range(n_ch)]
    lines, overall = [], []
    for c in range(n_ch):
        ln = mdct_forward(sine_data[c])[:half]
        osc = scale_factor_scalar(float(np.max(np.abs(ln))),
                                  cfg.n_scale_bits)
        lines.append(ln * (1 << osc))
        overall.append(osc)

    if n_ch == 2:
        smr, mixed = stereo_mask_threshold(sine_data, lines, overall,
                                           cfg.sample_rate, layout, lrms)
    else:
        smr = [calc_smrs(sine_data[0], lines[0], overall[0],
                         cfg.sample_rate, layout)]
        mixed = lines

    out = EncodedBlock([], [], [], [], [], [], [], lrms)
    out.overall_scale = overall
    for c in range(n_ch):
        alloc, diff = bit_alloc(budget, extra_bits_state[0], max_mant,
                                layout.n_bands, n_lines_arr, smr[c], lrms)
        extra_bits_state[0] += diff

        sf = np.zeros(layout.n_bands, dtype=np.int64)
        mant_list = []
        line_bits_list = []
        for b in range(layout.n_bands):
            lo, hi = layout.lower_line[b], layout.upper_line[b] + 1
            # a band of no lines (22.05 kHz: the last two) peaks at 0, as
            # the port's and pactpu's band maxima read it
            peak = float(np.max(np.abs(mixed[c][lo:hi]), initial=0.0))
            sf[b] = scale_factor_scalar(peak, cfg.n_scale_bits,
                                        int(alloc[b]))
            if alloc[b]:
                mant_list.append(bfp_mantissa_vec(
                    mixed[c][lo:hi], int(sf[b]), cfg.n_scale_bits,
                    int(alloc[b])))
                line_bits_list.append(
                    np.full(hi - lo, alloc[b], dtype=np.int64))
        if mant_list:
            mants = np.concatenate(mant_list).astype(np.int64)
            line_bits = np.concatenate(line_bits_list)
        else:
            mants = np.zeros(0, dtype=np.int64)
            line_bits = np.zeros(0, dtype=np.int64)

        signs = mants >> (line_bits - 1)
        unsigned = mants & ((np.int64(1) << (line_bits - 1)) - 1)

        tid, codes, lens = tables.encode_best(unsigned, line_bits)

        raw_bits = int(np.sum(alloc * n_lines_arr))
        used = int(lens.sum()) + len(signs) + cfg.n_table_id_bits
        reservoir.put(raw_bits - used)

        out.table_id.append(tid)
        out.bit_alloc.append(alloc)
        out.scale_factor.append(sf)
        out.sign_bits.append(signs)
        out.huff_codes.append(codes)
        out.huff_lengths.append(lens)
    return out


def decode_block(bit_alloc_2: np.ndarray, scale_factor_2: np.ndarray,
                 mantissa_2: np.ndarray, overall_2: np.ndarray,
                 lrms: np.ndarray, cfg: CodecConfig) -> np.ndarray:
    """Decode one block to [C, 2N] pre-overlap time samples with the Q1
    M/S aliasing behavior (reference codec/codec.py:25-65); mono skips
    the M/S reconstruction."""
    layout = cfg.band_layout
    half = cfg.n_mdct_lines
    n_ch = cfg.n_channels
    lines = np.zeros((n_ch, half), dtype=np.float64)
    for c in range(n_ch):
        for b in range(layout.n_bands):
            ba = int(bit_alloc_2[c][b])
            if ba:
                lo, hi = layout.lower_line[b], layout.upper_line[b] + 1
                lines[c, lo:hi] = bfp_dequantize_vec(
                    int(scale_factor_2[c][b]), mantissa_2[c][lo:hi],
                    cfg.n_scale_bits, ba)
        lines[c] /= 1.0 * (1 << int(overall_2[c]))

    # Q1: sequential in-place M/S reconstruction aliasing
    if n_ch == 2:
        for b in range(layout.n_bands):
            if lrms[b]:
                lo, hi = layout.lower_line[b], layout.upper_line[b] + 1
                m_minus_s = lines[0, lo:hi] - lines[1, lo:hi]
                lines[0, lo:hi] = m_minus_s
                lines[1, lo:hi] = m_minus_s + lines[1, lo:hi]

    sw = sine_window(2 * half)
    return np.stack([sw * mdct_inverse(lines[c]) for c in range(n_ch)])


# --------------------------------------------------------------------------
# .wak / .pac container (reference codec/pacfile.py)
# --------------------------------------------------------------------------

PAC_TAG = b"PAC "


def write_header(cfg: CodecConfig, num_samples: int) -> Tuple[bytes, int]:
    """Returns (header bytes, numSamples as written — Q6 padding quirk)."""
    layout = cfg.band_layout
    if num_samples % cfg.n_mdct_lines == 0:
        num_samples += cfg.n_mdct_lines
    head = PAC_TAG + struct.pack(
        "<LHLLHH", cfg.sample_rate, cfg.n_channels, num_samples,
        cfg.n_mdct_lines, cfg.n_scale_bits, cfg.n_mant_size_bits)
    head += struct.pack("<L", layout.n_bands)
    head += struct.pack("<%dH" % layout.n_bands, *layout.n_lines)
    return head, num_samples


def read_header(data: bytes) -> Tuple[CodecConfig, int, int]:
    """Returns (config, numSamples, header_size)."""
    if data[:4] != PAC_TAG:
        raise ValueError("not a PAC/WAK stream")
    try:
        (fs, n_ch, num_samples, n_mdct, n_scale_bits,
         n_mant_size_bits) = struct.unpack_from("<LHLLHH", data, 4)
        off = 4 + struct.calcsize("<LHLLHH")
        (n_bands,) = struct.unpack_from("<L", data, off)
        off += 4
        n_lines = struct.unpack_from("<%dH" % n_bands, data, off)
        off += 2 * n_bands
    except struct.error as e:           # truncated header
        raise ValueError(f"truncated PAC/WAK header: {e}") from e
    if n_ch not in (1, 2):
        raise ValueError(f"only mono/stereo supported, got {n_ch} channels")
    # The stream is self-describing: the decoder constructs the band layout
    # from the header's nLines[] (reference codec/pacfile.py:123-151 builds
    # ScaleFactorBands from the header), accepting ANY layout it declares —
    # so an encode with custom band_limits round-trips.  Garbage headers
    # still fail cleanly on the structural invariants below.
    if n_bands < 1 or n_bands > n_mdct:
        raise ValueError(f"corrupt header: {n_bands} bands for "
                         f"{n_mdct} MDCT lines")
    if sum(n_lines) != n_mdct:
        raise ValueError(
            f"corrupt header: band line counts sum to {sum(n_lines)}, "
            f"expected nMDCTLines = {n_mdct}")
    expect = assign_mdct_lines(n_mdct, fs)
    override = None if tuple(n_lines) == expect else tuple(
        int(x) for x in n_lines)
    cfg = CodecConfig(sample_rate=fs, n_channels=n_ch, n_mdct_lines=n_mdct,
                      n_scale_bits=n_scale_bits,
                      n_mant_size_bits=n_mant_size_bits,
                      band_line_counts=override)
    return cfg, num_samples, off


def pack_block(block: EncodedBlock, cfg: CodecConfig) -> bytes:
    """Serialize one encoded block: per channel nBytes + payload
    (reference codec/pacfile.py:273-353, quirks Q7/Q8/Q9)."""
    layout = cfg.band_layout
    out = bytearray()
    for c in range(cfg.n_channels):
        w = BitWriter()
        w.write(block.overall_scale[c], cfg.n_scale_bits)
        w.write(block.table_id[c], cfg.n_table_id_bits)
        i_mant = 0
        for b in range(layout.n_bands):
            ba = int(block.bit_alloc[c][b])
            w.write(ba - 1 if ba else 0, cfg.n_mant_size_bits)
            w.write(int(block.scale_factor[c][b]), cfg.n_scale_bits)
            if ba:
                n = layout.n_lines[b]
                for j in range(n):
                    w.write(int(block.sign_bits[c][i_mant + j]), 1)
                for j in range(n):
                    w.write(int(block.huff_codes[c][i_mant + j]),
                            int(block.huff_lengths[c][i_mant + j]))
                i_mant += n
        for b in range(layout.n_bands):
            w.write(int(block.lrms[b]), 1)
        n_bytes = (w.bit_length + 7) // 8
        out += struct.pack("<L", n_bytes)
        out += w.to_bytes(n_bytes)
    return bytes(out)


def unpack_block(data: bytes, off: int, cfg: CodecConfig,
                 tables: HuffmanTables
                 ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray,
                            np.ndarray, int]:
    """Parse one block; returns (bitAlloc[C,bands], scaleFactor[C,bands],
    mantissa[C,half], overallScale[C], lrms[bands], new_offset)."""
    layout = cfg.band_layout
    half = cfg.n_mdct_lines
    n_ch = cfg.n_channels
    ba2 = np.zeros((n_ch, layout.n_bands), dtype=np.int64)
    sf2 = np.zeros((n_ch, layout.n_bands), dtype=np.int64)
    mant2 = np.zeros((n_ch, half), dtype=np.int64)
    osc2 = np.zeros(n_ch, dtype=np.int64)
    lrms = np.zeros(layout.n_bands, dtype=np.int64)
    for c in range(n_ch):
        try:
            (n_bytes,) = struct.unpack_from("<L", data, off)
        except struct.error as e:       # truncated block length prefix
            raise ValueError(f"truncated channel-block header: {e}") from e
        off += 4
        if off + n_bytes > len(data):
            raise ValueError("corrupt payload: channel-block length "
                             "exceeds the stream")
        r = BitReader(data[off:off + n_bytes])
        off += n_bytes
        osc2[c] = r.read(cfg.n_scale_bits)
        tid = r.read(cfg.n_table_id_bits)
        if not 1 <= tid <= tables.num_tables:
            raise ValueError(f"corrupt payload: Huffman table id {tid} "
                             f"out of range 1..{tables.num_tables}")
        tree = tables.decode_tree(tid)
        for b in range(layout.n_bands):
            ba = r.read(cfg.n_mant_size_bits)
            if ba:
                ba += 1
            ba2[c, b] = ba
            sf2[c, b] = r.read(cfg.n_scale_bits)
            if ba:
                n = layout.n_lines[b]
                signs = [r.read_bit() for _ in range(n)]
                lo = layout.lower_line[b]
                for j in range(n):
                    node = 0
                    while tree[node, 2] == -2:
                        node = tree[node, r.read_bit()]
                        if node < 0:    # dead branch: no such code
                            raise ValueError(
                                "corrupt payload: invalid Huffman code")
                    sym = int(tree[node, 2])
                    if sym == -1:  # escape: raw ba-bit mantissa follows
                        sym = r.read(ba)
                    mant2[c, lo + j] = sym + signs[j] * (1 << (ba - 1))
        for b in range(layout.n_bands):
            lrms[b] = r.read_bit()  # Q9: once per channel, same array
    return ba2, sf2, mant2, osc2, lrms, off


# --------------------------------------------------------------------------
# file-level drivers (reference codec/pacfile.py __main__)
# --------------------------------------------------------------------------


def encode_file(pcm: np.ndarray, sample_rate: int,
                cfg: Optional[CodecConfig] = None) -> bytes:
    """pcm: int16 [n, C].  Returns the full .wak byte stream."""
    if cfg is None:
        cfg = CodecConfig(sample_rate=sample_rate)
    if pcm.ndim != 2 or pcm.shape[1] != cfg.n_channels:
        raise ValueError(f"pcm must be [n, {cfg.n_channels}] int16, "
                         f"got {pcm.shape}")
    tables = HuffmanTables.load()
    half = cfg.n_mdct_lines
    n_ch = cfg.n_channels
    n = pcm.shape[0]
    header, _ = write_header(cfg, n)
    out = bytearray(header)

    reservoir = Reservoir(divisor=cfg.reservoir_withdraw_divisor)
    extra = [0]
    prior = np.zeros((n_ch, half), dtype=np.float64)
    n_blocks = -(-n // half)
    x = pcm16_to_float_np(pcm.T.astype(np.int64))  # [C, n]
    for i in range(n_blocks + 1):  # final zero block flushes the MDCT delay
        if i < n_blocks:
            cur = np.zeros((n_ch, half), dtype=np.float64)
            seg = x[:, i * half:(i + 1) * half]
            cur[:, :seg.shape[1]] = seg
        else:
            cur = np.zeros((n_ch, half), dtype=np.float64)
        full = np.concatenate([prior, cur], axis=1)
        prior = cur
        blk = encode_block(full, cfg, reservoir, extra, tables)
        out += pack_block(blk, cfg)
    return bytes(out)


def decode_file(data: bytes) -> Tuple[int, np.ndarray]:
    """Returns (sample_rate, int16 [n, 2]) decoded like the reference
    driver (first block skipped, final OLA half flushed), trimmed to the
    header's numSamples — the length the reference's decoded WAV declares
    (reference codec/pacfile.py:231-271, pcmfile.py:103-115; the block loop
    emits whole blocks but the output header claims numSamples)."""
    cfg, num_samples, off = read_header(data)
    tables = HuffmanTables.load()
    half = cfg.n_mdct_lines
    ola = np.zeros((cfg.n_channels, half), dtype=np.float64)
    chunks = []
    first = True
    while off < len(data):
        ba2, sf2, mant2, osc2, lrms, off = unpack_block(
            data, off, cfg, tables)
        td = decode_block(ba2, sf2, mant2, osc2, lrms, cfg)
        block_out = ola + td[:, :half]
        ola = td[:, half:]
        if first:
            first = False
            continue
        chunks.append(block_out)
    chunks.append(ola)  # final overlap-and-add flush
    audio = np.concatenate(chunks, axis=1)[:, :num_samples]  # [2, n]
    return cfg.sample_rate, float_to_pcm16_np(audio).T.copy()
