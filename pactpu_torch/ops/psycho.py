"""Batched psychoacoustic model on tensors (pactpu.ops.psycho), main path.

The reference masking model (reference codec/psychoac.py) walks a peak list
per block and spreads each masker over the lines in a Python loop.  Here
every FFT bin is a potential masker gated by a peak mask, and the masking
sum of a batch of blocks is the dense form of the JAX reference's TPU path
(psycho.py:249-272): the masker-level-independent part of the spreading
function (plateau plus the fixed -27 dB/bark downslope) is one float32
matrix product against the static `nonup` table, and the tonal-level-
dependent upslope is kernel K4 (pactpu_torch.ops.kernels.spread_maskers_up).
Six masked-threshold variants per stereo block (L, R, M, S and the two
no-drop MLD variants, psychoac.py:506-682) run as one batch; a mono block
(calc_smrs: the mono and .pac coders) takes one.

The alternative peak pickers (peak_mode "para" and "weighted", reference
baselines/aidan/psychoac.py:105-189) place maskers between bins, so their
barks are data; they take the compact form of the masking sum
(pactpu.ops.psycho.masked_threshold, psycho.py:274-309): the peaks are
compacted exactly into K top-k slots and the full spreading function of
every slot is summed by kernel K6 (pactpu_torch.ops.kernels.spread_maskers).

Reference quirks reproduced as in pactpu: the Q3/Q4 integer frequency grid
of the masker bins, the Q5 empty SPL window for bins < 3, and the Q2 window
compounding (inputs carry the window state the reference mutated into
them).
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from pactpu_torch.ops import kernels
from pactpu_torch.ops import quantize as q
from pactpu_torch.ops.windows import hann_window

# SPL floor constants (reference codec/psychoac.py:15-42)
_I_FLOOR = 10.0 ** ((-30.0 - 96.0) / 10.0)
_DB_PER_LN = 10.0 / np.log(10.0)
_LOG2_10_OVER_10 = float(np.log2(10.0) / 10.0)


def spl(intensity: torch.Tensor) -> torch.Tensor:
    """SPL in dB from intensity, 96 dB reference, -30 dB floor
    (reference codec/psychoac.py:15-33)."""
    i = torch.clamp(intensity, min=_I_FLOOR)
    return torch.clamp(96.0 + _DB_PER_LN * torch.log(i), min=-30.0)


def _bark_np(f: np.ndarray) -> np.ndarray:
    khz = np.asarray(f, np.float64) / 1000.0
    return 13.0 * np.arctan(0.76 * khz) + 3.5 * np.arctan((khz / 7.5) ** 2)


def _thresh_quiet_np(f: np.ndarray) -> np.ndarray:
    khz = np.maximum(f, 10.0) / 1000.0
    return (3.64 * khz ** -0.8
            - 6.5 * np.exp(-0.6 * (khz - 3.3) ** 2)
            + 0.001 * khz ** 4)


def _mld_np(f: np.ndarray) -> np.ndarray:
    """MLD factor over linear frequency, normalized to max 1
    (reference codec/psychoac.py:349-372)."""
    out = np.power(10.0, 1.25 * (
        1.0 - np.cos(np.pi * (np.minimum(f, 3000.0) / 3000.0)) - 2.5))
    return out / np.amax(out)


@lru_cache(maxsize=8)
def _consts(n: int, fs: int, dtype_name: str = "float32"):
    """Static per-line/per-bin tables for window size n (n//2 lines/bins),
    in float32 or float64, array for array
    pactpu.ops.psycho._consts(n, fs, dtype_name):
    (quiet_i, zvec, bin_bark, mld, nonup) — threshold-in-quiet intensity
    and bark of the MDCT lines, bark of the FFT masker bins on the
    reference's integer frequency grid (Q4), the MLD weighting, and the
    [bins, lines] masker-level-independent spreading table `nonup`
    (plateau |dz| <= 0.5 -> 1, downslope 10^(2.7 dz + 1.35) for dz < -0.5,
    psychoac.py:103-120)."""
    half = n // 2
    line_freqs = (np.arange(half, dtype=np.float64) + 0.5) / half * (fs / 2.0)
    zvec = _bark_np(line_freqs)
    quiet_i = 10.0 ** ((_thresh_quiet_np(line_freqs) - 96.0) / 10.0)
    grid = float(int(fs) // n)                     # Q4 integer grid
    bin_bark = _bark_np(np.arange(half, dtype=np.float64) * grid)
    mld = _mld_np(line_freqs)
    dz = zvec[None, :] - bin_bark[:, None]         # [bins, lines]
    nonup = np.where(np.abs(dz) <= 0.5, 1.0,
                     np.where(dz < -0.5, 10.0 ** (2.7 * dz + 1.35), 0.0))
    return tuple(np.asarray(a, np.dtype(dtype_name))
                 for a in (quiet_i, zvec, bin_bark, mld, nonup))


def masker_levels(x: torch.Tensor, hann: torch.Tensor):
    """Per-bin masker SPLs and the peak mask for a batch of blocks.

    x: f32[..., N] (or f64) time blocks carrying their window state (one
    further Hann window is applied here, as in reference calcBTHR
    psychoac.py:428); hann: [N] in x's dtype.  Returns (mspl [..., N/2] in
    x's dtype, peak bool[..., N/2])."""
    n = x.shape[-1]
    half = n // 2
    spec = torch.fft.rfft(x * hann)[..., :half]
    p2 = spec.real ** 2 + spec.imag ** 2

    # interior local maxima of |X| with 10*log10(|X|) > -30
    # (psychoac.py:158-191)
    mid = p2[..., 1:-1]
    inner = (mid > p2[..., :-2]) & (mid > p2[..., 2:]) & (mid > 1e-6)
    peak = torch.nn.functional.pad(inner, (1, 1))

    # masker SPL over the 6-bin window [i-3, i+3); empty (=0) when i < 3
    # (Q5).  The window sums are differences of a running sum, taken in
    # float64: in float32 they cancel badly above a loud low bin.
    cs = torch.cumsum(p2.double(), dim=-1)
    idx = torch.arange(half, device=x.device)
    hi = cs[..., torch.clamp(idx + 2, max=half - 1)]
    lo = torch.where(idx >= 4, cs[..., torch.clamp(idx - 4, min=0)], 0.0)
    win = torch.where(idx >= 3, hi - lo, 0.0).to(x.dtype)
    scale8 = (8.0 / 3.0) * 4.0 / float(n) ** 2
    return spl(scale8 * win), peak


def masker_intensity(mspl: torch.Tensor, peak: torch.Tensor,
                     drop_db: torch.Tensor) -> torch.Tensor:
    """Peak-masked masker intensities 10^((SPL - drop - 96)/10), zero for
    non-peaks: the `iprime` input of kernel K4."""
    return torch.where(
        peak, torch.exp2(_LOG2_10_OVER_10 * (mspl - drop_db[:, None] - 96.0)),
        0.0)


def threshold_from_maskers(mspl: torch.Tensor, peak: torch.Tensor,
                           drop_db: torch.Tensor, psy: dict) -> torch.Tensor:
    """Masked threshold (SPL dB at the MDCT lines) from masker levels:
    intensity addition of every peak masker, spread by the plateau and
    downslope (`nonup` product) and the upslope (kernel K4), plus the
    threshold in quiet (psychoac.py:215-251).

    mspl/peak: [B, bins]; drop_db: f32[B] tonal-masker drop (15, or 0 for
    the no-drop MLD variants); psy: the engine's psychoacoustic tables."""
    iprime = masker_intensity(mspl, peak, drop_db)
    total = torch.matmul(iprime, psy["nonup"])
    total = total + kernels.spread_maskers_up(iprime, mspl, psy["bin_bark"],
                                              psy["zvec"])
    return spl(psy["quiet_i"][None] + total)


def masked_threshold(x: torch.Tensor, drop_db: torch.Tensor,
                     psy: dict) -> torch.Tensor:
    """Masked thresholds for a batch of windowed time blocks x f32[B, N]
    (pactpu.ops.psycho.masked_threshold, dense path)."""
    mspl, peak = masker_levels(x, psy["hann"])
    return threshold_from_maskers(mspl, peak, drop_db, psy)


def _bark(f: torch.Tensor) -> torch.Tensor:
    khz = f / 1000.0
    return 13.0 * torch.atan(0.76 * khz) + 3.5 * torch.atan((khz / 7.5) ** 2)


def aidan_peaks(x: torch.Tensor, fs: int, mode: str, hann: torch.Tensor):
    """The alternative peak pickers as fixed-shape masker slots
    (pactpu.ops.psycho.aidan_peaks; reference baselines/aidan/psychoac.py:
    105-189 FindPeaksPara/FindPeaks, spectrum and keep-set semantics from
    getMaskedThreshold :236-262).

    x: f32[B, N] time blocks (one Hann window `hann` f32[N] is applied
    here).  The dB spectrum is the full N-point FFT normalized by the Hann
    window power; peaks are strict interior local maxima of the floored dB
    values, and only the first half of the peak list survives (the
    reference's `allPeaks[0:len(allPeaks)/2]` floor quirk standing in for
    positive-frequency selection).  An empty list yields the reference's
    dummy masker at f = 0, SPL = 0 in slot 0.

    mode "para": parabolic interpolation on dB values, p = (a - c) /
    (2 (a - 2b + c)), height = b - (a - c) p / 4.  mode "weighted":
    intensity-weighted bin centroid, height = SPL(Ia + Ib + Ic).

    Returns (height f32[B, N], bark f32[B, N], keep bool[B, N]): masker
    SPL, bark of the interpolated masker frequency and the slot mask."""
    n = x.shape[-1]
    hann64 = np.asarray(hann_window(n), np.float64)
    w2hann = float(np.mean(hann64 * hann64))
    spec = torch.fft.fft(x * hann)
    p2 = spec.real ** 2 + spec.imag ** 2
    xspl = spl((4.0 / (float(n) ** 2 * w2hann)) * p2)     # dB, floored

    mid = xspl[..., 1:-1]
    mask = torch.nn.functional.pad(
        (mid > xspl[..., :-2]) & (mid > xspl[..., 2:]), (1, 1))
    cnt = torch.cumsum(mask.to(torch.int32), dim=-1)
    total = cnt[..., -1:]
    keep = mask & (cnt <= total // 2)                     # first-half quirk

    idx = torch.arange(n, dtype=x.dtype, device=x.device)
    a = torch.roll(xspl, 1, dims=-1)
    b = xspl
    c = torch.roll(xspl, -1, dims=-1)
    if mode == "para":
        denom = a - 2.0 * b + c                           # < 0 at a strict max
        p = 0.5 * (a - c) / torch.where(denom != 0.0, denom, 1.0)
        loc = idx + p
        height = b - 0.25 * (a - c) * p
    elif mode == "weighted":
        ia, ib, ic = (torch.exp2(_LOG2_10_OVER_10 * (v - 96.0))
                      for v in (a, b, c))
        loc = (ia * (idx - 1.0) + ib * idx + ic * (idx + 1.0)) / (ia + ib + ic)
        height = spl(ia + ib + ic)
    else:
        raise ValueError(f"unknown aidan peak mode {mode!r}")

    # the empty-list dummy masker sits in slot 0 with height and bark 0
    dummy = (total == 0) & (torch.arange(n, device=x.device) == 0)
    # non-kept slots are zeroed: their a/b/c come from wrapped neighbours
    # and can overflow the (masked-out) spreading exponential into inf
    height = torch.where(keep, height, 0.0)
    loc = torch.where(keep, loc, 0.0)
    return height, _bark(loc * (float(fs) / float(n))), keep | dummy


def compact_slots(mspl: torch.Tensor, peak: torch.Tensor, bark,
                  psy: dict, up_coef: float):
    """Exact top-k compaction of the peak slots into K masker slots, the
    inputs of kernel K6 (pactpu.ops.psycho.masked_threshold,
    psycho.py:227-235, 274-283).

    mspl f32[B, M] slot SPLs, peak bool[B, M] slot mask, bark f32[B, M]
    per-slot barks (the aidan pickers, K = M // 4 + 1: strict maxima are
    not adjacent and the first-half quirk halves them again, +1 for the
    dummy) or None for the reference peaks on the static bin grid
    (M = N / 2 bins, K = M // 2).  Returns (mspl_k, lev_k, bark_k, valid),
    each f32[B, K]: lev_k = up_coef max(mspl_k - 40, 0), valid 0/1."""
    m = mspl.shape[-1]
    k = m // 4 + 1 if bark is not None else m // 2
    key = torch.where(peak, torch.arange(m, device=mspl.device), -1)
    idx = torch.topk(key, k, dim=-1).values
    safe = torch.clamp(idx, min=0)
    mspl_k = torch.gather(mspl, -1, safe)
    lev_k = up_coef * torch.clamp(mspl_k - 40.0, min=0.0)
    bark_k = (psy["bin_bark"][safe] if bark is None
              else torch.gather(bark, -1, safe))
    return mspl_k, lev_k, bark_k.contiguous(), (idx >= 0).to(mspl.dtype)


def compact_threshold(mspl: torch.Tensor, peak: torch.Tensor, bark,
                      drop_db: torch.Tensor, psy: dict,
                      up_coef: float) -> torch.Tensor:
    """Masked threshold from masker slots through the compact form
    (pactpu.ops.psycho.masked_threshold, psycho.py:274-309): compact_slots,
    then kernel K6 sums the spreading function of the K slots over the
    lines, plus the threshold in quiet."""
    total = kernels.spread_maskers(
        *compact_slots(mspl, peak, bark, psy, up_coef),
        drop_db.contiguous(), psy["zvec"])
    return spl(psy["quiet_i"][None] + total)


def threshold_for_mode(x: torch.Tensor, drop_db: torch.Tensor, psy: dict,
                       fs: int, peak_mode: str) -> torch.Tensor:
    """Masked thresholds of windowed blocks x f32[B, N] by peak-picker mode
    (pactpu.ops.psycho._threshold_for_mode): "ref" = the master model's
    peaks on the dense path (`nonup` product + K4, upslope 0.367);
    "para"/"weighted" = the aidan pickers on the compact path (K6) with
    aidan's 0.37 upslope coefficient (baselines/aidan/psychoac.py:97)."""
    if peak_mode == "ref":
        return masked_threshold(x, drop_db, psy)
    height, bark, keep = aidan_peaks(x, fs, peak_mode, psy["hann"])
    return compact_threshold(height, keep, bark, drop_db, psy, up_coef=0.37)


def layout_tensors(layout, device) -> dict:
    """Device tables of a BandLayout for the band reductions: `seg` (band
    of each line), `band_lines` [bands, widest] (each band's lines, padded
    by repeating its last line), `band_pad` (which of those are padding),
    `band_empty`, `n_lines` (int32) and `line_in_band` (int32, the index
    of each line within its band)."""
    n = np.asarray(layout.n_lines, np.int64)
    total = int(n.sum())
    lo = np.asarray(layout.lower_line, np.int64)
    j = np.arange(max(int(n.max()), 1))[None, :]
    lines = np.minimum(lo[:, None] + np.minimum(j, np.maximum(
        n[:, None] - 1, 0)), total - 1)
    seg = np.asarray(layout.line_to_band, np.int64)
    t = lambda a, dt: torch.as_tensor(a, dtype=dt, device=device)  # noqa: E731
    return dict(seg=t(seg, torch.long),
                band_lines=t(lines, torch.long),
                band_pad=t(j >= n[:, None], torch.bool),
                band_empty=t(n == 0, torch.bool),
                n_lines=t(n, torch.int32),
                line_in_band=t(np.arange(total) - lo[seg], torch.int32))


def band_max(values: torch.Tensor, lay: dict, fill: float = -96.0):
    """Per-scale-factor-band max over MDCT lines: [..., lines] -> [...,
    bands].  Only empty bands yield `fill`; a non-empty band carries its
    true max even below `fill` (psychoac.py:253-318, 458-504).  `lay` holds
    the band layout's gather table (each band's lines, padded by repeating
    its last line, which leaves the max unchanged)."""
    out = values[..., lay["band_lines"]].amax(-1)
    return torch.where(lay["band_empty"], fill, out)


def band_sum(values: torch.Tensor, lay: dict) -> torch.Tensor:
    """Per-band sum over MDCT lines: [..., lines] -> [..., bands]."""
    v = values[..., lay["band_lines"]]
    return torch.where(lay["band_pad"], 0.0, v).sum(-1)


def mdct_spl(scaled_lines: torch.Tensor,
             overall_scale: torch.Tensor) -> torch.Tensor:
    """SPL of MDCT lines that were scaled by 2^overallScale:
    SPL(4 X^2) - 6.02 * scale (reference codec/psychoac.py:534-536)."""
    return (spl(4.0 * scaled_lines * scaled_lines)
            - 6.02 * overall_scale[..., None].to(scaled_lines.dtype))


def calc_smrs(sine_windowed: torch.Tensor, scaled_lines: torch.Tensor,
              overall_scale: torch.Tensor, psy: dict, lay: dict,
              fs: int = 44100, peak_mode: str = "ref") -> torch.Tensor:
    """Mono per-band max SMR (reference CalcSMRs, psychoac.py:253-318;
    pactpu.ops.psycho.calc_smrs): the masked threshold at the tonal drop
    of 15 dB, against the SPL of the lines with 2^scale divided out
    *before* the SPL floor clamps (the stereo path clamps first and
    subtracts 6.02 * scale after).

    sine_windowed: f32[R, N]; scaled_lines: f32[R, N/2];
    overall_scale: i32[R].  Returns f32[R, bands]."""
    drop = torch.full((sine_windowed.shape[0],), 15.0,
                      dtype=sine_windowed.dtype, device=sine_windowed.device)
    thr = threshold_for_mode(sine_windowed, drop, psy, fs, peak_mode)
    true_lines = scaled_lines * q.exp2i(-overall_scale,
                                        scaled_lines.dtype)[..., None]
    return band_max(spl(4.0 * true_lines * true_lines) - thr, lay, fill=0.0)


def six_variants(sine_windowed: torch.Tensor, hann: torch.Tensor):
    """The six masked-threshold inputs of a stereo block, L, R, M, S and
    the no-drop MLD variants of M and S, as one batch: sine_windowed
    f32[B, 2, N] -> (blocks f32[6B, N], drop_db f32[6B]).  The M/S blocks
    are built from hann*sine data and the MLD variants from hann^2*sine
    data (Q2 window compounding)."""
    b, _, n = sine_windowed.shape
    hl = hann * sine_windowed[:, 0]
    hr = hann * sine_windowed[:, 1]
    ms_m = (hl + hr) * 0.5
    ms_s = (hl - hr) * 0.5
    stack = torch.stack([sine_windowed[:, 0], sine_windowed[:, 1], ms_m,
                         ms_s, hann * ms_m, hann * ms_s], dim=1)
    drops = torch.tensor([15.0, 15.0, 15.0, 15.0, 0.0, 0.0],
                         dtype=stack.dtype, device=stack.device).repeat(b)
    return stack.reshape(b * 6, n), drops


def stereo_smr_pair(sine_windowed: torch.Tensor, scaled_lines: torch.Tensor,
                    overall_scale: torch.Tensor, psy: dict, lay: dict,
                    fs: int = 44100, peak_mode: str = "ref"):
    """Per-band SMRs of BOTH stereo codings for a batch of blocks
    (reference getStereoMaskThreshold, codec/psychoac.py:506-682, up to the
    per-band L/R-vs-M/S selection).

    sine_windowed: f32[B, 2, N]; scaled_lines: f32[B, 2, N/2];
    overall_scale: i32[B, 2].  Returns (smr_lr f32[B, 2, bands],
    smr_ms f32[B, 2, bands], ms_lines f32[B, 2, N/2]).

    Quirk parity: the M/S time blocks are built from hann*sine data and the
    no-drop MLD variants from hann^2*sine data (Q2); M/S MDCT lines average
    the per-channel scaled lines (Q15); the M SPL uses channel 0's overall
    scale and S uses channel 1's."""
    b, _, n = sine_windowed.shape
    blocks, drops = six_variants(sine_windowed, psy["hann"])
    thr = threshold_for_mode(blocks, drops, psy, fs, peak_mode).reshape(
        b, 6, n // 2)
    bthr_l, bthr_r, bthr_m, bthr_s, bthr_m_mld, bthr_s_mld = thr.unbind(1)

    ms_lines = torch.stack([(scaled_lines[:, 0] + scaled_lines[:, 1]) * 0.5,
                            (scaled_lines[:, 0] - scaled_lines[:, 1]) * 0.5],
                           dim=1)
    lr_spl = mdct_spl(scaled_lines, overall_scale)
    ms_spl = mdct_spl(ms_lines, overall_scale)

    mld = psy["mld"]
    thr_ms = torch.stack(
        [torch.maximum(bthr_m, torch.minimum(bthr_s, mld * bthr_s_mld)),
         torch.maximum(bthr_s, torch.minimum(bthr_m, mld * bthr_m_mld))],
        dim=1)
    thr_lr = torch.stack([bthr_l, bthr_r], dim=1)
    return (band_max(lr_spl - thr_lr, lay), band_max(ms_spl - thr_ms, lay),
            ms_lines)


def select_coding(smr_lr, smr_ms, scaled_lines, ms_lines, lrms, lay):
    """Per-band SMR + MDCT-line selection by the LRMS flags (reference
    codec/psychoac.py:660-682)."""
    smr = torch.where(lrms[:, None, :], smr_ms, smr_lr)
    line_lrms = lrms[:, None, lay["seg"]]
    return smr, torch.where(line_lrms, ms_lines, scaled_lines)


def lrms_decision(full_blocks: torch.Tensor, lay: dict,
                  factor: float = 0.8) -> torch.Tensor:
    """Per-band L/R-vs-M/S decision from complex FFT band sums:
    |sum(L^2 - R^2)| < factor * |sum(L^2 + R^2)| over complex squares of the
    unwindowed block (Q14, reference codec/codec.py:94-102).

    full_blocks: f32[B, 2, N].  Returns bool[B, bands]."""
    half = full_blocks.shape[-1] // 2
    spec = torch.fft.rfft(full_blocks)[..., :half]
    sq = spec * spec                                 # complex squares
    re = band_sum(sq.real, lay)
    im = band_sum(sq.imag, lay)
    diff = torch.hypot(re[:, 0] - re[:, 1], im[:, 0] - im[:, 1])
    tot = torch.hypot(re[:, 0] + re[:, 1], im[:, 0] + im[:, 1])
    return diff < factor * tot
