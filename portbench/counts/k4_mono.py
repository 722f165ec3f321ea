"""K4's work on mono blocks at any sample rate, as counts/k4.py counts it
for stereo at 44.1 kHz: 6 operations for each (row, peak masker, line on
the masker's upslope) triple, a row being the one masked threshold of a
mono block (reference CalcSMRs, codec/psychoac.py:253-318: the block's
sine-windowed samples under one more Hann window), the peak maskers those
of the frozen reference's peak picker (k4.peaks) on that spectrum, a
masker at bin k sitting at k * (fs // 2048) Hz (the reference's integer
grid, Q4) and reaching the lines more than 0.5 Bark above it on the
rate's own Bark grid.  Bytes: each row's masker levels and SPLs read
once and its 1,024 output lines written once, float32."""

from __future__ import annotations

import numpy as np

import k4
from k4 import HALF, PEAK_BYTES, PEAK_OPS, R


def reach(fs: int) -> np.ndarray:
    """Lines on the upslope of a masker at each bin (dz > 0.5 Bark) at
    sample rate fs."""
    zvec = R.bark((np.arange(HALF) + 0.5) * (fs / 2.0) / HALF)
    grid = float(fs // (2 * HALF))
    zb = R.bark(np.arange(HALF) * grid)
    return HALF - np.searchsorted(zvec, zb + 0.5, side="right")


def triples(pcm: np.ndarray, fs: int, batch: int = 1024) -> tuple:
    """(triples, rows) of a mono track's analysis (int16 [n, 1])."""
    fr = k4.frames(pcm)[0]
    n = 2 * HALF
    sw = R.sine_window(n)
    hann = R.hann_window(n)
    r = reach(fs)
    total = rows = 0
    for lo in range(0, fr.shape[0], batch):
        sig = hann * (fr[lo:lo + batch] * sw)
        p = k4.peaks(np.fft.rfft(sig, axis=-1)[:, :HALF])
        total += int((p * r).sum())
        rows += sig.shape[0]
    return total, rows


def bound_s(pcms, fs: int) -> float:
    """The least time for K4 on these mono tracks' blocks at rate fs."""
    t = rows = 0
    for pcm in pcms:
        a, b = triples(pcm, fs)
        t += a
        rows += b
    return max(6.0 * t / PEAK_OPS, rows * 3 * HALF * 4 / PEAK_BYTES)
