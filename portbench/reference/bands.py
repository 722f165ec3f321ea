"""The frozen reference at band layouts with bands that hold no lines.

At 22.05 kHz the layout the header's rate gives (reference
codec/psychoac.py:124-156) has 25 bands whose last two hold no MDCT line.
Two loops of the frozen reference then take a maximum over no lines and
raise: the scale factor's peak in the allocation (wakref.allocate_block)
and the widest gap of a band's coded lines in the judge
(judge.line_err_steps).  The reference codec itself never ran at such a
rate (its own loops raise there too); the port's float64 oracle
(pactpu_torch/compat/refcodec.py) and the port read the peak of a band of
no lines as 0, so its scale factor is the largest, and the water-fill
grants such a band free bits (they cost no line).

The two functions below are the frozen ones with that one reading: the
peak of no lines is 0, and a band of no lines has no gap.  Wherever every
band has lines they give the frozen functions' results
(portbench/tests/test_pb_podcast.py).  `judging()` puts them in place of
the frozen ones while a judge runs; the benchmark's other cells never
reach them.
"""

from __future__ import annotations

import contextlib

import numpy as np

import judge as J
import wakref as R


def allocate_block(an: R.BlockAnalysis, cfg: R.CodecConfig, extra: int,
                   tables: R.HuffmanTables):
    """wakref.allocate_block, a band of no lines peaking at 0."""
    layout = cfg.band_layout
    n_lines_arr = np.asarray(layout.n_lines, dtype=np.int64)
    half = cfg.n_mdct_lines
    max_mant = min(1 << cfg.n_mant_size_bits, 16)
    budget = cfg.target_bits_per_sample * half
    budget -= cfg.n_scale_bits * (layout.n_bands + 1)
    budget -= cfg.n_mant_size_bits * layout.n_bands
    budget -= cfg.n_table_id_bits

    out = R.EncodedBlock([], [], [], [], [], [], [], an.lrms)
    out.overall_scale = list(an.overall)
    savings = []
    for c in range(cfg.n_channels):
        alloc, diff = R.bit_alloc(budget, extra, max_mant, layout.n_bands,
                                  n_lines_arr, an.smr[c], an.lrms)
        extra += diff
        sf = np.zeros(layout.n_bands, dtype=np.int64)
        mant_list, line_bits_list = [], []
        for b in range(layout.n_bands):
            lo, hi = layout.lower_line[b], layout.upper_line[b] + 1
            peak = float(np.max(np.abs(an.mixed[c][lo:hi]), initial=0.0))
            sf[b] = R.scale_factor_scalar(peak, cfg.n_scale_bits,
                                          int(alloc[b]))
            if alloc[b]:
                mant_list.append(R.bfp_mantissa_vec(
                    an.mixed[c][lo:hi], int(sf[b]), cfg.n_scale_bits,
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
        savings.append(raw_bits - used)
        out.table_id.append(tid)
        out.bit_alloc.append(alloc)
        out.scale_factor.append(sf)
        out.sign_bits.append(signs)
        out.huff_codes.append(codes)
        out.huff_lengths.append(lens)
    return out, savings, int(extra)


def line_err_steps(an: R.BlockAnalysis, parsed, cfg) -> float:
    """judge.line_err_steps, a band of no lines having no gap."""
    ba2, sf2, mant2, osc2, lrms, _ = parsed
    x = J.mixed_lines(an, osc2, lrms, cfg)
    lay = cfg.band_layout
    worst = 0.0
    for c in range(cfg.n_channels):
        for b in range(lay.n_bands):
            ba = int(ba2[c, b])
            lo, hi = lay.lower_line[b], lay.upper_line[b] + 1
            if not ba or hi <= lo:
                continue
            sf = int(sf2[c, b])
            deq = R.bfp_dequantize_vec(sf, mant2[c, lo:hi],
                                       cfg.n_scale_bits, ba)
            gap = float(np.max(np.abs(deq - x[c, lo:hi])))
            worst = max(worst, gap / J.quant_step(sf, ba, cfg.n_scale_bits))
    return worst


@contextlib.contextmanager
def judging():
    """The two functions above in place of the frozen ones, in this
    process, while the block runs (the judge's per-block analysis, in its
    workers, reaches neither)."""
    saved = R.allocate_block, J.line_err_steps
    R.allocate_block, J.line_err_steps = allocate_block, line_err_steps
    try:
        yield
    finally:
        R.allocate_block, J.line_err_steps = saved
