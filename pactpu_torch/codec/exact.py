"""The exact serial bit reservoir (pactpu.codec.exact) on PyTorch.

The reference's reservoir couples block t to t + 1: each block withdraws a
share of the deposit before allocating, channel 0's allocation leftover
funds channel 1, and each channel's Huffman savings go back into the
deposit (reference codec/Huffman.py:353-371, codec/codec.py:229, 258-260).
Engine(rate_mode="exact") reproduces that trajectory exactly; with
precision="f64" its stream is the reference's serial encode byte for
byte (the float64 oracle, pactpu_torch.compat.refcodec).

Everything in the serial loop that depends on the running extra bits
does so through the integer allocation of a band, one of 0..16, so the
heavy part is computed for every allocation at once, batch-parallel:

    cost[b, ch, band, alloc, table] = sum over the band's lines of the
        Huffman code length (or escape length + alloc) of the mantissa the
        band would emit at that allocation

(cost_table: 16 quantize passes), and the serial part is one water-fill
per channel per block plus a gather of that table: kernel K7
(pactpu_torch.ops.kernels.exact_scan), one warp walking every block of a
chunk, the carry chained across chunks on the device.
"""

from __future__ import annotations

import torch

from pactpu_torch.ops import huffman, kernels, psycho
from pactpu_torch.ops import quantize as q
from pactpu_torch.utils.config import CodecConfig

N_ALLOCS = 17          # allocation values 0..16


def max_mant(cfg: CodecConfig) -> int:
    """The mantissa bit cap: the size field's range or max_mant_bits."""
    return min(1 << cfg.n_mant_size_bits, cfg.max_mant_bits)


def cost_table(cfg: CodecConfig, analysis: dict, dev: dict) -> torch.Tensor:
    """Huffman bits of every band at every allocation under every table
    (pactpu.codec.exact.cost_table_body, integer-equal to it):
    analysis dict (engine.analyze) -> i32[B, C, bands, 17, T], allocation
    0 all zeros.

    Exact because a band's scale factor depends only on its peak and its
    allocation (reference codec/codec.py:269-278).  Per allocation a: the
    scale factors and BFP mantissas of every line at a bits, each line's
    code length in each table (or that table's escape length + a), and the
    band sums as differences of an int32 running sum over the lines (the
    bands are consecutive runs of lines).  A symbol past a table's length
    reads its last entry, as pactpu's clamped gather does."""
    mixed = analysis["mixed"]                             # [B, C, half]
    lay = dev["lay"]
    tab_lens, _, esc_len, _ = dev["tabs"]
    n_tab, n_sym = tab_lens.shape
    b, c, _ = mixed.shape
    n_bands = lay["n_lines"].shape[0]
    hi = torch.cumsum(lay["n_lines"].long(), 0)
    lo = hi - lay["n_lines"].long()
    peak = psycho.band_max(torch.abs(mixed), lay, fill=0.0)
    out = torch.zeros((b, c, n_bands, N_ALLOCS, n_tab), dtype=torch.int32,
                      device=mixed.device)
    zero = torch.zeros((n_tab, b, c, 1), dtype=torch.int32,
                       device=mixed.device)
    for a in range(1, max_mant(cfg) + 1):
        a_t = torch.tensor(a, dtype=torch.int32, device=mixed.device)
        sf = q.scale_factor(peak, cfg.n_scale_bits, a_t)
        mant = q.bfp_mantissa(mixed, sf[..., lay["seg"]], cfg.n_scale_bits,
                              a_t)
        _, unsigned = huffman.split_sign(mant, a_t)
        lens = tab_lens[:, torch.clamp(unsigned.long(), max=n_sym - 1)]
        lens = torch.where(lens > 0, lens, esc_len[:, None, None, None] + a)
        run = torch.cat([zero, torch.cumsum(lens, -1, dtype=torch.int32)], -1)
        sums = run[..., hi] - run[..., lo]                # [T, B, C, bands]
        out[:, :, :, a] = sums.permute(1, 2, 3, 0)
    return out


def extras_chunked(cfg: CodecConfig, analyses: list, dev: dict, n_real: int,
                   carry: torch.Tensor = None):
    """The exact trajectory over a file's chunks (pactpu.codec.exact.
    exact_extras_chunked): per chunk the cost table, then kernel K7 from
    the last chunk's carry.  n_real: the file's real blocks (the padding
    behind them leaves the carry alone, so the chunk size never changes
    the trajectory).  Returns (per-chunk extras f32[size] on the device,
    the final carry i32[2] on the device); nothing waits for the device."""
    lay = dev["lay"]
    if carry is None:
        carry = torch.zeros(2, dtype=torch.int32,
                            device=lay["n_lines"].device)
    extras, done = [], 0
    for a in analyses:
        size = a["smr"].shape[0]
        ex, carry = kernels.exact_scan(
            a["smr"].contiguous(), a["lrms"].contiguous(),
            cost_table(cfg, a, dev), n_real - done, carry,
            float(cfg.bit_budget()), lay["n_lines"], max_mant(cfg),
            cfg.ms_stop_threshold_db, cfg.lr_stop_threshold_db,
            cfg.n_table_id_bits, cfg.reservoir_withdraw_divisor)
        # as pactpu: the extras go to finalize as float32
        extras.append(ex.to(torch.float32))
        done += size
    return extras, carry
