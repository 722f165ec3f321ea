"""Water-filling bit allocation (pactpu.ops.bitalloc.water_fill) and the
bit-allocation L/R-vs-M/S decision (lrms_decision_bitalloc).

The reference allocator (reference codec/bitalloc.py:129-184) is a greedy
loop: one mantissa bit per step to the band with the highest NMR residual,
a global stop test keyed to the candidate band's L/R-vs-M/S flag, a cap of
max_mant_bits, and a refund of 1-bit bands at the end.  Rows (one
channel of one block each) are independent; the loop runs as kernel K2
(pactpu_torch.ops.kernels.water_fill), one warp per row.
"""

from __future__ import annotations

import torch

from pactpu_torch.ops import kernels


def water_fill(total_bits: torch.Tensor, max_mant_bits: int,
               n_lines: torch.Tensor, smr: torch.Tensor, lrms: torch.Tensor,
               ms_stop: float = -5.0, lr_stop: float = -15.0):
    """Batched water-filling.

    total_bits: int[R] (int(bitBudget + extraBits) per row); n_lines:
    int[bands]; smr: f32[R, bands] (f64 stays f64: the fill then runs in
    float64); lrms: bool[R, bands].  Returns (bits i32[R, bands], leftover
    i32[R]) where leftover is the unspent budget after the 1-bit refund."""
    if smr.dtype != torch.float64:
        smr = smr.to(torch.float32)
    return kernels.water_fill(
        total_bits.to(torch.int32).contiguous(), int(max_mant_bits),
        n_lines.to(torch.int32).contiguous(), smr.contiguous(),
        lrms.to(torch.bool).contiguous(), ms_stop, lr_stop)


def lrms_decision_bitalloc(smr_lr: torch.Tensor, smr_ms: torch.Tensor,
                           n_lines: torch.Tensor, bit_budget: int,
                           max_mant_bits: int, ms_stop: float = -5.0,
                           lr_stop: float = -15.0) -> torch.Tensor:
    """Per-band L/R-vs-M/S decision by allocated bits (pactpu.ops.bitalloc.
    lrms_decision_bitalloc, the WAK paper's second rule): all four codings
    (L, R, M, S) of every block are water-filled in ONE call of kernel K2,
    4B rows, each under the flat per-channel budget with its own coding's
    stop threshold; a band goes M/S iff its M/S pair costs strictly fewer
    bits x lines than its L/R pair.

    smr_lr/smr_ms: f32[B, 2, bands] (or f64).  Returns bool[B, bands]."""
    b, _, n_bands = smr_lr.shape
    smr4 = torch.cat([smr_lr.reshape(2 * b, n_bands),
                      smr_ms.reshape(2 * b, n_bands)])
    lrms4 = torch.zeros((4 * b, n_bands), dtype=torch.bool,
                        device=smr4.device)
    lrms4[2 * b:] = True                  # M/S rows stop at ms_stop
    total = torch.full((4 * b,), int(bit_budget), dtype=torch.int32,
                       device=smr4.device)
    bits, _ = water_fill(total, max_mant_bits, n_lines, smr4, lrms4,
                         ms_stop, lr_stop)
    cost = bits.reshape(2, b, 2, n_bands).sum(2) * n_lines
    return cost[1] < cost[0]
