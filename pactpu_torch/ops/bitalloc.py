"""Bit allocation (pactpu.ops.bitalloc): water-filling (water_fill), the
bit-allocation L/R-vs-M/S decision (lrms_decision_bitalloc) and the other
four allocators of CodecConfig.alloc_mode: kai's closed form
(alloc_closed_form, kernel K8), uniform (alloc_uniform_batch, a prefix
compare), constant SNR and constant MNR (alloc_const_snr_batch /
alloc_const_mnr_batch, kernel K9).

The reference allocator (reference codec/bitalloc.py:129-184) is a greedy
loop: one mantissa bit per step to the band with the highest NMR residual,
a global stop test keyed to the candidate band's L/R-vs-M/S flag, a cap of
max_mant_bits, and a refund of 1-bit bands at the end.  Rows (one
channel of one block each) are independent; the loop runs as kernel K2
(pactpu_torch.ops.kernels.water_fill), one warp per row.
"""

from __future__ import annotations

import numpy as np
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


# -- the other allocators (pactpu/ops/bitalloc.py:156-478) ------------------

def closed_form_init(bit_budget, max_mant_bits: int, n_lines, smr):
    """kai's closed-form allocation before the take-back (reference
    baselines/kai/bitalloc.py:107-115): R = budget / sum(n_lines) +
    (SMR - avgSMR) / 6, avgSMR the line-weighted mean, R < 2 -> 0, capped at
    max_mant_bits, floored.  Returns (bits i32[R, bands], r [R, bands] in
    smr's type, before the gate, cap and floor), in the arithmetic of
    kernel K8 (kernels.closed_form_r)."""
    smr = _float_rows(smr)
    budget = torch.as_tensor(bit_budget, device=smr.device).to(
        torch.int32).reshape(-1).expand(smr.shape[0]).contiguous()
    r = kernels.closed_form_r(budget, smr, _lines(n_lines, smr.device))
    cap = torch.floor(torch.clamp(r, max=float(max_mant_bits)))
    bits = torch.where(torch.isnan(r) | (r < 2.0), 0.0, cap).to(torch.int32)
    return bits, r


def closed_form_takeback(bits0, bit_budget, n_lines, smr,
                         max_mant_bits: int = 16) -> torch.Tensor:
    """The overshoot take-back loop of kai's allocator (reference
    baselines/kai/bitalloc.py:116-134) from any bits0 i32[R, bands]: while
    the spent bits meet the budget, the band of least adjusted SMR gives
    back a bit (1-bit leftovers zeroed, emptied bands retired).  Plain
    tensor code (kernels.takeback_plain); the engine runs the init and
    this loop as one launch of K8 (alloc_closed_form)."""
    smr = _float_rows(smr)
    budget = torch.as_tensor(bit_budget, device=smr.device).to(
        torch.int64).reshape(-1).expand(smr.shape[0])
    return kernels.takeback_plain(torch.as_tensor(bits0), budget,
                                  _lines(n_lines, smr.device), smr,
                                  int(max_mant_bits))


def alloc_closed_form(bit_budget, max_mant_bits: int, n_lines,
                      smr) -> torch.Tensor:
    """kai's closed-form allocator end to end (kernel K8): bit_budget i32[R]
    (or a scalar), smr f32[R, bands] (or [bands]; float64 stays float64).
    Returns bits i32[R, bands] (or [bands])."""
    one = torch.as_tensor(smr).dim() == 1
    smr = _float_rows(smr)
    budget = torch.as_tensor(bit_budget, device=smr.device).to(
        torch.int32).reshape(-1).expand(smr.shape[0]).contiguous()
    bits = kernels.closed_form(budget, smr, _lines(n_lines, smr.device),
                               int(max_mant_bits))
    return bits[0] if one else bits


def _greedy_floor(allocation: torch.Tensor, max_mant_bits: int):
    allocation = torch.where(allocation < 2, 0, allocation)
    return torch.clamp(allocation, max=max_mant_bits)


def _legacy_iter_bound(budget_cap: int, n_lines, n_bands: int) -> int:
    """The static trip bound of the legacy allocators' loops (pactpu's): the
    paid grants, budget // min(n_lines) (at least 1 line), plus 16 free
    grants a band."""
    min_lines = max(1, int(np.min(np.asarray(n_lines))))
    return int(budget_cap) // min_lines + 16 * int(n_bands)


def alloc_uniform_batch(total_bits, max_mant_bits: int, n_lines,
                        budget_cap: int) -> torch.Tensor:
    """Batched BitAllocUniform (reference codec/bitalloc.py:22-57): equal
    bits per line, leftovers round-robined one bit a band until the first
    band the rest cannot pay for.

    The rest, total - floor(total / sum(n_lines)) x sum(n_lines), is below
    sum(n_lines), so the round-robin ends within its first pass over the
    bands (pactpu's loop bound, _legacy_iter_bound(budget_cap, ...), is at
    least one pass, so budget_cap never cuts it): band j gets its extra bit
    exactly when rest - (lines of the bands before j) > 0 and rest - (lines
    up to j) >= 0, a prefix of the bands, and only below max_mant_bits.
    One cumulative sum and a compare, no loop.  total_bits: i32[R].
    Returns bits i32[R, bands]."""
    total = torch.as_tensor(total_bits).long().reshape(-1)
    nl = _lines(n_lines, total.device).long()
    lines = nl.sum()
    per_line = torch.div(total, lines, rounding_mode="floor")
    rest = (total - per_line * lines)[:, None]
    upto = torch.cumsum(nl, 0)
    take = (rest - (upto - nl) > 0) & (rest - upto >= 0)
    alloc = per_line[:, None] + (take & (per_line[:, None] < max_mant_bits))
    return _greedy_floor(alloc, max_mant_bits).to(torch.int32)


def _greedy_noise_floor_batch(total_bits, max_mant_bits: int, n_lines,
                              level, budget_cap: int) -> torch.Tensor:
    """Batched greedy core of ConstSNR/ConstMNR (reference
    codec/bitalloc.py:60-125): per row, a bit to the grantable band of
    largest level, that level 6 dB lower, until nothing is grantable or
    _legacy_iter_bound(budget_cap, ...) grants; kernel K9
    (kernels.grant_fill), with the reference's `remaining > 0` guard
    (ROADMAP queue 3, fault (b)).  level is taken in float32, as pactpu
    takes it."""
    level = torch.as_tensor(level).to(torch.float32).contiguous()
    total = torch.as_tensor(total_bits, device=level.device).to(
        torch.int32).reshape(-1).contiguous()
    host = _host_lines(n_lines)
    return kernels.grant_fill(
        total, level, _lines(n_lines, level.device), int(max_mant_bits),
        _legacy_iter_bound(budget_cap, host, host.shape[0]))


def alloc_const_snr_batch(total_bits, max_mant_bits: int, n_lines, peak_spl,
                          budget_cap: int) -> torch.Tensor:
    """Batched BitAllocConstSNR (reference codec/bitalloc.py:60-90): the
    grant walk on the per-band peak SPL."""
    return _greedy_noise_floor_batch(total_bits, max_mant_bits, n_lines,
                                     peak_spl, budget_cap)


def alloc_const_mnr_batch(total_bits, max_mant_bits: int, n_lines, smr,
                          budget_cap: int) -> torch.Tensor:
    """Batched BitAllocConstMNR (reference codec/bitalloc.py:93-125): the
    grant walk on the per-band SMR."""
    return _greedy_noise_floor_batch(total_bits, max_mant_bits, n_lines,
                                     smr, budget_cap)


def alloc_uniform(bit_budget: int, max_mant_bits: int,
                  n_lines) -> torch.Tensor:
    """One row of alloc_uniform_batch (reference BitAllocUniform)."""
    return alloc_uniform_batch(torch.tensor([int(bit_budget)]),
                               max_mant_bits, n_lines, int(bit_budget))[0]


def alloc_const_snr(bit_budget: int, max_mant_bits: int, n_lines,
                    peak_spl) -> torch.Tensor:
    """One row of alloc_const_snr_batch (reference BitAllocConstSNR)."""
    level = torch.as_tensor(peak_spl)[None]
    return alloc_const_snr_batch(torch.tensor([int(bit_budget)]),
                                 max_mant_bits, n_lines, level,
                                 int(bit_budget))[0]


def alloc_const_mnr(bit_budget: int, max_mant_bits: int, n_lines,
                    smr) -> torch.Tensor:
    """One row of alloc_const_mnr_batch (reference BitAllocConstMNR)."""
    level = torch.as_tensor(smr)[None]
    return alloc_const_mnr_batch(torch.tensor([int(bit_budget)]),
                                 max_mant_bits, n_lines, level,
                                 int(bit_budget))[0]


def _float_rows(smr) -> torch.Tensor:
    """SMR rows [R, bands] as a contiguous float tensor: float64 stays,
    anything else becomes float32."""
    smr = torch.as_tensor(smr)
    if smr.dim() == 1:
        smr = smr[None]
    if smr.dtype != torch.float64:
        smr = smr.to(torch.float32)
    return smr.contiguous()


def _lines(n_lines, device) -> torch.Tensor:
    """The band line counts as an int32 tensor on `device`: a tensor as it
    is, a host sequence through the cached upload of kernels._band_tensor
    (no copy, and no wait for the device, a call)."""
    if torch.is_tensor(n_lines):
        return n_lines.to(device=device, dtype=torch.int32).contiguous()
    return kernels._band_tensor(tuple(int(n) for n in np.asarray(n_lines)),
                                torch.device(device))


def _host_lines(n_lines) -> np.ndarray:
    return (n_lines.cpu().numpy() if torch.is_tensor(n_lines)
            else np.asarray(n_lines))
