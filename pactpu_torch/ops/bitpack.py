"""On-device bitstream packing (pactpu.ops.bitpack).

The reference packs payload bits serially on the host (reference
codec/bitpack.py:36-101, driven by codec/pacfile.py:288-351).  Here the
payload of a batch of channel-blocks is made on the device:

1. The payload item stream (overallScale, tableID, per band: bitAlloc-1,
   scaleFactor, sign bits in groups of up to 32, Huffman codes; trailing
   LRMS flags) is a static permutation of the concatenated field arrays.
2. Bit offsets are an inclusive cumsum of the item widths, minus the width.
3. Each item touches at most two 32-bit words, and the parts are summed
   into MSB-first words.

On a CUDA device all three are one launch of kernel K3
(pactpu_torch.ops.kernels.pack_payload, a CTA a row) on the plan packed
by device_plan.  The plain version (pack_payload_bits_plain, what the CPU
runs) is pactpu's arithmetic in torch ops: u32 values in int64 with
explicit masks (torch has no logical shift on int32), then the scatter-add
of kernels.pack_words_plain.  The words travel as int32 bit patterns.  The
host then frames ceil(nbits/8) big-endian bytes per row
(pactpu_torch.native).
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from pactpu_torch.ops import kernels

_MASK32 = 0xFFFFFFFF


@lru_cache(maxsize=8)
def _pack_plan(n_lines: tuple, n_scale_bits: int, n_mant_size_bits: int,
               n_table_id_bits: int):
    """Static stream plan for one channel-block payload, identical to
    pactpu.ops.bitpack._pack_plan.

    Source vector layout (what pack_payload_bits concatenates per row):
      [overall(1), tid(1), ba_field(nb), sf(nb), sign(L), code(L),
       lrms(nb), sign_groups(G)]
    A band's nLines sign bits are contiguous in the stream (reference
    codec/pacfile.py:334-337), so they pack as ceil(nLines/32) group items.

    Returns (perm i32[M], const_width i32[M], kind i8[M], groups): kind 0 =
    constant width, 2 = code (dynamic length), 3 = sign group (const_width
    bits if the band transmits, else 0); groups = (band, start_line, glen)
    i32[G] arrays."""
    nb = len(n_lines)
    total = int(np.sum(n_lines))
    lo = np.concatenate([[0], np.cumsum(n_lines)[:-1]]).astype(np.int64)
    o_overall, o_tid = 0, 1
    o_ba, o_sf = 2, 2 + nb
    o_code = 2 + 2 * nb + total
    o_lrms = 2 + 2 * nb + 2 * total
    o_group = o_lrms + nb

    perm, cw, kind = [], [], []
    g_band, g_start, g_len = [], [], []

    def emit(src, width, k=0):
        perm.append(src)
        cw.append(width)
        kind.append(k)

    emit(o_overall, n_scale_bits)
    emit(o_tid, n_table_id_bits)
    for b in range(nb):
        emit(o_ba + b, n_mant_size_bits)
        emit(o_sf + b, n_scale_bits)
        for j in range(0, int(n_lines[b]), 32):
            glen = min(32, int(n_lines[b]) - j)
            emit(o_group + len(g_band), glen, k=3)
            g_band.append(b)
            g_start.append(int(lo[b]) + j)
            g_len.append(glen)
        for j in range(int(n_lines[b])):
            emit(o_code + lo[b] + j, 0, k=2)
    for b in range(nb):
        emit(o_lrms + b, 1)

    groups = (np.asarray(g_band, np.int32), np.asarray(g_start, np.int32),
              np.asarray(g_len, np.int32))
    return (np.asarray(perm, np.int32), np.asarray(cw, np.int32),
            np.asarray(kind, np.int8), groups)


def plan_dict(plan, device) -> dict:
    """A plan in _pack_plan's form as the int64 tensors payload_parts
    takes.  A band's lines are the runs of its sign groups, in order."""
    perm, cw, kind, (g_band, g_start, g_len) = plan
    total = int(np.sum(g_len))
    gl = np.arange(32, dtype=np.int64)[None, :]
    g_lines = np.minimum(g_start[:, None] + gl, total - 1)      # [G, 32]
    g_weights = np.where(gl < g_len[:, None],
                         1 << np.maximum(g_len[:, None] - 1 - gl, 0), 0)
    seg = np.repeat(g_band, g_len)
    t = lambda a: torch.as_tensor(np.asarray(a, np.int64), device=device)  # noqa: E731
    return dict(perm=t(perm), const_width=t(cw), kind=t(kind),
                g_band=t(g_band), g_len=t(g_len), g_lines=t(g_lines),
                g_weights=t(g_weights), seg=t(seg))


# unbounded: a captured CUDA graph reads it by address (codec/programs.py)
@lru_cache(maxsize=None)
def _plan_tensors(n_lines: tuple, n_scale_bits: int, n_mant_size_bits: int,
                  n_table_id_bits: int, device: str) -> dict:
    """The pack plan as device tensors (built once per layout and device)."""
    return plan_dict(_pack_plan(n_lines, n_scale_bits, n_mant_size_bits,
                                n_table_id_bits), device)


# the device plan's fields (csrc/pack_words.cu): an item is perm << 8 |
# kind << 6 | const_width, a sign group start << 16 | len << 10 | band
_PERM_LIMIT, _BAND_LIMIT, _START_LIMIT = 1 << 23, 1 << 10, 1 << 15


# unbounded: a captured CUDA graph reads it by address (codec/programs.py)
@lru_cache(maxsize=None)
def device_plan(n_lines: tuple, n_scale_bits: int, n_mant_size_bits: int,
                n_table_id_bits: int, device: str) -> tuple:
    """_pack_plan packed for kernels.pack_payload, built once per layout
    and device: (item_plan i32[M], group_plan i32[G])."""
    perm, cw, kind, (g_band, g_start, g_len) = _pack_plan(
        n_lines, n_scale_bits, n_mant_size_bits, n_table_id_bits)
    if (perm.max(initial=0) >= _PERM_LIMIT or cw.max(initial=0) > 63
            or g_band.max(initial=0) >= _BAND_LIMIT
            or g_start.max(initial=0) >= _START_LIMIT):
        raise ValueError("pack plan past the device plan's fields: at most "
                         f"{_PERM_LIMIT} sources, widths of 63 bits, "
                         f"{_BAND_LIMIT} bands, {_START_LIMIT} lines")
    # the kernel reads a dynamic width from a code line or a sign group
    nb, total = len(n_lines), int(np.sum(n_lines))
    o_code, o_lrms = 2 + 2 * nb + total, 2 + 2 * nb + 2 * total
    dyn = perm[kind != 0]
    if not (((dyn >= o_code) & (dyn < o_lrms)) | (dyn >= o_lrms + nb)).all():
        raise ValueError("pack plan: a dynamic width outside the codes and "
                         "the sign groups")
    items = (perm.astype(np.int64) << 8 | kind.astype(np.int64) << 6
             | cw.astype(np.int64))
    groups = (g_start.astype(np.int64) << 16 | g_len.astype(np.int64) << 10
              | g_band.astype(np.int64))
    return tuple(torch.as_tensor(a.astype(np.int32), device=device)
                 for a in (items, groups))


def decode_device_plan(item_plan: np.ndarray, group_plan: np.ndarray):
    """device_plan's arrays back in _pack_plan's form (perm, const_width,
    kind, (g_band, g_start, g_len))."""
    it = np.asarray(item_plan, np.int64)
    gp = np.asarray(group_plan, np.int64)
    return ((it >> 8).astype(np.int32), (it & 63).astype(np.int32),
            ((it >> 6) & 3).astype(np.int8),
            ((gp & 1023).astype(np.int32), (gp >> 16).astype(np.int32),
             ((gp >> 10) & 63).astype(np.int32)))


def payload_parts(overall, tid, ba, sf, sign, codes, lens, lrms_row,
                  p: dict):
    """The parts of pactpu's pack_payload_bits ahead of its Pallas call, on
    plan tensors p (plan_dict), in int64: (part0, part1, w0) i32[R, M]
    and nbits i32[R].  Each item touches at most two 32-bit words."""
    r, nb = ba.shape
    i64 = lambda a: a.to(torch.int64)  # noqa: E731
    ba = i64(ba)
    ba_field = torch.where(ba > 0, ba - 1, 0)
    band_on = (ba > 0)[:, p["seg"]]                          # [R, L]

    # grouped sign values: group g = the band's sign bits [start, start +
    # glen) packed MSB-first into one item of up to 32 bits
    sv = i64(sign)[:, p["g_lines"]]                          # [R, G, 32]
    grouped = (sv * p["g_weights"][None]).sum(-1)

    src_v = torch.cat([i64(overall)[:, None], i64(tid)[:, None], ba_field,
                       i64(sf), i64(sign), i64(codes), i64(lrms_row),
                       grouped], dim=1)
    # width sources aligned with src_v where dynamic: sign-group widths
    # are glen if the band transmits (ba > 0), else 0
    group_w = torch.where((ba > 0)[:, p["g_band"]], p["g_len"][None], 0)
    zeros = lambda k: torch.zeros((r, k), dtype=torch.int64,  # noqa: E731
                                  device=ba.device)
    src_w = torch.cat([zeros(2 + 2 * nb), i64(band_on), i64(lens),
                       zeros(nb), group_w], dim=1)

    values = src_v[:, p["perm"]] & _MASK32                   # [R, M]
    widths = torch.where(p["kind"][None] == 0, p["const_width"][None],
                         src_w[:, p["perm"]])
    ends = torch.cumsum(widths, dim=1)
    offs = ends - widths
    nbits = ends[:, -1]

    # each item spans word w0 and possibly w0 + 1; shift amounts stay in
    # [0, 31] as in the reference (shifts >= 32 are undefined on int32)
    w0 = offs >> 5
    avail = 32 - (offs & 31)                                 # bits left
    spill = torch.clamp(widths - avail, min=0)               # 0..31
    sh0 = torch.clamp(avail - widths, 0, 31)
    part0 = torch.where(widths <= avail, (values << sh0) & _MASK32,
                        values >> spill)
    low = values & (torch.bitwise_left_shift(torch.ones_like(spill),
                                             spill) - 1)
    part1 = torch.where(spill > 0,
                        (low << torch.clamp(32 - spill, 0, 31)) & _MASK32, 0)
    part0 = torch.where(widths > 0, part0, 0)
    return (kernels.u32_as_i32(part0), kernels.u32_as_i32(part1),
            w0.to(torch.int32), nbits.to(torch.int32))


def pack_payload_bits_plain(overall, tid, ba, sf, sign, codes, lens,
                            lrms_row, n_lines: tuple, n_scale_bits: int,
                            n_mant_size_bits: int, n_table_id_bits: int,
                            n_words: int):
    """Plain version of pack_payload_bits (of kernel K3's pack_payload):
    payload_parts on _pack_plan's tensors, summed by
    kernels.pack_words_plain (the scatter-add of pactpu's XLA path)."""
    p = _plan_tensors(tuple(int(x) for x in n_lines), n_scale_bits,
                      n_mant_size_bits, n_table_id_bits, str(ba.device))
    part0, part1, w0, nbits = payload_parts(overall, tid, ba, sf, sign,
                                            codes, lens, lrms_row, p)
    return kernels.pack_words_plain(part0, part1, w0, n_words), nbits


def pack_payload_bits(overall, tid, ba, sf, sign, codes, lens, lrms_row,
                      n_lines: tuple, n_scale_bits: int,
                      n_mant_size_bits: int, n_table_id_bits: int,
                      n_words: int):
    """Pack a batch of channel-block payloads into MSB-first u32 words.

    Shapes (R = channel-blocks): overall/tid int[R]; ba/sf int[R, nb];
    sign/codes/lens int[R, L] (zeroed where untransmitted); lrms_row
    bool/int[R, nb] (the per-block flags, replicated per channel).
    Returns (words i32[R, n_words] u32 bit patterns, nbits i32[R]): on a
    CUDA device one launch of kernel K3 (kernels.pack_payload), on the CPU
    the plain version."""
    if ba.device.type == "cpu":
        return pack_payload_bits_plain(
            overall, tid, ba, sf, sign, codes, lens, lrms_row, n_lines,
            n_scale_bits, n_mant_size_bits, n_table_id_bits, n_words)
    item_plan, group_plan = device_plan(
        tuple(int(x) for x in n_lines), n_scale_bits, n_mant_size_bits,
        n_table_id_bits, str(ba.device))
    i32 = lambda a: a.to(torch.int32).contiguous()  # noqa: E731
    return kernels.pack_payload(
        i32(overall), i32(tid), i32(ba), i32(sf), i32(sign), i32(codes),
        i32(lens), i32(lrms_row), item_plan, group_plan, n_words)


def compact_rows(words: torch.Tensor, nbits: torch.Tensor,
                 cap: int) -> torch.Tensor:
    """Dense-pack padded payload rows for one download.

    words: i32[R, W]; nbits: i32[R].  Row r occupies ceil(nbits[r]/32)
    words (clamped to W); those words land contiguously at the exclusive
    prefix sum of the counts.  Returns i32[cap + R]: the dense buffer
    followed by nbits.  Content past `cap` is dropped: the caller checks
    sum(counts) <= cap from the appended nbits and falls back to the padded
    rows when it overflows (pactpu.ops.bitpack.compact_rows)."""
    r, w = words.shape
    counts = torch.clamp((nbits.long() + 31) // 32, max=w)
    starts = torch.cumsum(counts, 0) - counts
    col = torch.arange(w, device=words.device)
    dest = starts[:, None] + col[None, :]
    keep = (col[None, :] < counts[:, None]) & (dest < cap)
    dest = torch.where(keep, dest, cap)        # dropped words -> spare slot
    dense = torch.zeros(cap + 1, dtype=torch.int32, device=words.device)
    dense.scatter_(0, dest.reshape(-1), words.reshape(-1))
    return torch.cat([dense[:cap], nbits.to(torch.int32)])
