"""Device-side Huffman payload parsing (pactpu.ops.huffman_decode): host
framing of a stream payload into word rows, and the bit-serial decode walk
as lockstep tensor ops over all rows.

The reference decodes payloads with a per-line bit-by-bit tree walk
(reference codec/Huffman.py:321-344) inside a per-band side-info loop
(reference codec/pacfile.py:187-217): serial within a channel-block, because
every field's bit offset depends on the decoded lengths before it, and
parallel across channel-blocks.

`parse_rows` is the walk as plain tensor ops: what the device-parse route
computes on the CPU, and the reference the tests hold the walk kernel
(pactpu_torch.ops.huffman_walk) to.  No path uses it on a CUDA device.  It
shares its loop with the kernel's plain version (kernels.huffman_walk_plain,
64-bit arithmetic) and its sign/LRMS post-pass with the kernel, and resolves
codes through the same two-level LUT, which answers every 32-bit peek as the
reference's peek-indexed table does: the .wak layout (table id, sign bits,
Huffman codes, trailing LRMS bits).  `parse_rows_raw` parses the baseline
.pac layout, whose fields are all fixed-width: a band loop finds each
band's cursor, and kernel K1 slices every field.

Corruption handling: the walk never faults (words past a row read as zero,
garbage decodes to garbage); each row carries a `bad` flag (table id out of
range, no such codeword, or final bit position past the row's payload) that
the engine checks from the same download that returns the PCM.
"""

from __future__ import annotations

import hashlib

import numpy as np
import torch

from pactpu_torch.codec.header import scan_channel_blocks
from pactpu_torch.ops import kernels


def _tables_fingerprint(tables) -> tuple:
    """Cache key for a table set: shape + a content digest (a sum would
    collide across permuted codes and decode with a stale LUT)."""
    lengths, codes, esc_len, esc_codes = tables
    h = hashlib.sha1()
    for a in (lengths, codes, esc_len, esc_codes):
        h.update(np.ascontiguousarray(np.asarray(a, np.int64)).tobytes())
    return (tuple(np.shape(lengths)), h.hexdigest())


def frame_rows(payload: bytes, word_cap: int = 1 << 14):
    """Split a stream payload (past the header) into per-row word arrays.

    Each channel-block is a uint32-LE byte-count prefix + that many payload
    bytes (reference codec/pacfile.py:170-183; header.scan_channel_blocks).
    Returns (words u32[R, W] MSB-first rows, nbits i32[R] payload bit
    counts) with W = the widest row's words; raises ValueError on
    structural corruption (a prefix past the stream).  Rows wider than
    word_cap return (None, None): the caller takes the host parser."""
    starts, sizes, _ = scan_channel_blocks(payload, strict=True)
    r = len(starts)
    w = max(1, -(-max(sizes) // 4))
    if w > word_cap:
        return None, None
    # rows copied into one zeroed buffer of r x 4w bytes, read back as
    # big-endian words
    buf = bytearray(r * w * 4)
    view = memoryview(buf)
    for i, (o, nb) in enumerate(zip(starts, sizes)):
        view[i * w * 4:i * w * 4 + nb] = payload[o:o + nb]
    words = np.frombuffer(buf, ">u4").reshape(r, w).astype(np.uint32)
    return words, 8 * np.asarray(sizes, np.int32)


def parse_post(rec, words: torch.Tensor, nbits: torch.Tensor,
               lay: dict) -> dict:
    """Sign and LRMS resolution from the walk's records (kernel K5 or its
    plain version): the parse_rows output dict.

    rec = (code i32[R, lines] decoded unsigned values, zero on inactive
    lines; basf i32[R, bands] = ba_raw | sf << 8; soff i32[R, bands] bit
    offset of each band's sign bits; misc i32[R, 5] = overall, tid, bad,
    LRMS bit offset, end bit offset).  The walk only needs code lengths to
    find every field; the sign bits (one per line of an active band,
    reference codec/pacfile.py:334-337) and the trailing LRMS flags are
    fixed-width fields sliced here in bulk with kernel K1."""
    code, basf, soff, misc = rec
    seg = lay["seg"]
    n_bands = basf.shape[1]
    ba_raw = basf & 0xFF
    sf = (basf >> 8) & 0xFF
    ba = torch.where(ba_raw > 0, ba_raw + 1, 0)              # Q6
    active_line = ba[:, seg] > 0
    sign_off = soff[:, seg] + lay["line_in_band"]
    sign = kernels.extract_codes(words, sign_off.contiguous(),
                                 active_line.to(torch.int32))
    # m = huff + sign * 2^(ba-1) (reference pacfile.py:201-211), int32 wrap
    top_bit = kernels.u32_as_i32(torch.where(
        ba > 0, torch.bitwise_left_shift(
            torch.ones_like(ba, dtype=torch.long),
            torch.clamp(ba - 1, min=0).long()), 0))
    mant = code + sign * top_bit[:, seg]
    lrms_pos = misc[:, 3:4] + torch.arange(n_bands, dtype=torch.int32,
                                           device=words.device)
    lrms = kernels.extract_codes(words, lrms_pos.contiguous(),
                                 torch.ones_like(lrms_pos))
    bad = ((misc[:, 2] > 0) | (misc[:, 4] > nbits)) & (nbits > 0)
    return dict(overall=misc[:, 0], tid=misc[:, 1], ba=ba, sf=sf, mant=mant,
                lrms=lrms, bad=bad)


def parse_rows(cfg, words: torch.Tensor, nbits: torch.Tensor, lut: dict,
               lay: dict) -> dict:
    """Parse a batch of channel-block rows with plain tensor ops.

    words: i32[R, W] (u32 bit patterns, MSB-first), nbits: i32[R], both on
    the device of `lut` (huffman_walk.device_walk_lut) and `lay`
    (psycho.layout_tensors).  Returns dict(overall i32[R], tid i32[R],
    ba i32[R, bands], sf i32[R, bands], mant i32[R, lines] (sign-restored
    BFP codes), lrms i32[R, bands], bad bool[R]), value for value the
    output of pactpu.ops.huffman_decode.parse_rows_body(cfg, huff=True);
    nbits only gates `bad` (a padding row has zero words and parses to
    zeros)."""
    rec = kernels.huffman_walk_plain(
        words, lut, cfg.band_layout.n_lines, cfg.n_scale_bits,
        cfg.n_mant_size_bits, cfg.n_table_id_bits)
    return parse_post(rec, words, nbits, lay)


def parse_rows_raw(cfg, words: torch.Tensor, nbits: torch.Tensor,
                   lay: dict) -> dict:
    """Parse a batch of baseline .pac channel-block rows (reference
    codec/solution/pacfile_.py:290-305): overall scale, then per band its
    allocation (n_mant_size_bits, stored minus one) and scale factor, then
    the band's lines as raw allocation-bit sign-magnitude codes; no table
    id, no sign bits, no LRMS flags.

    Every field is fixed-width, so only the band cursors are serial: one
    step a band over all rows at once, each reading the band's two side
    fields (the first step also the overall scale) with kernel K1, then ONE
    K1 launch slices every mantissa of every row.  On a CUDA device this
    runs K1 or raises; on the CPU K1's plain version.

    words: i32[R, W] (u32 bit patterns, MSB-first), nbits: i32[R], on the
    device of `lay` (psycho.layout_tensors).  Returns the parse_rows dict
    (tid ones, lrms zeros), value for value pactpu.ops.huffman_decode.
    parse_rows_body(cfg, huff=False): a row whose cursor ends past its
    nbits is `bad`; a row with nbits 0 is padding and never bad."""
    r = words.shape[0]
    dev = words.device
    nsb, msb = cfg.n_scale_bits, cfg.n_mant_size_bits
    n_lines = lay["n_lines"]
    n_bands = n_lines.shape[0]
    cur = torch.full((r, 1), nsb, dtype=torch.int32, device=dev)
    # made on the device (no host value copied up: the stage is captured
    # into a CUDA graph on the card): offsets (0, msb), widths (msb, nsb)
    two = torch.arange(2, dtype=torch.int32, device=dev)
    side_off = two * msb
    side_w = torch.where(two == 0, msb, nsb).to(torch.int32).expand(r, 2)
    ba, sf, start = [], [], []
    for band in range(n_bands):
        off = cur + side_off
        if band == 0:                         # the overall scale in front
            f = kernels.extract_codes(
                words, torch.cat([torch.zeros_like(cur), off], 1),
                torch.cat([torch.full_like(cur, nsb), side_w], 1))
            overall, f = f[:, 0], f[:, 1:]
        else:
            f = kernels.extract_codes(words, off, side_w.contiguous())
        ba_b = torch.where(f[:, :1] > 0, f[:, :1] + 1, 0)        # Q6
        ba.append(ba_b)
        sf.append(f[:, 1:])
        cur = cur + (msb + nsb)
        start.append(cur)
        cur = cur + ba_b * n_lines[band]
    ba = torch.cat(ba, 1)
    width = ba[:, lay["seg"]].contiguous()
    off = torch.cat(start, 1)[:, lay["seg"]] + lay["line_in_band"] * width
    mant = kernels.extract_codes(words, off.contiguous(), width)
    bad = (cur[:, 0] > nbits) & (nbits > 0)
    return dict(overall=overall, tid=torch.ones_like(overall), ba=ba,
                sf=torch.cat(sf, 1), mant=mant,
                lrms=torch.zeros_like(ba), bad=bad)
