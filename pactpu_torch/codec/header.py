""".wak/.pac stream format (reference codec/pacfile.py), numpy/struct only.

The header's bytes are pactpu.compat.refcodec.write_header/read_header's:
the "PAC " tag, sample rate, channels, numSamples, nMDCTLines, scale and
mantissa-size bit counts, then the band layout nLines[] so the stream is
self-describing.  The payload's framing (scan_channel_blocks): C
channel-blocks a block, each a uint32-LE byte count and that many bytes.
"""

from __future__ import annotations

import struct
from typing import Optional, Tuple

from pactpu_torch.utils.config import CodecConfig, assign_mdct_lines

PAC_TAG = b"PAC "


def write_header(cfg: CodecConfig, num_samples: int) -> Tuple[bytes, int]:
    """Returns (header bytes, numSamples as written).  Q6 padding quirk: a
    length that is a whole number of blocks is written one block longer
    (reference codec/pacfile.py:231-271), and the decoder trims to it."""
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


def scan_channel_blocks(buf, off: int = 0, limit: Optional[int] = None,
                        strict: bool = False) -> Tuple[list, list, int]:
    """The channel-blocks of a payload in buf from byte off (reference
    codec/pacfile.py:170-183): (starts, sizes, end), the offsets and byte
    counts of at most limit whole ones and the offset past the last.  It
    stops at a prefix cut short or a count past the buffer (a stream still
    arriving), where strict raises, as on a payload with none."""
    n = len(buf)
    starts, sizes, end = [], [], off
    while end < n and (limit is None or len(starts) < limit):
        size = struct.unpack_from("<L", buf, end)[0] if end + 4 <= n else None
        if size is None or end + 4 + size > n:
            if strict:
                raise ValueError(
                    "truncated channel-block header" if size is None else
                    "corrupt payload: channel-block length exceeds the stream")
            break
        starts.append(end + 4)
        sizes.append(size)
        end += 4 + size
    if strict and not starts:
        raise ValueError("no channel-blocks found in payload")
    return starts, sizes, end
