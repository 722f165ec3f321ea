"""Huffman table training (pactpu.ops.huffman_train): symbol histograms on
the device, the tree build on the host, dense tables out.

The reference trains its 10 static genre tables offline (reference
codec/Huffman.py:156-250): `HuffmanTrainer.countFreq` accumulates symbol
frequencies (Huffman.py:71-81), then `constructHuffmanTable` folds symbols
with frequency < LOW_FREQ (= 10) into the escape symbol, one escape count
per folded symbol (Huffman.py:92-109), builds the tree by merging the two
lowest-frequency nodes of a stable-sorted queue (Huffman.py:218-231) and
gives '0' to the first-popped child (Huffman.py:234-250).

Here `symbol_histogram` counts the unsigned mantissas of a batch of
blocks in one scatter-add on their device (Engine finalize's
`return_syms`), and `build_table` / `train_tables` / `save_tables` are
host numpy code, restated from pactpu's: a table set trained by either
package is array for array the same and loads in the other (the
huffman_tables.npz layout: lengths [T, S] uint8, 0 = absent; codes [T, S]
uint32, MSB-first in the low bits; escape_lengths [T]; escape_codes [T]).
Ties between equal frequencies go to the lower symbol, as in pactpu.
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np
import torch

LOW_FREQ = 10          # reference codec/Huffman.py:38
ESCAPE = -1            # reference codec/Huffman.py:39
NUM_SYMBOLS = 1 << 15  # unsigned BFP mantissas have <= 15 magnitude bits


def symbol_histogram(syms: torch.Tensor,
                     transmit: Optional[torch.Tensor] = None,
                     n_symbols: int = NUM_SYMBOLS) -> torch.Tensor:
    """Frequency count of unsigned mantissa symbols (any shape) in one
    scatter-add on their device; entries < 0 (lines not transmitted) and
    those where `transmit` is False are left out.  Returns i64[n_symbols]
    (reference Histogram.generateStatistics, codec/Huffman.py:71-81)."""
    s = syms.reshape(-1).long()
    ok = s >= 0
    if transmit is not None:
        ok = ok & transmit.reshape(-1)
    hist = torch.zeros(n_symbols, dtype=torch.long, device=s.device)
    return hist.index_add_(0, torch.where(ok, s, 0), ok.long())


def build_table(freqs: np.ndarray, low_freq: int = LOW_FREQ):
    """One Huffman table from a symbol-frequency histogram (reference
    codec/Huffman.py:92-109, 218-250): symbols with 0 < freq < low_freq
    fold into the escape symbol (one escape count each), absent symbols
    stay absent, nodes merge two at a time from a stable frequency-sorted
    queue, the first-popped child takes '0'.  An escape-only table gets the
    1-bit escape '0' (the reference's 0-bit root code cannot be coded).

    Returns (lengths u8[S], codes u32[S], escape length, escape code);
    raises on a code longer than 31 bits (the packer's 5-bit lengths)."""
    freqs = np.asarray(freqs)
    present = np.nonzero(freqs > 0)[0]
    escape_freq = int(np.count_nonzero(freqs[present] < low_freq))
    kept = [(int(sym), int(freqs[sym])) for sym in present
            if freqs[sym] >= low_freq]
    # stable sorts, the escape node appended after the first
    # (reference makeHuffmanNodeQueue)
    entries = sorted(kept, key=lambda t: t[1])
    entries.append((ESCAPE, escape_freq))
    # node = (freq, leaf symbol or None, left, right)
    queue = sorted([(f, sym, None, None) for sym, f in entries],
                   key=lambda t: t[0])
    while len(queue) > 1:
        first, second = queue[0], queue[1]
        rest = queue[2:]
        rest.append((first[0] + second[0], None, first, second))
        queue = sorted(rest, key=lambda t: t[0])  # stable: joined last
    root = queue[0]

    lengths = np.zeros(freqs.shape[0], np.uint8)
    codes = np.zeros(freqs.shape[0], np.uint32)
    if root[2] is None:                    # escape-only
        return lengths, codes, 1, 0
    esc_len = esc_code = 0
    stack = [(root, 0, 0)]                 # node, code, depth
    while stack:
        (_, sym, left, right), code, depth = stack.pop()
        if left is None:
            if sym == ESCAPE:
                esc_len, esc_code = depth, code
            else:
                lengths[sym] = depth
                codes[sym] = code
            continue
        stack.append((left, code << 1, depth + 1))       # first popped: 0
        stack.append((right, (code << 1) | 1, depth + 1))
    max_len = max(int(lengths.max(initial=0)), esc_len)
    if max_len > 31:
        raise ValueError(
            f"Huffman table has a {max_len}-bit code; the codec supports "
            "code lengths up to 31 bits: raise low_freq to flatten the "
            "tail of the symbol distribution")
    return lengths, codes, esc_len, esc_code


def train_tables(histograms: Dict[int, np.ndarray],
                 n_symbols: int = NUM_SYMBOLS):
    """A full table set from per-table histograms {table id (1-based):
    freqs}; missing ids get escape-only tables (1-bit escape), so the set
    stays dense and decodable.  Returns (lengths u8[T, S], codes u32[T, S],
    escape_lengths u8[T], escape_codes u32[T]), T the largest id."""
    t = max(histograms)
    lengths = np.zeros((t, n_symbols), np.uint8)
    codes = np.zeros((t, n_symbols), np.uint32)
    esc_len = np.ones(t, np.uint8)
    esc_code = np.zeros(t, np.uint32)
    for tid, freqs in histograms.items():
        le, co, el, ec = build_table(np.asarray(freqs))
        lengths[tid - 1, :le.shape[0]] = le
        codes[tid - 1, :co.shape[0]] = co
        esc_len[tid - 1] = el
        esc_code[tid - 1] = ec
    return lengths, codes, esc_len, esc_code


def save_tables(path: str, lengths: np.ndarray, codes: np.ndarray,
                escape_lengths: np.ndarray, escape_codes: np.ndarray) -> None:
    """Write a table set in the huffman_tables.npz layout, which
    Engine(tables=path) of either package reads."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.savez_compressed(path, lengths=lengths, codes=codes,
                        escape_lengths=escape_lengths,
                        escape_codes=escape_codes)
