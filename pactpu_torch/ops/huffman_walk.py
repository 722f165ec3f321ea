"""The Huffman payload walk on the device (pactpu.ops.huffman_walk): the
two-level decode LUT, its cached upload, and the parse of a batch of
channel-block rows through kernel K5 (kernels.huffman_walk) and the shared
sign/LRMS post-pass.

LUT structure (zlib-"enough" style, per table, K1 = 11 root bits): level 1
is a 2,048-entry u32 array indexed by the top 11 bits of the peek; an entry
is symbol << 6 | escape << 5 | length for codes of at most 11 bits, or
bit 31 | rank for a deep prefix.  A 128-entry side table maps rank ->
subtable base << 4 | k2, and level 2 is a pool indexed by base + the next
k2 bits (a k2 per prefix keeps the worst pool of the shipped tables at
13,056 entries).  An unused entry is 0: length 0 marks "no such codeword".

The LUT's bounds (outside them build_walk_lut and parse_rows_walk return
None): code and escape lengths of 1 to 31 bits, symbols <= 0x7FFF, at most
128 deep prefixes per table.  The walk itself has no bound on the rows'
width (every peek is bounds-checked at its absolute bit offset), and takes
n_mant_size_bits up to 5 (bit allocations up to 32).

Rows are not grouped by table id: the kernel reads the LUT of the row's
table from global memory (all ten tables are 0.6 MB and stay in L2), so
the outputs are in the caller's row order with no permutation to undo.

Exactness: equal to huffman_decode.parse_rows on every input, corrupt and
zero-length rows included (reference codec/Huffman.py:321-344 bit walk and
escapes, codec/pacfile.py:187-217 field order, Q6 bit allocation stored
minus one, Q7 sign-first payload).
"""

from __future__ import annotations

import numpy as np
import torch

from pactpu_torch.ops import huffman_decode as hd
from pactpu_torch.ops import kernels
from pactpu_torch.ops.huffman import load_tables
from pactpu_torch.ops.psycho import layout_tensors

K1 = kernels.WALK_ROOT_BITS    # root peek bits of the two-level LUT
_MAX_RANK = 127                # deep-prefix ranks must fit 7 bits

_walk_lut_cache: dict = {}     # table digest -> numpy LUT (or None)
_dev_walk_lut_cache: dict = {}  # (table digest, device) -> tensors (or None)


def _cache_key(tables):
    """The shipped set (None) needs no digest: hashing its 5 MB would cost
    more than a chunk's walk."""
    return "shipped" if tables is None else hd._tables_fingerprint(tables)


def build_walk_lut(tables=None):
    """Two-level decode LUT of a table set (lengths[T, S], codes[T, S],
    esc_len[T], esc_code[T]); None = the shipped tables.  Returns
    dict(l1 u32[T, 2^K1], l1b u32[T, 128], l2 u32[T, widest pool]) of numpy
    arrays, or None when a table breaks the LUT's bounds."""
    key = _cache_key(tables)
    if key in _walk_lut_cache:
        return _walk_lut_cache[key]
    if tables is None:
        tables = load_tables()
    lengths = np.asarray(tables[0], np.int64)
    codes = np.asarray(tables[1], np.int64)
    esc_len = np.asarray(tables[2], np.int64)
    esc_codes = np.asarray(tables[3], np.int64)
    n_tab = lengths.shape[0]

    l1 = np.zeros((n_tab, 1 << K1), np.uint32)
    l1b = np.zeros((n_tab, _MAX_RANK + 1), np.uint32)
    pools = []
    for t in range(n_tab):
        entries = [(int(codes[t, s]), int(lengths[t, s]), int(s), False)
                   for s in np.nonzero(lengths[t])[0]]
        entries.append((int(esc_codes[t]), int(esc_len[t]), 0, True))
        lens = [ln for _, ln, _, _ in entries]
        if (max(lens) > 31 or min(lens) < 1
                or max(s for _, _, s, _ in entries) > 0x7FFF):
            pools = None
            break
        deep: dict = {}        # prefix of a code longer than K1 -> its k2
        for c, ln, _, _ in entries:
            if ln > K1:
                pref = c >> (ln - K1)
                deep[pref] = max(deep.get(pref, 0), ln - K1)
        if len(deep) > _MAX_RANK + 1:
            pools = None
            break
        base = 0
        pref_base = {}
        for rank, (pref, k2) in enumerate(sorted(deep.items())):
            pref_base[pref] = (base, k2)
            l1b[t, rank] = (base << 4) | k2
            l1[t, pref] = 0x80000000 | rank
            base += 1 << k2
        pool = np.zeros(base, np.uint32)
        for c, ln, s, esc in entries:
            ent = (s << 6) | (0x20 if esc else 0) | ln
            if ln <= K1:
                lo = c << (K1 - ln)
                l1[t, lo:lo + (1 << (K1 - ln))] = ent
            else:
                b0, k2 = pref_base[c >> (ln - K1)]
                tail = c & ((1 << (ln - K1)) - 1)
                lo = b0 + (tail << (k2 - (ln - K1)))
                pool[lo:lo + (1 << (k2 - (ln - K1)))] = ent
        pools.append(pool)

    out = None
    if pools is not None:
        l2 = np.zeros((n_tab, max(1, max(p.shape[0] for p in pools))),
                      np.uint32)
        for t, pool in enumerate(pools):
            l2[t, :pool.shape[0]] = pool
        out = dict(l1=l1, l1b=l1b, l2=l2)
    _walk_lut_cache[key] = out
    return out


def device_walk_lut(tables, device):
    """build_walk_lut as int32 tensors (u32 bit patterns) on `device`,
    uploaded once per (table set, device); None when the tables do not
    fit."""
    device = torch.device(device)
    key = (_cache_key(tables), str(device))
    if key not in _dev_walk_lut_cache:
        host = build_walk_lut(tables)
        _dev_walk_lut_cache[key] = None if host is None else {
            k: torch.from_numpy(v.view(np.int32)).to(device)
            for k, v in host.items()}
    return _dev_walk_lut_cache[key]


def _i32_on(a, device) -> torch.Tensor:
    """numpy u32/i32 (or a tensor) -> int32 tensor of the same bits on
    `device`."""
    if isinstance(a, np.ndarray):
        a = torch.from_numpy(np.ascontiguousarray(a).view(np.int32))
    return a.to(device)


def parse_rows_walk(cfg, words, nbits, tables, device, lay=None):
    """Parse payload rows through the walk kernel and the post-pass.

    words: u32[R, W] numpy (or i32 tensor on `device`) MSB-first rows,
    nbits: i32[R].  Returns the huffman_decode.parse_rows dict (tensors on
    `device`, rows in the caller's order), or None when the tables are
    outside the LUT's bounds.  On a CUDA device the walk is kernel K5, on
    the CPU its plain version."""
    lut = device_walk_lut(tables, device)
    if lut is None:
        return None
    if lay is None:
        lay = layout_tensors(cfg.band_layout, device)
    words, nbits = _i32_on(words, device), _i32_on(nbits, device)
    rec = kernels.huffman_walk(words, lut, cfg.band_layout.n_lines,
                               cfg.n_scale_bits, cfg.n_mant_size_bits,
                               cfg.n_table_id_bits)
    return hd.parse_post(rec, words, nbits, lay)
