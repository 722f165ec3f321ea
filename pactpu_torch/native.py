"""ctypes binding to the repository's native bitstream runtime, the host
half of the stream format: csrc/wakbits.cc (which the JAX package builds
too) and the port's pactpu_torch/csrc/wakbits_ranges.cc, which includes
it and adds a word-wide parse and repack, run over ranges of
channel-blocks on several host threads.

The library is compiled at first use with ``g++ -O3 -shared -fPIC
-pthread`` from wakbits_ranges.cc in place into ``pactpu_torch/_build/``
(git-ignored), and rebuilt when either source is newer than the library.
There is no pure-Python fallback: a failed build raises.

Bound here: ``unpack_file`` (the Huffman parser of the decoder),
``pack_file`` (the serializer, which the baseline .pac encoder uses),
``repack_codes`` (fixed-width mantissa words for the device extractor),
``assemble_rows`` / ``assemble_rows_flat`` (framing of device-packed payload
rows) and ``init_tables`` (the decode trees of the shipped or a trained
table set, and its two-level LUT, uploaded into the library's
process-wide table slot).

The parse reads a channel-block through a 64-bit bit buffer and decodes
each Huffman code by a lookup in the table set's two-level LUT
(ops.huffman_walk.build_walk_lut, the one the device walk K5 reads: 11
root bits, a second level for longer codes); the repack moves each
line's code through a 64-bit accumulator.  Where build_walk_lut returns
None for the set, or the library finds an entry that its trees decode
otherwise, the .wak parse runs wakbits.cc's serial tree walk instead;
so does a parse or repack of widths the word loops do not take
(wakbits_ranges.cc names them).  Either way the outputs are the serial
loop's bit for bit, and an error names the first bad channel-block as
the serial loop does.

``unpack_file`` and ``repack_codes`` cut their channel-blocks into
contiguous ranges (of whole blocks, for the parse) and run the loop on
each at once, one host thread a range.  The number of ranges is the
smaller of the CPUs the process may use and the channel-blocks over
MIN_RANGE, so a short input (a stream push's 32 channel-blocks) runs on
the calling thread.  The spans "parse" and "repack" count the ranges
that ran as ``threads``; "parse" also counts ``lut`` (1 when the word
loop ran, 0 when the serial walk did), ``deep`` (codes that took the
LUT's second level) and ``escapes``.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading

import numpy as np

from pactpu_torch.utils.metrics import span

_PKG = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_PKG, "csrc", "wakbits_ranges.cc")
# the serial runtime, which _SRC includes
_SERIAL_SRC = os.path.join(os.path.dirname(_PKG), "csrc", "wakbits.cc")
BUILD_DIR = os.path.join(_PKG, "_build")

# The fewest channel-blocks a host thread of the parse or the repack takes:
# a call of n channel-blocks runs on at most n // MIN_RANGE threads (one
# below 2 * MIN_RANGE).  On the 8-CPU host of an H100 machine
# (tools/native_ranges.py, 17-20 us a channel-block on one thread) a
# thread took 0.25-0.45 ms to start, under a tenth of a 256-block range's
# work: calls of 512 channel-blocks and more ran 1.5-1.9x faster on 2
# threads than on one, and ranges of 64 ran slower than fewer threads.
MIN_RANGE = 256

_lock = threading.Lock()
_lib = None
# the table set the library's decode trees hold: (the tuple last uploaded,
# its fingerprint, 1 if the library took its LUT else 0), or None before
# the first upload
_tables_ready = None


def _build() -> str:
    os.makedirs(BUILD_DIR, exist_ok=True)
    so = os.path.join(BUILD_DIR, "libwakbits_ranges.so")
    if (not os.path.exists(so)
            or os.path.getmtime(so) < max(os.path.getmtime(_SRC),
                                          os.path.getmtime(_SERIAL_SRC))):
        tmp = f"{so}.{os.getpid()}.tmp"
        res = subprocess.run(["g++", "-O3", "-shared", "-fPIC", "-pthread",
                              "-o", tmp, _SRC],
                             capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"building {_SRC} failed:\n{res.stderr}")
        os.replace(tmp, so)
    return so


def _load():
    global _lib
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(_build())
        u8p = ctypes.POINTER(ctypes.c_uint8)
        u32p = ctypes.POINTER(ctypes.c_uint32)
        i32p = ctypes.POINTER(ctypes.c_int32)
        lib.wak_init_tables_lut.restype = ctypes.c_int
        lib.wak_init_tables_lut.argtypes = [u8p, u32p, u8p, u32p,
                                            ctypes.c_int, ctypes.c_int,
                                            u32p, u32p, u32p,
                                            ctypes.c_int64]
        lib.wak_assemble_rows.restype = ctypes.c_int64
        lib.wak_assemble_rows.argtypes = [u32p, ctypes.c_int, ctypes.c_int,
                                          i32p, u8p, ctypes.c_int64]
        lib.wak_assemble_rows_flat.restype = ctypes.c_int64
        lib.wak_assemble_rows_flat.argtypes = [u32p, i32p, i32p,
                                               ctypes.c_int, u8p,
                                               ctypes.c_int64]
        lib.wak_repack_codes_ranges.restype = ctypes.c_int64
        lib.wak_repack_codes_ranges.argtypes = [
            ctypes.c_int, ctypes.c_int, i32p, ctypes.c_int, i32p, i32p,
            u32p, ctypes.c_int, ctypes.c_int]
        lib.wak_pack_file.restype = ctypes.c_int64
        lib.wak_pack_file.argtypes = (
            [ctypes.c_int, ctypes.c_int, i32p] + [ctypes.c_int] * 6
            + [i32p] * 8 + [u8p, ctypes.c_int64])
        lib.wak_count_blocks.restype = ctypes.c_int64
        lib.wak_count_blocks.argtypes = [u8p, ctypes.c_int64]
        lib.wak_unpack_file_ranges.restype = ctypes.c_int64
        lib.wak_unpack_file_ranges.argtypes = (
            [u8p, ctypes.c_int64, ctypes.c_int, ctypes.c_int, i32p,
             ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
             ctypes.c_int, ctypes.c_int] + [i32p] * 6
            + [ctypes.c_int, ctypes.POINTER(ctypes.c_int64)])
        _lib = lib
    return _lib


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def _i32(a) -> np.ndarray:
    return np.ascontiguousarray(a, dtype=np.int32)


def init_tables(tables=None) -> int:
    """Upload Huffman decode trees, and their two-level LUT (ops.
    huffman_walk.build_walk_lut), into the library's process-wide slot:
    `tables` (lengths [T, S], codes [T, S], escape_lengths [T],
    escape_codes [T]), e.g. a set trained by pactpu_torch.ops.
    huffman_train, or None for the shipped set (pactpu_torch.ops.huffman.
    load_tables).  Uploads only when the set changes: the same tuple is
    recognised at once, another by a digest of its contents (as
    pactpu.native.init_tables, whose key is a sum of each array), so
    engines with different table sets interleave correctly.  Returns 1
    if the parse reads the set's LUT, 0 if it walks the trees."""
    global _tables_ready
    from pactpu_torch.ops.huffman import load_tables
    from pactpu_torch.ops.huffman_decode import _tables_fingerprint
    from pactpu_torch.ops.huffman_walk import K1, build_walk_lut
    lib = _load()
    given = tables
    if tables is None:
        tables = load_tables()
    with _lock:
        if _tables_ready is not None and _tables_ready[0] is tables:
            return _tables_ready[2]
        key = _tables_fingerprint(tables)
        if _tables_ready is None or _tables_ready[1] != key:
            lengths, codes, esc_len, esc_codes = tables
            le = np.ascontiguousarray(lengths, np.uint8)
            co = np.ascontiguousarray(codes, np.uint32)
            el = np.ascontiguousarray(esc_len, np.uint8)
            ec = np.ascontiguousarray(esc_codes, np.uint32)
            lut = build_walk_lut(given)
            if lut is None:
                l1 = l1b = l2 = ctypes.POINTER(ctypes.c_uint32)()
                pool = 0
            else:
                lut = {k: np.ascontiguousarray(v, np.uint32)
                       for k, v in lut.items()}
                if (lut["l1"].shape != (le.shape[0], 1 << K1)
                        or lut["l1b"].shape != (le.shape[0], 128)
                        or lut["l2"].shape[0] != le.shape[0]):
                    raise ValueError("init_tables: the LUT's shapes do not "
                                     "match the table set")
                l1, l1b, l2 = (_ptr(lut[k], ctypes.c_uint32)
                               for k in ("l1", "l1b", "l2"))
                pool = lut["l2"].shape[1]
            on = lib.wak_init_tables_lut(
                _ptr(le, ctypes.c_uint8), _ptr(co, ctypes.c_uint32),
                _ptr(el, ctypes.c_uint8), _ptr(ec, ctypes.c_uint32),
                le.shape[0], le.shape[1], l1, l1b, l2, pool)
        else:
            on = _tables_ready[2]
        _tables_ready = (tables, key, on)
        return on


def pack_file(n_lines: np.ndarray, n_scale_bits: int, n_mant_size_bits: int,
              n_table_id_bits: int, overall: np.ndarray, table_id: np.ndarray,
              ba: np.ndarray, sf: np.ndarray, sign: np.ndarray,
              code: np.ndarray, length: np.ndarray, lrms: np.ndarray,
              write_lrms: bool = True, n_channels: int = 2) -> bytes:
    """Serialize all channel-block payloads (pactpu.native.pack_file).

    Shapes: overall/table_id [R]; ba/sf [R, bands]; sign/code/length
    [R, total_lines]; lrms [R // n_channels, bands] (per block).  R =
    n_channels * n_blocks in block-major, channel-minor order.
    n_table_id_bits == 0 selects the baseline .pac layout (raw mantissas
    in `code`/`length`, no signs)."""
    lib = _load()
    args = [_i32(a) for a in (overall, table_id, ba, sf, sign, code, length,
                              lrms)]
    r, n_bands, total_lines = args[0].shape[0], args[2].shape[1], \
        args[4].shape[1]
    nl = _i32(n_lines)
    if (any(a.shape != (r, n_bands) for a in args[2:4])
            or any(a.shape != (r, total_lines) for a in args[4:7])
            or args[1].shape != (r,) or nl.shape != (n_bands,)
            or int(nl.sum()) != total_lines
            or args[7].shape != (-(-r // int(n_channels)), n_bands)):
        raise ValueError("pack_file: inconsistent shapes")
    # worst case: every line a 32-bit code + its sign, plus side info
    cap = r * (4 + 16 + (total_lines * 33 + n_bands * 16) // 8 + 64)
    out = np.zeros(cap, np.uint8)
    n = lib.wak_pack_file(
        r, n_bands, _ptr(nl, ctypes.c_int32), total_lines, n_scale_bits,
        n_mant_size_bits, n_table_id_bits, 1 if write_lrms else 0,
        int(n_channels), *(_ptr(a, ctypes.c_int32) for a in args),
        _ptr(out, ctypes.c_uint8), ctypes.c_int64(cap))
    if n < 0:
        raise RuntimeError("wak_pack_file: output capacity exceeded")
    return out[:n].tobytes()


def assemble_rows(words: np.ndarray, nbits: np.ndarray) -> bytes:
    """Frame device-packed payload rows: uint32 LE byte-count prefix +
    big-endian bytes of each row's u32 words (first (nbits+7)/8 bytes)."""
    lib = _load()
    words = np.ascontiguousarray(words, np.uint32)
    nb = _i32(nbits)
    r, w = words.shape
    cap = r * (4 + w * 4)
    out = np.empty(cap, np.uint8)
    n = lib.wak_assemble_rows(_ptr(words, ctypes.c_uint32), r, w,
                              _ptr(nb, ctypes.c_int32),
                              _ptr(out, ctypes.c_uint8), ctypes.c_int64(cap))
    if n < 0:
        raise RuntimeError("wak_assemble_rows: row overran its words buffer")
    return out[:n].tobytes()


def assemble_rows_flat(words_flat: np.ndarray, word_offsets: np.ndarray,
                       nbits: np.ndarray) -> bytes:
    """Frame DENSE device-packed payload rows: like assemble_rows, but row
    r's words start at word_offsets[r] in the flat u32 buffer."""
    lib = _load()
    words_flat = np.ascontiguousarray(words_flat, np.uint32)
    off = _i32(word_offsets)
    nb = _i32(nbits)
    r = int(nb.shape[0])
    need = off.astype(np.int64) + (nb.astype(np.int64) + 31) // 32
    if r and int(need.max()) > words_flat.shape[0]:
        raise ValueError("assemble_rows_flat: a row overruns the buffer")
    cap = int(4 * r + ((nb.astype(np.int64) + 7) // 8).sum())
    out = np.empty(cap, np.uint8)
    n = lib.wak_assemble_rows_flat(
        _ptr(words_flat, ctypes.c_uint32), _ptr(off, ctypes.c_int32),
        _ptr(nb, ctypes.c_int32), r, _ptr(out, ctypes.c_uint8),
        ctypes.c_int64(cap))
    if n < 0:
        raise RuntimeError("wak_assemble_rows_flat: capacity exceeded")
    return out[:n].tobytes()


def _n_ranges(n_cblocks: int, most: int, ranges) -> int:
    """The ranges (host threads) a call over n_cblocks channel-blocks
    runs: `ranges` if given (tests), else the smaller of the CPUs this
    process may use and n_cblocks // MIN_RANGE; at least 1, at most
    `most`."""
    if ranges is None:
        ranges = min(len(os.sched_getaffinity(0)), n_cblocks // MIN_RANGE)
    return max(1, min(ranges, most))


def repack_codes(mant: np.ndarray, ba: np.ndarray, n_lines: np.ndarray,
                 n_words: int, *, _ranges=None) -> np.ndarray:
    """Repack decoded mantissa codes [R, total_lines] into fixed-width
    MSB-first u32 words [R, n_words] (ba[b] bits per line of band b), in
    ranges of rows on several host threads (`_ranges` sets their number,
    for tests); the span "repack" counts the rows, their words (n_words),
    their mantissa bits (ba times n_lines, summed) and the threads."""
    with span("repack", rows=len(mant), words=n_words) as sp:
        if sp is not None:
            sp.counts["bits"] = int((np.asarray(ba, np.int64)
                                     @ np.asarray(n_lines, np.int64)).sum())
        return _repack_codes(mant, ba, n_lines, n_words, sp, _ranges)


def _repack_codes(mant, ba, n_lines, n_words, sp, ranges):
    lib = _load()
    m_ = _i32(mant)
    ba_ = _i32(ba)
    nl = _i32(n_lines)
    r, total_lines = m_.shape
    if ba_.shape != (r, nl.shape[0]) or int(nl.sum()) != total_lines:
        raise ValueError("repack_codes: inconsistent shapes")
    n = _n_ranges(r, r, ranges)
    if sp is not None:
        sp.counts["threads"] = n
    words = np.zeros((r, n_words), np.uint32)
    rc = lib.wak_repack_codes_ranges(
        r, ba_.shape[1], _ptr(nl, ctypes.c_int32), total_lines,
        _ptr(ba_, ctypes.c_int32), _ptr(m_, ctypes.c_int32),
        _ptr(words, ctypes.c_uint32), n_words, n)
    if rc < 0:
        raise RuntimeError("wak_repack_codes: words buffer too small")
    return words


def unpack_file(payload: bytes, n_lines: np.ndarray, n_scale_bits: int,
                n_mant_size_bits: int, n_table_id_bits: int,
                read_lrms: bool = True, n_channels: int = 2, tables=None,
                *, _ranges=None):
    """Parse every channel-block payload in `payload` (past the header),
    through the decode trees of `tables` (init_tables; None = the shipped
    set), in ranges of whole blocks on several host threads (`_ranges`
    sets their number, for tests).

    Returns dict of arrays keyed overall/table_id/ba/sf/mant [R, ...] and
    lrms [R//n_channels, bands], plus the parsed channel-block count R.
    The span "parse" counts the payload's bytes, the threads, and lut,
    deep and escapes (the module's docstring).
    """
    with span("parse", bytes_in=len(payload)) as sp:
        return _unpack_file(payload, n_lines, n_scale_bits,
                            n_mant_size_bits, n_table_id_bits, read_lrms,
                            n_channels, tables, sp, _ranges)


def _unpack_file(payload, n_lines, n_scale_bits, n_mant_size_bits,
                 n_table_id_bits, read_lrms, n_channels, tables, sp, ranges):
    lib = _load()
    if n_table_id_bits > 0:
        init_tables(tables)
    data = np.frombuffer(payload, np.uint8)
    dp = _ptr(data, ctypes.c_uint8)
    r = int(lib.wak_count_blocks(dp, len(data)))
    if r == 0:
        raise ValueError("no channel-blocks found in payload")
    c = int(n_channels)
    n = _n_ranges(r, -(-r // c), ranges)
    if sp is not None:
        sp.counts["threads"] = n
    nl = _i32(n_lines)
    n_bands = nl.shape[0]
    total_lines = int(nl.sum())
    overall = np.zeros(r, np.int32)
    table_id = np.zeros(r, np.int32)
    ba = np.zeros((r, n_bands), np.int32)
    sf = np.zeros((r, n_bands), np.int32)
    mant = np.zeros((r, total_lines), np.int32)
    lrms = np.zeros((-(-r // c), n_bands), np.int32)
    counts = np.zeros(3, np.int64)
    rc = lib.wak_unpack_file_ranges(
        dp, len(data), r, n_bands, _ptr(nl, ctypes.c_int32), total_lines,
        n_scale_bits, n_mant_size_bits, n_table_id_bits,
        1 if read_lrms else 0, c,
        _ptr(overall, ctypes.c_int32), _ptr(table_id, ctypes.c_int32),
        _ptr(ba, ctypes.c_int32), _ptr(sf, ctypes.c_int32),
        _ptr(mant, ctypes.c_int32), _ptr(lrms, ctypes.c_int32), n,
        _ptr(counts, ctypes.c_int64))
    if sp is not None:
        sp.counts.update(lut=int(counts[0]), deep=int(counts[1]),
                         escapes=int(counts[2]))
    if rc < 0:
        raise ValueError(f"corrupt payload at channel-block {-rc - 1}")
    return dict(overall=overall, table_id=table_id, ba=ba, sf=sf,
                mant=mant, lrms=lrms, n_cblocks=r)
