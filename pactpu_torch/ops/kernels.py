"""The port's eleven hand-written Hopper kernels, their wrappers, their
plain PyTorch versions and their launch counts.

| kernel            | replaces (in pactpu/)                 | source (csrc/)   |
|-------------------|---------------------------------------|------------------|
| extract_codes     | ops/pallas_ops._extract_codes_kernel  | extract_codes.cu |
| water_fill        | ops/pallas_ops._water_fill_kernel     | water_fill.cu    |
| pack_words        | ops/pallas_ops._pack_words_kernel     | pack_words.cu    |
| pack_payload      | ops/bitpack.pack_payload_bits, whole  | pack_words.cu    |
| spread_maskers_up | ops/pallas_ops._make_spread_up_kernel | spread_up.cu     |
| huffman_walk      | ops/huffman_walk._walk_kernel         | huffman_walk.cu  |
| spread_maskers    | ops/pallas_ops._spread_kernel         | spread.cu        |
| exact_scan        | codec/exact.py:152, a lax.scan        | exact_scan.cu    |
| closed_form       | ops/bitalloc.py:241, a lax.while_loop | closed_form.cu   |
| grant_fill        | ops/bitalloc.py:458, a lax.while_loop | grant_fill.cu    |
| cost_table        | codec/exact.py:106, a lax.map         | cost_table.cu    |
| reservoir_scan    | codec/engine.py:765, a lax.scan       | reservoir_scan.cu |

water_fill, spread_maskers_up, spread_maskers, exact_scan, closed_form and
cost_table also have a float64 form (a second C function of the same
source, counted under the same name), for Engine(precision="f64").
pack_payload is K3 as the engine launches it: the whole payload pack of
pactpu.ops.bitpack.pack_payload_bits, Pallas call included; pack_words
is K3's own contract, the accumulation of pre-shifted parts.

The CUDA sources are compiled by hand with nvcc for sm_90a (one nvcc per
source, in parallel) into one shared library with a plain C interface
(csrc/kernels.h) under ``pactpu_torch/_build/`` at first use, rebuilt when
a source is newer than the library, and loaded with ctypes.  Nothing is
compiled or loaded at import time.

Each wrapper checks device, dtype, shape and contiguity and raises on
anything else.  A tensor on the CPU goes to the plain version; a tensor on
a CUDA device launches the kernel on the current stream (or raises) and
adds one to ``LAUNCHES[name]``.  There is no fallback from one to the
other.  u32 bit patterns travel as int32 tensors.
"""

from __future__ import annotations

import collections
import contextlib
import ctypes
import functools
import math
import os
import shutil
import subprocess
import threading
import time

import numpy as np
import torch

from pactpu_torch.ops import huffman
from pactpu_torch.ops import quantize as q

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
SOURCES = ("extract_codes.cu", "water_fill.cu", "pack_words.cu",
           "spread_up.cu", "huffman_walk.cu", "spread.cu", "exact_scan.cu",
           "closed_form.cu", "grant_fill.cu", "cost_table.cu",
           "reservoir_scan.cu")
# headers the sources include (a change rebuilds the library)
HEADERS = ("kernels.h", "water_fill_step.cuh")
LIB_PATH = os.path.join(BUILD_DIR, "libpactpu_kernels.so")
BUILD_LOG = os.path.join(BUILD_DIR, "kernels_build.log")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# launches of each kernel since the last reset_launches(); the plain
# versions never count
LAUNCHES = {"extract_codes": 0, "water_fill": 0, "pack_words": 0,
            "pack_payload": 0,
            "spread_maskers_up": 0, "huffman_walk": 0, "spread_maskers": 0,
            "exact_scan": 0, "closed_form": 0, "grant_fill": 0,
            "cost_table": 0, "reservoir_scan": 0}

# root peek bits of the Huffman walk's two-level LUT (huffman_walk.cu
# carries the same constant)
WALK_ROOT_BITS = 11
# K2 and K7 hold up to 32 bands a lane of their warp (past 4, the wide form
# of water_fill_step.cuh)
MAX_FILL_BANDS = 1024
# K7's Huffman tables (table id bits 4: 15 tables and the escape-only id 0)
MAX_SCAN_TABLES = 16
# the reference's key of a retired band in the arg-max (pactpu/ops/
# bitalloc.py:_NEG, a float32 constant in either precision)
_NEG = float(np.float32(-1e30))

_LOG2_10_OVER_10 = float(np.log2(10.0) / 10.0)
_MASK32 = 0xFFFFFFFF

_P, _I, _F, _D = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, \
    ctypes.c_double
_SCAN_ARGS = [_P] * 8 + [_I] * 4 + [_D, _I, _D, _D, _I, _I, _P]
_COST_ARGS = [_P] * 5 + [_I] * 9 + [_P]
# kernel name -> (C symbol in csrc/kernels.h, its argument types); every
# function ends with the stream and returns cudaGetLastError()
_C_FUNCS = {
    "extract_codes": ("pactpu_extract_codes", [_P] * 4 + [_I] * 3 + [_P]),
    "water_fill": ("pactpu_water_fill",
                   [_P] * 6 + [_I] * 3 + [_F] * 2 + [_P]),
    "pack_words": ("pactpu_pack_words", [_P] * 4 + [_I] * 3 + [_P]),
    "pack_payload": ("pactpu_pack_payload", [_P] * 12 + [_I] * 6 + [_P]),
    "spread_maskers_up": ("pactpu_spread_up", [_P] * 5 + [_I] * 3 + [_P]),
    "huffman_walk": ("pactpu_huffman_walk", [_P] * 9 + [_I] * 9 + [_P]),
    "spread_maskers": ("pactpu_spread", [_P] * 7 + [_I] * 3 + [_P]),
    "exact_scan": ("pactpu_exact_scan_valid", _SCAN_ARGS),
    "closed_form": ("pactpu_closed_form", [_P] * 4 + [_I] * 3 + [_P]),
    "grant_fill": ("pactpu_grant_fill", [_P] * 4 + [_I] * 4 + [_P]),
    "cost_table": ("pactpu_cost_table_packed", _COST_ARGS),
    "reservoir_scan": ("pactpu_reservoir_scan", [_P] * 6 + [_I] * 3 + [_P]),
}
# the float64 forms, by the kernel they count under
_C_FUNCS_F64 = {
    "water_fill": ("pactpu_water_fill_f64",
                   [_P] * 6 + [_I] * 3 + [_D] * 2 + [_P]),
    "spread_maskers_up": ("pactpu_spread_up_f64", [_P] * 5 + [_I] * 3 + [_P]),
    "spread_maskers": ("pactpu_spread_f64", [_P] * 7 + [_I] * 3 + [_P]),
    "exact_scan": ("pactpu_exact_scan_valid_f64", _SCAN_ARGS),
    "closed_form": ("pactpu_closed_form_f64", [_P] * 4 + [_I] * 3 + [_P]),
    "cost_table": ("pactpu_cost_table_packed_f64", _COST_ARGS),
}
_FLOATS = (torch.float32, torch.float64)

_lock = threading.Lock()
_lib = None
# the launches of a thread that captures a CUDA graph (captured_launches)
_capturing = threading.local()


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


@contextlib.contextmanager
def captured_launches():
    """Within: this thread's launches are counted into the Counter yielded,
    not into LAUNCHES (a CUDA graph capture launches nothing; its replays
    add them, codec/programs.py).  Other threads count into LAUNCHES as
    before."""
    _capturing.counts = counts = collections.Counter()
    try:
        yield counts
    finally:
        _capturing.counts = None


def _count(name: str) -> None:
    counts = getattr(_capturing, "counts", None)
    (LAUNCHES if counts is None else counts)[name] += 1


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ((os.path.join(home, "bin", "nvcc") if home else None),
                 shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME): the CUDA kernels "
                       "are built from source at first use")


def build(csrc_dir: str = CSRC_DIR, lib_path: str = LIB_PATH,
          log_path: str = BUILD_LOG, sources=SOURCES) -> float:
    """Compile the kernels' library if it is missing or older than a
    source: one nvcc per source, all started together, then one link.
    Returns the seconds spent (0.0 if the library was current); nvcc's
    output, ptxas register and shared-memory report included, goes to
    log_path.  The defaults are the package's own sources and library;
    tools/kernel_ab.py builds another checkout's `sources` beside it."""
    missing = [s for s in sources
               if not os.path.exists(os.path.join(csrc_dir, s))]
    if missing:
        raise FileNotFoundError(f"kernel sources missing from {csrc_dir}: "
                                + ", ".join(missing))
    deps = [os.path.join(csrc_dir, s) for s in sources]
    # (an older checkout's sources include fewer headers)
    deps += [d for d in (os.path.join(csrc_dir, h) for h in HEADERS)
             if os.path.exists(d)]
    if (os.path.exists(lib_path) and os.path.getmtime(lib_path)
            >= max(os.path.getmtime(d) for d in deps)):
        return 0.0
    build_dir = os.path.dirname(lib_path)
    os.makedirs(build_dir, exist_ok=True)
    nvcc = _nvcc()
    tag = f"{os.getpid()}.tmp"
    objs = [os.path.join(build_dir, f"{s}.{tag}.o") for s in sources]
    cmds = [[nvcc, *NVCC_FLAGS, "-c", "-o", obj, os.path.join(csrc_dir, s)]
            for s, obj in zip(sources, objs)]
    tmp = f"{lib_path}.{tag}"
    t0 = time.perf_counter()
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for cmd in cmds]
    logs = [" ".join(cmd) + "\n" + proc.communicate()[0]
            for cmd, proc in zip(cmds, procs)]
    failed = [log for log, proc in zip(logs, procs) if proc.returncode != 0]
    if not failed:
        link = [nvcc, "-shared", "-o", tmp, *objs]
        res = subprocess.run(link, capture_output=True, text=True)
        logs.append(" ".join(link) + "\n" + res.stdout + res.stderr)
        if res.returncode != 0:
            failed = logs[-1:]
    seconds = time.perf_counter() - t0
    with open(log_path, "w") as f:
        f.write("".join(logs))
    for obj in objs:
        if os.path.exists(obj):
            os.remove(obj)
    if failed:
        raise RuntimeError("nvcc failed:\n" + "".join(failed))
    os.replace(tmp, lib_path)
    return seconds


def c_symbols() -> list:
    """Every C function of the kernels' library (csrc/kernels.h)."""
    return [sym for sym, _ in (*_C_FUNCS.values(), *_C_FUNCS_F64.values())]


def bind(lib_path: str, symbols=None) -> ctypes.CDLL:
    """Load a kernels' library and declare the types of its C functions:
    all of c_symbols(), or `symbols` (tools/kernel_ab.py names those an
    older checkout's library has).  A missing one raises."""
    lib = ctypes.CDLL(lib_path)
    types = dict((*_C_FUNCS.values(), *_C_FUNCS_F64.values()))
    for symbol in c_symbols() if symbols is None else symbols:
        if not hasattr(lib, symbol):
            raise RuntimeError(f"{lib_path} lacks {symbol}: rebuild it from "
                               "the sources")
        fn = getattr(lib, symbol)
        fn.argtypes = types[symbol]
        fn.restype = ctypes.c_int
    return lib


def _load():
    global _lib
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is None:
            build()
            _lib = bind(LIB_PATH)
    return _lib


def _check(name: str, t: torch.Tensor, dtype, ndim: int,
           device: torch.device) -> None:
    """dtype: a torch dtype, or a tuple of the dtypes allowed."""
    allowed = dtype if isinstance(dtype, tuple) else (dtype,)
    if t.dtype not in allowed or t.dim() != ndim:
        raise TypeError(f"{name}: expected {dtype} with {ndim} dims, got "
                        f"{t.dtype} with shape {tuple(t.shape)}")
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def _on_cpu(device: torch.device) -> bool:
    if device.type == "cpu":
        return True
    if device.type != "cuda":
        raise ValueError(f"no kernel for device {device}")
    return False


def _launch(name: str, device: torch.device, *args,
            f64: bool = False) -> None:
    fn = getattr(_load(), (_C_FUNCS_F64 if f64 else _C_FUNCS)[name][0])
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = fn(*args, ctypes.c_void_p(stream))
    if rc != 0:
        raise RuntimeError(f"{name}: kernel launch failed with CUDA error "
                           f"{rc}")
    _count(name)


def _ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def u32_as_i32(x: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^32) -> int32 tensor of the same bit pattern."""
    return torch.where(x >= 2 ** 31, x - 2 ** 32, x).to(torch.int32)


# -- K1 extract_codes --------------------------------------------------------

def extract_codes(words: torch.Tensor, off: torch.Tensor,
                  width: torch.Tensor) -> torch.Tensor:
    """Per-line fixed-width codes from packed rows.

    words: i32[R, W] u32 bit patterns, MSB-first; off/width: i32[R, L] bit
    offset and width (0..32) of each line's field.  Returns i32[R, L]: the
    field, 0 where width is 0; words past W read as zero."""
    dev = words.device
    _check("words", words, torch.int32, 2, dev)
    _check("off", off, torch.int32, 2, dev)
    _check("width", width, torch.int32, 2, dev)
    if off.shape != width.shape or off.shape[0] != words.shape[0]:
        raise ValueError("extract_codes: shapes disagree")
    if _on_cpu(dev):
        return extract_codes_plain(words, off, width)
    rows, n_lines = off.shape
    out = torch.empty((rows, n_lines), dtype=torch.int32, device=dev)
    if out.numel():
        _launch("extract_codes", dev, _ptr(words), _ptr(off), _ptr(width),
                _ptr(out), rows, words.shape[1], n_lines)
    return out


def extract_codes_plain(words: torch.Tensor, off: torch.Tensor,
                        width: torch.Tensor) -> torch.Tensor:
    """Plain version of extract_codes (int64 arithmetic, logical shifts)."""
    rows, n_words = words.shape
    w = torch.cat([words.long() & _MASK32,
                   torch.zeros(rows, 1, dtype=torch.long,
                               device=words.device)], 1)
    o = off.long()
    wd = torch.clamp(width.long(), max=32)
    w0 = o >> 5
    sh = o & 31

    def word(i):       # out-of-row words read the zero column
        i = torch.where((i >= 0) & (i < n_words), i, n_words)
        return torch.gather(w, 1, i)

    win = ((word(w0) << sh) & _MASK32) | (word(w0 + 1) >> (32 - sh))
    return u32_as_i32(torch.where(wd > 0, win >> (32 - wd), 0))


# -- K2 water_fill -----------------------------------------------------------

def water_fill(total_bits: torch.Tensor, max_mant_bits: int,
               n_lines: torch.Tensor, smr: torch.Tensor, lrms: torch.Tensor,
               ms_stop: float = -5.0, lr_stop: float = -15.0):
    """Greedy water-filling (reference codec/bitalloc.py:129-184), the
    contract of pactpu.ops.bitalloc.water_fill.

    total_bits: i32[R]; n_lines: i32[bands]; smr: f32[R, bands] (or f64,
    then every comparison and residual is in float64); lrms: bool[R,
    bands].  Returns (bits i32[R, bands], leftover i32[R]), leftover being
    the unspent budget after the 1-bit refund.  The kernel takes up to
    MAX_FILL_BANDS bands.

    -0.0 and +0.0 tie (the first band wins).  A NaN SMR is neither checked
    for nor refused; the kernel treats it as the plain version does: the
    band counts as the largest, is granted bits until the cap or the
    budget ends it, and the stop rule never fires while it is there."""
    dev = smr.device
    _check("total_bits", total_bits, torch.int32, 1, dev)
    _check("n_lines", n_lines, torch.int32, 1, dev)
    _check("smr", smr, _FLOATS, 2, dev)
    _check("lrms", lrms, torch.bool, 2, dev)
    rows, n_bands = smr.shape
    if (lrms.shape != smr.shape or total_bits.shape[0] != rows
            or n_lines.shape[0] != n_bands):
        raise ValueError("water_fill: shapes disagree")
    if _on_cpu(dev):
        return water_fill_plain(total_bits, max_mant_bits, n_lines, smr,
                                lrms, ms_stop, lr_stop)
    if n_bands > MAX_FILL_BANDS:
        raise ValueError(f"water_fill kernel: at most {MAX_FILL_BANDS} "
                         "bands (32 a lane of one warp)")
    bits = torch.empty((rows, n_bands), dtype=torch.int32, device=dev)
    left = torch.empty(rows, dtype=torch.int32, device=dev)
    if rows:
        _launch("water_fill", dev, _ptr(total_bits), _ptr(smr), _ptr(lrms),
                _ptr(n_lines), _ptr(bits), _ptr(left), rows, n_bands,
                int(max_mant_bits), float(ms_stop), float(lr_stop),
                f64=smr.dtype == torch.float64)
    return bits, left


def water_fill_plain(total_bits, max_mant_bits, n_lines, smr, lrms,
                     ms_stop=-5.0, lr_stop=-15.0):
    """Plain version of water_fill: the XLA loop of
    pactpu/ops/bitalloc.py:66-119, one greedy step over all rows at a
    time, in smr's float type."""
    rows, n_bands = smr.shape
    dt = smr.dtype
    r = torch.arange(rows, device=smr.device)
    bits = torch.zeros((rows, n_bands), dtype=torch.int32, device=smr.device)
    valid = torch.ones((rows, n_bands), dtype=torch.bool, device=smr.device)
    total = total_bits.clone()
    # the stop thresholds in smr's type, by the candidate's M/S flag
    thresholds = torch.tensor([lr_stop, ms_stop], dtype=dt, device=smr.device)
    for _ in range(n_bands * (max_mant_bits + 1)):
        active = valid.any(1)
        if not bool(active.any()):
            break       # every later step is a no-op
        resid = smr - 6.0 * bits.to(dt)
        cand = torch.argmax(torch.where(valid, resid, _NEG), dim=1)
        global_resid = (smr - (bits - 1).to(dt) * 6.0).amax(1)
        stop_thr = thresholds[lrms[r, cand].long()]
        kill_stop = global_resid < stop_thr
        cost = n_lines[cand]
        can_pay = (total - cost) >= 0
        grant = active & can_pay
        bits[r, cand] += grant.to(torch.int32)
        total = total - torch.where(grant, cost, 0)
        hit_cap = bits[r, cand] >= max_mant_bits
        kill = active & (kill_stop | ~can_pay | (grant & hit_cap))
        valid[r, cand] = valid[r, cand] & ~kill
    ones = bits == 1
    refund = torch.where(ones, n_lines[None], 0).sum(1)
    return (torch.where(ones, 0, bits),
            (total + refund).to(torch.int32))


# -- K3 pack_words -----------------------------------------------------------

def pack_words(part0: torch.Tensor, part1: torch.Tensor, w0: torch.Tensor,
               n_words: int) -> torch.Tensor:
    """Sum item contributions into payload words.

    part0/part1: i32[R, M] u32 bit patterns; w0: i32[R, M] destination word
    of part0 (part1 goes to w0 + 1).  Returns i32[R, n_words] (u32 bit
    patterns): words[r, w] = sum mod 2^32 of part0 with w0 == w and part1
    with w0 + 1 == w; parts outside [0, n_words) are dropped."""
    dev = part0.device
    for name, t in (("part0", part0), ("part1", part1), ("w0", w0)):
        _check(name, t, torch.int32, 2, dev)
    if part1.shape != part0.shape or w0.shape != part0.shape:
        raise ValueError("pack_words: shapes disagree")
    if _on_cpu(dev):
        return pack_words_plain(part0, part1, w0, n_words)
    if n_words > 12288:
        raise ValueError("pack_words kernel: a row must fit in 48 KB")
    rows, items = part0.shape
    out = torch.empty((rows, n_words), dtype=torch.int32, device=dev)
    if out.numel():
        _launch("pack_words", dev, _ptr(part0), _ptr(part1), _ptr(w0),
                _ptr(out), rows, items, int(n_words))
    return out


def pack_words_plain(part0, part1, w0, n_words: int) -> torch.Tensor:
    """Plain version of pack_words: the scatter-add of
    pactpu/ops/bitpack.py:170-174 in int64."""
    rows = part0.shape[0]
    acc = torch.zeros((rows, n_words + 1), dtype=torch.long,
                      device=part0.device)
    for part, idx in ((part0, w0), (part1, w0 + 1)):
        idx = torch.where((idx >= 0) & (idx < n_words), idx, n_words)
        acc.scatter_add_(1, idx.long(), part.long() & _MASK32)
    return u32_as_i32(acc[:, :n_words] & _MASK32)


# pack_payload's CTA (csrc/pack_words.cu): its shared memory and the
# items its 128 threads hold in registers
PAYLOAD_SMEM_LIMIT = 48 * 1024
PAYLOAD_MAX_ITEMS = 128 * 32


def pack_payload(overall: torch.Tensor, tid: torch.Tensor, ba: torch.Tensor,
                 sf: torch.Tensor, sign: torch.Tensor, codes: torch.Tensor,
                 lens: torch.Tensor, lrms: torch.Tensor,
                 item_plan: torch.Tensor, group_plan: torch.Tensor,
                 n_words: int):
    """The whole payload pack of a batch of channel-block rows (K3 as the
    engine launches it: pactpu.ops.bitpack.pack_payload_bits).

    overall/tid: i32[R]; ba/sf/lrms: i32[R, nb]; sign/codes/lens: i32[R,
    L]; item_plan i32[M] and group_plan i32[G]: the layout's plan
    (bitpack.device_plan).  Returns (words i32[R, n_words] u32 bit
    patterns, nbits i32[R]), bit for bit those of
    bitpack.pack_payload_bits_plain on the layout the plan encodes: nbits
    is each row's full sum, past 32 * n_words too, whose words past
    n_words are dropped.  The kernel takes at most PAYLOAD_MAX_ITEMS
    items, a row whose shared memory (4 bytes times 13 + 5 nb + 3 L + 2 G
    + ceil(L / 32) + M + n_words) fits in PAYLOAD_SMEM_LIMIT, and a plan
    whose dynamic widths are those of code lines and sign groups
    (device_plan's)."""
    dev = ba.device
    for name, t in (("overall", overall), ("tid", tid),
                    ("item_plan", item_plan), ("group_plan", group_plan)):
        _check(name, t, torch.int32, 1, dev)
    for name, t in (("ba", ba), ("sf", sf), ("lrms", lrms), ("sign", sign),
                    ("codes", codes), ("lens", lens)):
        _check(name, t, torch.int32, 2, dev)
    rows, nb = ba.shape
    lines = sign.shape[1]
    if (overall.shape[0] != rows or tid.shape[0] != rows
            or sf.shape != ba.shape or lrms.shape != ba.shape
            or sign.shape[0] != rows or codes.shape != sign.shape
            or lens.shape != sign.shape):
        raise ValueError("pack_payload: shapes disagree")
    if _on_cpu(dev):
        return pack_payload_plain(overall, tid, ba, sf, sign, codes, lens,
                                  lrms, item_plan, group_plan, n_words)
    items, groups = item_plan.shape[0], group_plan.shape[0]
    if items > PAYLOAD_MAX_ITEMS:
        raise ValueError(f"pack_payload kernel: {items} items, past "
                         f"{PAYLOAD_MAX_ITEMS} (32 a thread)")
    smem = 4 * (13 + 5 * nb + 3 * lines + 2 * groups + -(-lines // 32)
                + items + int(n_words))
    if smem > PAYLOAD_SMEM_LIMIT:
        raise ValueError(f"pack_payload kernel: a row needs {smem} bytes of "
                         f"shared memory, past {PAYLOAD_SMEM_LIMIT}")
    words = torch.empty((rows, n_words), dtype=torch.int32, device=dev)
    nbits = torch.empty(rows, dtype=torch.int32, device=dev)
    if rows:
        _launch("pack_payload", dev, *(_ptr(t) for t in (
            overall, tid, ba, sf, sign, codes, lens, lrms, item_plan,
            group_plan, words, nbits)), rows, nb, lines, items, groups,
            int(n_words))
    return words, nbits


def pack_payload_plain(overall, tid, ba, sf, sign, codes, lens, lrms,
                       item_plan, group_plan, n_words: int):
    """Plain version of pack_payload: the plan decoded to pactpu's
    (bitpack.decode_device_plan), then bitpack.pack_payload_bits_plain's
    int64 arithmetic and pack_words_plain."""
    from pactpu_torch.ops import bitpack
    plan = bitpack.decode_device_plan(item_plan.cpu().numpy(),
                                      group_plan.cpu().numpy())
    p = bitpack.plan_dict(plan, ba.device)
    part0, part1, w0, nbits = bitpack.payload_parts(
        overall, tid, ba, sf, sign, codes, lens, lrms, p)
    return pack_words_plain(part0, part1, w0, n_words), nbits


# -- K4 spread_maskers_up ----------------------------------------------------

def spread_maskers_up(iprime: torch.Tensor, mspl: torch.Tensor,
                      bark: torch.Tensor, zvec: torch.Tensor) -> torch.Tensor:
    """Upslope masking-intensity accumulation over all lines.

    iprime: f32[B, K] peak-masked masker intensities (zero for non-peaks);
    mspl: f32[B, K] masker SPLs (the tonal level term); bark: f32[K] masker
    barks, zvec: f32[L] line barks, both ascending; all four f32, or all
    four f64.  Returns [B, L] in their type: sum over maskers k with
    dz = zvec[l] - bark[k] > 0.5 of
    iprime * 10^((0.367 max(mspl - 40, 0) - 27) (dz - 0.5) / 10)."""
    dev = iprime.device
    dt = iprime.dtype if iprime.dtype in _FLOATS else torch.float32
    _check("iprime", iprime, dt, 2, dev)
    _check("mspl", mspl, dt, 2, dev)
    _check("bark", bark, dt, 1, dev)
    _check("zvec", zvec, dt, 1, dev)
    if mspl.shape != iprime.shape or bark.shape[0] != iprime.shape[1]:
        raise ValueError("spread_maskers_up: shapes disagree")
    if _on_cpu(dev):
        return spread_maskers_up_plain(iprime, mspl, bark, zvec)
    rows, k = iprime.shape
    if k > 4096:
        raise ValueError("spread_maskers_up kernel: at most 4096 maskers")
    out = torch.empty((rows, zvec.shape[0]), dtype=dt, device=dev)
    if out.numel():
        _launch("spread_maskers_up", dev, _ptr(iprime), _ptr(mspl),
                _ptr(bark), _ptr(zvec), _ptr(out), rows, k, zvec.shape[0],
                f64=dt == torch.float64)
    return out


def spread_maskers_up_plain(iprime, mspl, bark, zvec) -> torch.Tensor:
    """Plain version of spread_maskers_up, row by row over the row's own
    peaks (the maskers where iprime is nonzero: the others add exactly
    zero).  A row's value so depends on that row alone, as the kernel's
    does: a sum over the union of several rows' peaks would round by the
    union."""
    dz = zvec[None, :] - bark[:, None]                   # [K, L]
    on = dz > 0.5
    up = torch.where(on, dz - 0.5, 0.0)
    lev = 0.367 * torch.clamp(mspl - 40.0, min=0.0)
    out = torch.zeros((iprime.shape[0], zvec.shape[0]), dtype=iprime.dtype,
                      device=iprime.device)
    for r in range(iprime.shape[0]):
        cols = torch.nonzero(iprime[r]).squeeze(1)
        if cols.numel() == 0:
            continue
        e = torch.exp2(_LOG2_10_OVER_10 * (lev[r, cols, None] - 27.0)
                       * up[cols])
        out[r] = torch.where(on[cols], iprime[r, cols, None] * e,
                             0.0).sum(0)
    return out


# -- K5 huffman_walk ---------------------------------------------------------

def _walk_check(words, lut, n_lines, n_scale_bits, n_mant_size_bits,
                n_table_id_bits) -> None:
    dev = words.device
    _check("words", words, torch.int32, 2, dev)
    for name in ("l1", "l1b", "l2"):
        _check(name, lut[name], torch.int32, 2, dev)
    if (lut["l1"].shape[1] != 1 << WALK_ROOT_BITS
            or lut["l1b"].shape[1] != 128
            or not lut["l1"].shape[0] == lut["l1b"].shape[0]
            == lut["l2"].shape[0]):
        raise ValueError("huffman_walk: LUT shapes disagree")
    if any(int(n) < 0 for n in n_lines):
        raise ValueError("huffman_walk: negative band line count")
    # basf carries ba_raw and sf in 8 bits each; ba = ba_raw + 1 <= 32
    if (not 0 <= n_mant_size_bits <= 5 or not 0 <= n_scale_bits <= 8
            or not 0 <= n_table_id_bits <= 16):
        raise ValueError("huffman_walk: n_mant_size_bits <= 5, n_scale_bits "
                         "<= 8, n_table_id_bits <= 16")


def huffman_walk(words: torch.Tensor, lut: dict, n_lines,
                 n_scale_bits: int, n_mant_size_bits: int,
                 n_table_id_bits: int):
    """The serial Huffman bit-walk of a batch of channel-block rows.

    words: i32[R, W] u32 bit patterns, MSB-first (words past W read as
    zero); lut: the two-level LUT of pactpu_torch.ops.huffman_walk.
    device_walk_lut (l1 i32[T, 2048], l1b i32[T, 128], l2 i32[T, P]);
    n_lines: the band layout's line counts (a sequence of ints).  Per row:
    read overall and the table id; per band read ba (stored minus one) and
    sf, record the offset of the band's sign bits and skip them if the
    band is active; per line of an active band decode one code through the
    LUT (an escape is followed by the raw ba-bit mantissa).

    Returns (code i32[R, lines] decoded unsigned values, 0 on inactive
    lines; basf i32[R, bands] = ba_raw | sf << 8; soff i32[R, bands];
    misc i32[R, 5] = overall, tid as read, bad (tid outside [1, T] or a
    zero-length code on an active line), LRMS bit offset, end offset)."""
    _walk_check(words, lut, n_lines, n_scale_bits, n_mant_size_bits,
                n_table_id_bits)
    dev = words.device
    if _on_cpu(dev):
        return huffman_walk_plain(words, lut, n_lines, n_scale_bits,
                                  n_mant_size_bits, n_table_id_bits)
    if any(lut[k].data_ptr() % 16 for k in ("l1", "l1b")):
        raise ValueError("huffman_walk kernel: the LUT's tables must be "
                         "16-byte aligned (it copies them 16 bytes at a time)")
    rows, n_bands = words.shape[0], len(n_lines)
    total = int(sum(n_lines))
    code = torch.empty((rows, total), dtype=torch.int32, device=dev)
    basf = torch.empty((rows, n_bands), dtype=torch.int32, device=dev)
    soff = torch.empty((rows, n_bands), dtype=torch.int32, device=dev)
    misc = torch.empty((rows, 5), dtype=torch.int32, device=dev)
    if rows:
        bands = _band_tensor(tuple(int(n) for n in n_lines), dev)
        _launch("huffman_walk", dev, _ptr(words), _ptr(lut["l1"]),
                _ptr(lut["l1b"]), _ptr(lut["l2"]), _ptr(bands), _ptr(code),
                _ptr(basf), _ptr(soff), _ptr(misc), rows, words.shape[1],
                n_bands, total, lut["l1"].shape[0], lut["l2"].shape[1],
                int(n_scale_bits), int(n_mant_size_bits),
                int(n_table_id_bits))
    return code, basf, soff, misc


# unbounded: a captured CUDA graph reads it by address (codec/programs.py)
@functools.lru_cache(maxsize=None)
def _band_tensor(n_lines: tuple, device: torch.device) -> torch.Tensor:
    """The band layout's line counts as an int32 tensor on the device (K5
    stages it in shared memory), uploaded once a layout and device."""
    return torch.tensor(n_lines, dtype=torch.int32, device=device)


def huffman_walk_plain(words, lut, n_lines, n_scale_bits: int,
                       n_mant_size_bits: int, n_table_id_bits: int):
    """Plain version of huffman_walk: all rows walk in lockstep, one step
    per line, in int64.  A band that no row allocates bits to moves no
    cursor and is skipped."""
    _walk_check(words, lut, n_lines, n_scale_bits, n_mant_size_bits,
                n_table_id_bits)
    dev = words.device
    rows, n_w = words.shape
    bands = [int(n) for n in n_lines]
    w = torch.cat([words.long() & _MASK32,
                   torch.zeros(rows, 1, dtype=torch.long, device=dev)], 1)
    l1, l1b, l2 = (lut[k].long() & _MASK32 for k in ("l1", "l1b", "l2"))
    n_tab = l1.shape[0]

    def word(i):        # out-of-row words read the zero column
        i = torch.where((i >= 0) & (i < n_w), i, n_w)
        return torch.gather(w, 1, i[:, None])[:, 0]

    def peek(off):      # the 32 bits at bit offset off, MSB-aligned
        w0, sh = off >> 5, off & 31
        return ((word(w0) << sh) & _MASK32) | (word(w0 + 1) >> (32 - sh))

    def read(off, n: int):
        return peek(off) >> (32 - n) if n > 0 else torch.zeros_like(off), \
            off + n

    off = torch.zeros(rows, dtype=torch.long, device=dev)
    overall, off = read(off, n_scale_bits)
    tid, off = read(off, n_table_id_bits)
    t = torch.clamp(tid, 1, n_tab) - 1
    bad = tid != t + 1
    code = torch.zeros((rows, sum(bands)), dtype=torch.long, device=dev)
    basf = torch.zeros((rows, len(bands)), dtype=torch.long, device=dev)
    soff = torch.zeros_like(basf)
    line = 0
    for b, nl in enumerate(bands):
        ba_raw, off = read(off, n_mant_size_bits)
        sf, off = read(off, n_scale_bits)
        basf[:, b] = ba_raw | (sf << 8)
        soff[:, b] = off
        ba = torch.where(ba_raw > 0, ba_raw + 1, 0)              # Q6
        active = ba > 0
        off = off + torch.where(active, nl, 0)                   # sign bits
        if rows and bool(active.any()):
            for i in range(nl):
                pk = peek(off)
                e1 = l1[t, pk >> (32 - WALK_ROOT_BITS)]
                b2 = l1b[t, e1 & 0x7F]
                tail = ((pk << WALK_ROOT_BITS) & _MASK32) >> (32 - (b2 & 15))
                e = torch.where(e1 >= 2 ** 31, l2[t, (b2 >> 4) + tail], e1)
                ln = e & 31
                esc = (e & 0x20) > 0
                raw = peek(off + ln) >> (32 - ba)
                val = torch.where(esc, raw, (e >> 6) & 0x7FFF)
                code[:, line + i] = torch.where(active, val, 0)
                bad = bad | (active & (ln == 0))
                off = off + torch.where(active,
                                        ln + torch.where(esc, ba, 0), 0)
        line += nl
    misc = torch.stack([overall, tid, bad.long(), off, off + len(bands)], 1)
    return tuple(u32_as_i32(a & _MASK32) for a in (code, basf, soff, misc))


# -- K6 spread_maskers -------------------------------------------------------

def spread_maskers(mspl: torch.Tensor, lev: torch.Tensor, bark: torch.Tensor,
                   valid: torch.Tensor, drop_db: torch.Tensor,
                   zvec: torch.Tensor) -> torch.Tensor:
    """Masking-intensity accumulation over compacted masker slots, both
    slopes of the spreading function.

    mspl/lev/bark/valid: f32[B, K] slot SPL, upslope coefficient times
    max(SPL - 40, 0), bark and 0/1 validity; drop_db: f32[B] tonal drop;
    zvec: f32[L] line barks; all six float32, or all six float64.  Returns
    [B, L] in their type: the sum over valid slots of
    10^((mspl - drop - 27 on + [dz >= 0] lev on - 96) / 10) with
    dz = zvec[l] - bark and on = max(|dz| - 0.5, 0)."""
    dev = mspl.device
    dt = mspl.dtype if mspl.dtype in _FLOATS else torch.float32
    for name, a in (("mspl", mspl), ("lev", lev), ("bark", bark),
                    ("valid", valid)):
        _check(name, a, dt, 2, dev)
    _check("drop_db", drop_db, dt, 1, dev)
    _check("zvec", zvec, dt, 1, dev)
    if (not mspl.shape == lev.shape == bark.shape == valid.shape
            or drop_db.shape[0] != mspl.shape[0]):
        raise ValueError("spread_maskers: shapes disagree")
    if _on_cpu(dev):
        return spread_maskers_plain(mspl, lev, bark, valid, drop_db, zvec)
    rows, k = mspl.shape
    if k > 4096:
        raise ValueError("spread_maskers kernel: at most 4096 slots")
    out = torch.empty((rows, zvec.shape[0]), dtype=dt, device=dev)
    if out.numel():
        _launch("spread_maskers", dev, _ptr(mspl), _ptr(lev), _ptr(bark),
                _ptr(valid), _ptr(drop_db), _ptr(zvec), _ptr(out), rows, k,
                zvec.shape[0], f64=dt == torch.float64)
    return out


def spread_maskers_plain(mspl, lev, bark, valid, drop_db, zvec,
                         chunk: int = 16) -> torch.Tensor:
    """Plain version of spread_maskers: the one_chunk expression of
    pactpu/ops/psycho.py:286-295, `chunk` rows at a time (a dense [B, K, L]
    intermediate would be 6.5 GB at B = 3072, K = 513), in mspl's type."""
    out = torch.empty((mspl.shape[0], zvec.shape[0]), dtype=mspl.dtype,
                      device=mspl.device)
    for s in range(0, mspl.shape[0], chunk):
        c = slice(s, s + chunk)
        dz = zvec[None, None, :] - bark[c, :, None]          # [c, K, L]
        adz = torch.abs(dz)
        on = torch.where(adz > 0.5, adz - 0.5, 0.0)
        s_db = (mspl[c, :, None] - drop_db[c, None, None] - 27.0 * on
                + torch.where(dz >= 0.0, lev[c, :, None] * on, 0.0))
        contrib = torch.exp2(_LOG2_10_OVER_10 * (s_db - 96.0)) \
            * valid[c, :, None]
        out[c] = contrib.sum(1)
    return out


# -- K7 exact_scan -----------------------------------------------------------

def _scan_check(smr, lrms, cost, valid, n_lines, carry) -> torch.Tensor:
    """The checked arguments of exact_scan; returns valid as a bool
    tensor (a count of valid blocks becomes the prefix mask, made on the
    device from the count, no upload)."""
    dev = smr.device
    _check("smr", smr, _FLOATS, 3, dev)
    b, c, n_bands = smr.shape
    if not torch.is_tensor(valid):
        valid = torch.arange(b, device=dev) < int(valid)
    _check("lrms", lrms, torch.bool, 2, dev)
    _check("cost", cost, torch.int32, 5, dev)
    _check("valid", valid, torch.bool, 1, dev)
    _check("n_lines", n_lines, torch.int32, 1, dev)
    _check("carry", carry, torch.int32, 1, dev)
    if (lrms.shape != (b, n_bands) or cost.shape[:3] != (b, c, n_bands)
            or cost.shape[3] != 17 or valid.shape[0] != b
            or n_lines.shape[0] != n_bands or carry.shape[0] != 2
            or c not in (1, 2)):
        raise ValueError("exact_scan: shapes disagree")
    return valid


def exact_scan(smr: torch.Tensor, lrms: torch.Tensor, cost: torch.Tensor,
               valid, carry: torch.Tensor, budget: float,
               n_lines: torch.Tensor, max_mant_bits: int, ms_stop: float,
               lr_stop: float, tid_bits: int, divisor: int):
    """The exact serial bit reservoir over a chunk's blocks (pactpu/codec/
    exact.py:extras_scan_body, reference codec/Huffman.py:353-371,
    codec/codec.py:229, 258-260).

    smr: f32[B, C, bands] (or f64: the fills and the total's sum then run
    in float64); lrms: bool[B, bands]; cost: i32[B, C, bands, 17, T], the
    Huffman bits of each band at each allocation under each table
    (pactpu_torch.codec.exact.cost_table); valid: bool[B], the chunk's
    real blocks, a prefix (pactpu's valid mask: the blocks from its first
    False on are padding and leave the carry alone), which the kernel
    reads on the device, or the count of valid blocks; carry: i32[2]
    (bitDeposit, extraBits) on the device.  Per block: the
    withdrawal, channel 0's extra bits, the water-fill of each channel with
    total = int(budget + extra) in smr's type, channel k's leftover funding
    channel k + 1, and the deposit of every channel's Huffman savings.
    Returns (extras i32[B]: channel 0's extra bits, 0 past the valid
    prefix; carry' i32[2]), both on the device, with no host round trip:
    nothing of it is a host value that a chunk's contents decide, so one
    CUDA graph replays it for every chunk of a size."""
    valid = _scan_check(smr, lrms, cost, valid, n_lines, carry)
    dev = smr.device
    b, c, n_bands = smr.shape
    if _on_cpu(dev):
        return exact_scan_plain(smr, lrms, cost, valid, carry, budget,
                                n_lines, max_mant_bits, ms_stop, lr_stop,
                                tid_bits, divisor)
    if n_bands > MAX_FILL_BANDS or cost.shape[4] > MAX_SCAN_TABLES:
        raise ValueError(f"exact_scan kernel: at most {MAX_FILL_BANDS} "
                         f"bands and {MAX_SCAN_TABLES} tables")
    if int(divisor) <= 0:
        raise ValueError("exact_scan: the withdrawal divisor must be > 0")
    extras = torch.empty(b, dtype=torch.int32, device=dev)
    carry_out = torch.empty(2, dtype=torch.int32, device=dev)
    _launch("exact_scan", dev, _ptr(smr), _ptr(lrms), _ptr(valid),
            _ptr(cost), _ptr(n_lines), _ptr(carry), _ptr(carry_out),
            _ptr(extras), b, c, n_bands, cost.shape[4], float(budget),
            int(max_mant_bits), float(ms_stop), float(lr_stop),
            int(tid_bits), int(divisor), f64=smr.dtype == torch.float64)
    return extras, carry_out


def _row_tables(smr: torch.Tensor, max_mant_bits: int, ms_stop: float,
                lr_stop: float):
    """A row's residuals smr - 6 k and statistics smr - 6 (k - 1), k up
    to max_mant_bits + 1, computed by torch in smr's type as
    water_fill_plain computes them, as lists of Python floats; the stop
    thresholds (L/R, M/S) in that type; and the functions that read a
    band's residual and statistic past the tables (a band the dead key
    chose)."""
    dt = smr.dtype
    width = max_mant_bits + 2
    k = torch.arange(width, device=smr.device).to(dt)
    resid_tab = (smr[:, None] - 6.0 * k[None]).tolist()
    stat_tab = (smr[:, None] - (k[None] - 1.0) * 6.0).tolist()
    thr = torch.tensor([lr_stop, ms_stop], dtype=dt).tolist()

    def resid(b, nb):
        if nb < width:
            return resid_tab[b][nb]
        return float(smr[b] - 6.0 * torch.tensor(nb, dtype=dt))

    def stat(b, nb):
        if nb < width:
            return stat_tab[b][nb]
        return float(smr[b] - torch.tensor(nb - 1, dtype=dt) * 6.0)

    return resid_tab, thr, resid, stat


def _greedy_step(row: dict, max_mant_bits: int, n_lines: list, ms: list,
                 thr: list, resid, stat) -> None:
    """One greedy step of water_fill_row_plain on row = {bits, valid,
    total}, in place: the first band of largest residual (retired bands
    at _NEG, NaN above all) takes a bit if the budget pays for it, and
    leaves the running if it could not pay, reached the cap or the stop
    rule fired (the largest statistic below its threshold)."""
    bits, valid = row["bits"], row["valid"]
    cand, best = 0, None
    for b in range(len(bits)):
        v = resid(b, bits[b]) if valid[b] else _NEG
        if math.isnan(v):
            cand = b
            break
        if best is None or v > best:
            cand, best = b, v
    now = [stat(b, nb) for b, nb in enumerate(bits)]
    g = math.nan if any(map(math.isnan, now)) else max(now)
    kill_stop = g < thr[1 if ms[cand] else 0]
    can_pay = row["total"] - n_lines[cand] >= 0
    if can_pay:
        bits[cand] += 1
        row["total"] -= n_lines[cand]
    if kill_stop or not can_pay or bits[cand] >= max_mant_bits:
        valid[cand] = False


def _refund(row: dict, n_lines: list):
    """The 1-bit bands' bits back (the reference never codes 1-bit
    mantissas): (bits, leftover)."""
    refund = sum(nl for nb, nl in zip(row["bits"], n_lines) if nb == 1)
    return ([0 if nb == 1 else nb for nb in row["bits"]],
            row["total"] + refund)


def water_fill_row_plain(total: int, max_mant_bits: int, n_lines: list,
                         smr: torch.Tensor, ms: list, ms_stop: float,
                         lr_stop: float, stats: dict = None):
    """water_fill_plain on ONE row, its greedy steps a Python loop: the
    same float values (every residual smr - 6 bits and statistic
    smr - 6 (bits - 1) computed by torch in smr's type, as water_fill_plain
    computes them, then compared exactly as Python floats), the same
    arg-max (the first of the largest, NaN above all) and the same stop
    rule, without a tensor operation a step.  total: int; n_lines: list of
    ints; smr: [bands]; ms: list of bools.  Returns (bits list of ints,
    leftover int); adds the steps taken to stats["steps"] if given."""
    n = smr.shape[0]
    _, thr, resid, stat = _row_tables(smr, max_mant_bits, ms_stop, lr_stop)
    row = dict(bits=[0] * n, valid=[True] * n, total=total)
    for _ in range(n * (max_mant_bits + 1)):
        if not any(row["valid"]):
            break               # every later step is a no-op
        if stats is not None:
            stats["steps"] += 1
        _greedy_step(row, max_mant_bits, n_lines, ms, thr, resid, stat)
    return _refund(row, n_lines)


# K7's jumps (csrc/exact_scan.cu carries the same constants): bisection
# probes, and how far below its lower bound a jump's search starts
JUMP_PROBES = 6
JUMP_FLOOR_DB = 12.0


def water_fill_row_jump_plain(total: int, max_mant_bits: int,
                              n_lines: list, smr: torch.Tensor, ms: list,
                              ms_stop: float, lr_stop: float,
                              stats: dict = None):
    """water_fill_row_plain's result by K7's shorter chain: jumps over the
    prefixes of greedy grants that nothing unforeseen can interrupt, and
    greedy steps between them.

    The greedy grants follow the order of (key desc, band index asc) over
    every band's keys smr - 6 k, from its bits up to its top, so the
    grants of keys above a level L are a prefix of them.  A band's top is
    the cap, or its bits + 1 once the stop statistic g (the largest over
    all bands of smr - 6 (bits - 1)) is below the band's own threshold:
    g never grows, so the step that next picks the band grants it (if
    the budget pays) and stops it.  Within the prefix nothing but the
    tops retires a band if (1) g after it stays at or above the highest
    threshold of the bands still below their cap (then none of them
    stops in it), (2) L > _NEG, the retired bands' key, and (3) its lines
    fit the budget (each step's leftover is at least the prefix's).  All
    three are monotone in L: a jump takes the lowest level it finds that
    passes them, that bound (the threshold of (1), or the lowest key left
    if every band has its top) less JUMP_FLOOR_DB if it passes, else the
    best of JUMP_PROBES bisections between it and the highest key left.
    Then a band the leftover can no longer pay for leaves the running (its
    one step would have retired it without a grant).  The steps go on
    until g falls below a threshold it was not below at the last jump,
    and the next jump starts there.  A row with a NaN SMR, or keys that
    reach down to _NEG, takes the greedy steps alone.  stats: adds the
    steps walked one at a time ("steps"), the grants of the jumps
    ("jumped") and the jumps' probes ("probes")."""
    n = smr.shape[0]
    cap = max_mant_bits
    dt = smr.dtype
    resid_tab, thr, resid, stat = _row_tables(smr, max_mant_bits, ms_stop,
                                              lr_stop)
    row = dict(bits=[0] * n, valid=[True] * n, total=total)
    bits, valid = row["bits"], row["valid"]
    iters = n * (cap + 1)
    if not (n > 0 and cap > 0 and all(
            not math.isnan(r[0]) and r[cap - 1] > _NEG for r in resid_tab)):
        for _ in range(iters):
            if not any(valid):
                break
            if stats is not None:
                stats["steps"] += 1
            _greedy_step(row, cap, n_lines, ms, thr, resid, stat)
        return _refund(row, n_lines)
    thr_of = [thr[1] if ms[b] else thr[0] for b in range(n)]

    def in_dt(v):
        return torch.tensor(v, dtype=dt)

    def g_now():
        return max(stat(b, nb) for b, nb in enumerate(bits))

    def jump():
        g = g_now()
        top = [min(cap, bits[b] + 1) if g < thr_of[b] else cap
               for b in range(n)]
        free = [thr_of[b] for b in range(n) if valid[b] and g >= thr_of[b]]
        need = max(free) if free else None
        keys = [resid_tab[b][k] for b in range(n) if valid[b]
                for k in range(bits[b], top[b])]
        if not keys:
            return

        def counts(level):
            return [sum(1 for k in range(bits[b], top[b])
                        if resid_tab[b][k] > level) if valid[b] else 0
                    for b in range(n)]

        def feasible(level):
            c = counts(level)
            return (sum(ci * n_lines[b] for b, ci in enumerate(c))
                    <= row["total"] and
                    (need is None or max(stat(b, bits[b] + c[b])
                                         for b in range(n)) >= need))

        lo = float(torch.maximum(in_dt(_NEG), in_dt(
            need if need is not None else min(keys)) - in_dt(JUMP_FLOOR_DB)))
        hi = max(keys)
        probes = 0
        if not feasible(lo):        # hi always passes: no grant
            for _ in range(JUMP_PROBES):
                mid = float(in_dt(lo) + (in_dt(hi) - in_dt(lo)) * 0.5)
                probes += 1
                if feasible(mid):
                    hi = mid
                else:
                    lo = mid
            lo = hi
        grants = counts(lo)
        for b, c in enumerate(grants):
            bits[b] += c
            row["total"] -= c * n_lines[b]
            valid[b] = valid[b] and bits[b] < top[b]
        for b in range(n):
            if valid[b] and n_lines[b] > row["total"]:
                valid[b] = False
        if stats is not None:
            stats["jumped"] = stats.get("jumped", 0) + sum(grants)
            stats["probes"] = stats.get("probes", 0) + probes

    def quiet():
        g = g_now()
        return g < thr[0], g < thr[1]

    jump()
    last = quiet()
    for _ in range(iters):
        if not any(valid):
            break
        if quiet() != last:         # g fell below another threshold
            jump()
            last = quiet()
            if not any(valid):
                break
        if stats is not None:
            stats["steps"] += 1
        _greedy_step(row, cap, n_lines, ms, thr, resid, stat)
    return _refund(row, n_lines)


def exact_scan_plain(smr, lrms, cost, valid, carry, budget: float,
                     n_lines, max_mant_bits: int, ms_stop: float,
                     lr_stop: float, tid_bits: int, divisor: int,
                     stats: dict = None, jump: bool = True):
    """Plain version of exact_scan: the lax.scan step of pactpu/codec/
    exact.py:152-175 as a loop over the blocks on the host, each channel's
    fill by water_fill_row_jump_plain as the kernel fills (jump=False:
    water_fill_row_plain, the greedy steps alone; the same result), total
    = int(budget + extra) by torch in smr's type, over the prefix of
    valid (bool[B] or a count; the blocks from its first False on are
    padding, as the kernel reads it).  stats: a dict whose
    "steps" and "fills" it adds to (the steps walked one at a time, the
    greedy steps of the chain with jump=False; the fills), and with the
    jump "jumped" and "probes"."""
    valid = _scan_check(smr, lrms, cost, valid, n_lines, carry)
    dt = smr.dtype
    b, c, n_bands = smr.shape
    n_valid = int(torch.cumprod(valid.cpu().long(), 0).sum())
    smr_h, lrms_h = smr.cpu(), lrms.cpu().tolist()
    cost_h = cost.cpu()
    budget_t = torch.tensor(budget, dtype=dt)
    nl = [int(n) for n in n_lines.cpu()]
    bands = torch.arange(n_bands)
    extras = [0] * b
    deposit, extra = (int(v) for v in carry.cpu())
    fill = water_fill_row_jump_plain if jump else water_fill_row_plain
    for t in range(n_valid):
        take = ((deposit // divisor if deposit > 10 else 0)
                + (deposit if deposit < 0 else 0))
        granted = extra + take
        chain, savings = granted, 0
        for ch in range(c):
            total = int((budget_t + torch.tensor(chain, dtype=torch.int32)
                         .to(dt)).to(torch.int32))          # truncates
            bits, chain = fill(total, max_mant_bits, nl, smr_h[t, ch],
                               lrms_h[t], ms_stop, lr_stop, stats)
            if stats is not None:
                stats["fills"] += 1
            band_cost = cost_h[t, ch][bands, torch.tensor(bits)]  # [bands, T]
            huff_best = int(band_cost.long().sum(0).min())
            raw = sum(nb * n for nb, n in zip(bits, nl))
            n_signs = sum(n for nb, n in zip(bits, nl) if nb > 0)
            savings += raw - (huff_best + n_signs + tid_bits)
        extras[t] = granted
        deposit = deposit - take + savings
        extra = chain
    return (torch.tensor(extras, dtype=torch.int32, device=smr.device),
            torch.tensor([deposit, extra], dtype=torch.int32,
                         device=smr.device))


# -- K8 closed_form ----------------------------------------------------------

# running sums of XLA's CPU dot (csrc/closed_form.cu)
_DOT_LANES = 8


def _alloc_check(name: str, budget, vals, n_lines, dtypes) -> None:
    dev = vals.device
    _check("budget", budget, torch.int32, 1, dev)
    _check("n_lines", n_lines, torch.int32, 1, dev)
    _check(name, vals, dtypes, 2, dev)
    if budget.shape[0] != vals.shape[0] or n_lines.shape[0] != vals.shape[1]:
        raise ValueError(f"{name}: shapes disagree")


def closed_form(budget: torch.Tensor, smr: torch.Tensor,
                n_lines: torch.Tensor, max_mant_bits: int) -> torch.Tensor:
    """kai's closed-form allocation (pactpu.ops.bitalloc.alloc_closed_form,
    reference baselines/kai/bitalloc.py:84-134): the init of
    closed_form_r, then the take-back loop, in one launch.

    budget: i32[R]; smr: f32[R, bands] (or f64: the init's arithmetic and
    the adjusted SMRs are then float64); n_lines: i32[bands].  Returns bits
    i32[R, bands].  The kernel takes up to MAX_FILL_BANDS bands."""
    _alloc_check("smr", budget, smr, n_lines, _FLOATS)
    dev = smr.device
    if _on_cpu(dev):
        return closed_form_plain(budget, smr, n_lines, max_mant_bits)
    rows, n_bands = smr.shape
    if n_bands > MAX_FILL_BANDS:
        raise ValueError(f"closed_form kernel: at most {MAX_FILL_BANDS} bands")
    bits = torch.empty((rows, n_bands), dtype=torch.int32, device=dev)
    if bits.numel():
        _launch("closed_form", dev, _ptr(budget), _ptr(smr), _ptr(n_lines),
                _ptr(bits), rows, n_bands, int(max_mant_bits),
                f64=smr.dtype == torch.float64)
    return bits


def closed_form_r(budget: torch.Tensor, smr: torch.Tensor,
                  n_lines: torch.Tensor) -> torch.Tensor:
    """The closed-form init's real-valued allocation r [R, bands] in smr's
    type, with the arithmetic of pactpu's engine (the band layout a
    constant under jit): avg = XLA's CPU dot of smr and n_lines (eight
    running fused multiply-adds over the bands j = i mod 8 of the whole
    octets, summed in adjacent pairs, plus the rest fused one by one into a
    second sum) times 1/sum(n_lines); r = fma(smr - avg, 1/6,
    budget * (1/sum(n_lines))).  This is XLA's float32 order at the row
    counts the engine's chunks give; its float64 order is another, so in
    float64 r can sit an ulp from pactpu's."""
    dt = smr.dtype
    rows, n_bands = smr.shape
    nl = n_lines.to(dt)
    octets = n_bands // _DOT_LANES * _DOT_LANES
    acc = torch.zeros((rows, _DOT_LANES), dtype=dt, device=smr.device)
    for j in range(0, octets, _DOT_LANES):
        acc = q.fma(smr[:, j:j + _DOT_LANES], nl[j:j + _DOT_LANES], acc)
    while acc.shape[1] > 1:
        acc = acc[:, 0::2] + acc[:, 1::2]
    tail = torch.zeros(rows, dtype=dt, device=smr.device)
    for j in range(octets, n_bands):
        tail = q.fma(smr[:, j], nl[j], tail)
    one = torch.ones((), dtype=dt, device=smr.device)
    inv_lines = one / nl.sum()
    avg = (acc[:, 0] + tail) * inv_lines
    return q.fma(smr - avg[:, None], one / 6.0,
                 (budget.to(dt) * inv_lines)[:, None])


def closed_form_plain(budget, smr, n_lines, max_mant_bits: int,
                      stats: dict = None) -> torch.Tensor:
    """Plain version of closed_form: closed_form_r gated (< 2 -> 0, NaN ->
    0), capped and floored, then takeback_plain."""
    r = closed_form_r(budget, smr, n_lines)
    cap = torch.floor(torch.clamp(r, max=float(max_mant_bits)))
    bits = torch.where(torch.isnan(r) | (r < 2.0), 0.0, cap).to(torch.int32)
    return takeback_plain(bits, budget, n_lines, smr, max_mant_bits, stats)


def takeback_plain(bits0, budget, n_lines, smr, max_mant_bits: int,
                   stats: dict = None) -> torch.Tensor:
    """The take-back loop of pactpu/ops/bitalloc.py:183-243 from any bits0
    i32[R, bands], one trip over all rows at a time, each row stopping once
    it spends less than its budget (a later trip only retires a band), at
    most bands x (max_mant_bits + 1) trips.  The arg-min takes the first
    NaN, else the first of the least.  stats: a dict whose "steps" (trips
    of every row) and "max_steps" (the longest row's) it sets."""
    rows, n_bands = smr.shape
    bits = bits0.to(torch.int32).clone()
    nl = n_lines.long()
    total = (bits.long() * nl).sum(1)
    bud = budget.long()
    m = smr.clone()
    live = torch.ones((rows, n_bands), dtype=torch.bool, device=smr.device)
    row = torch.arange(rows, device=smr.device)
    trips = torch.zeros(rows, dtype=torch.long, device=smr.device)
    for _ in range(n_bands * (max_mant_bits + 1)):
        act = live.any(1) & (total >= bud)
        if not bool(act.any()):
            break
        trips += act
        key = torch.where(live, m, float("inf"))
        nan = torch.isnan(key)
        cand = torch.where(nan.any(1), nan.to(torch.int8).argmax(1),
                           key.argmin(1))
        cur = bits[row, cand]
        dec = torch.clamp(cur - 1, min=0)
        dec = torch.where(dec == 1, 0, dec)
        new = torch.where(act, dec, cur)
        bits[row, cand] = new
        total = total - (cur - new).long() * nl[cand]
        m[row, cand] = torch.where(act, m[row, cand] + 6.0, m[row, cand])
        live[row, cand] = live[row, cand] & ~(act & (new == 0))
    if stats is not None:
        stats["steps"] = int(trips.sum())
        stats["max_steps"] = int(trips.max()) if rows else 0
    return bits


# -- K9 grant_fill -----------------------------------------------------------

def grant_fill(total: torch.Tensor, level: torch.Tensor,
               n_lines: torch.Tensor, max_mant_bits: int,
               max_steps: int) -> torch.Tensor:
    """The constant-SNR/MNR grant walk (pactpu.ops.bitalloc.
    _greedy_noise_floor_batch, reference codec/bitalloc.py:60-125) with the
    reference's `remaining > 0` guard (ROADMAP queue 3, fault (b)).

    total: i32[R]; level: f32[R, bands] (float32 in every precision, as
    pactpu casts it); n_lines: i32[bands]; max_steps: the walk's cap
    (bitalloc._legacy_iter_bound).  Returns bits i32[R, bands] after the
    1-bit floor.  The kernel takes up to MAX_FILL_BANDS bands; it walks
    each row as grant_fill_jump_plain does (one jump over the grants
    nothing can interrupt, then steps), with grant_fill_plain's result."""
    _alloc_check("level", total, level, n_lines, torch.float32)
    dev = level.device
    if _on_cpu(dev):
        return grant_fill_plain(total, level, n_lines, max_mant_bits,
                                max_steps)
    rows, n_bands = level.shape
    if n_bands > MAX_FILL_BANDS:
        raise ValueError(f"grant_fill kernel: at most {MAX_FILL_BANDS} bands")
    bits = torch.empty((rows, n_bands), dtype=torch.int32, device=dev)
    if bits.numel():
        _launch("grant_fill", dev, _ptr(total), _ptr(level), _ptr(n_lines),
                _ptr(bits), rows, n_bands, int(max_mant_bits),
                max(0, min(int(max_steps), 2 ** 31 - 1)))
    return bits


def grant_fill_plain(total, level, n_lines, max_mant_bits: int,
                     max_steps: int, stats: dict = None) -> torch.Tensor:
    """Plain version of grant_fill: the XLA loop of pactpu/ops/bitalloc.py:
    417-462 with the `remaining > 0` guard, one step over all rows at a
    time.  The arg-max takes the first NaN, else the first of the largest
    (the bands that cannot be granted at -inf); a row whose arg-max cannot
    be granted changes nothing then or later, and stops.  stats: a dict
    whose "steps" (grants of every row) and "max_steps" (the most grants
    of a row) it sets."""
    rows, n_bands = level.shape
    dev = level.device
    alloc = torch.zeros((rows, n_bands), dtype=torch.int32, device=dev)
    rem = total.long()
    lev = level.clone()
    nl = n_lines.long()
    row = torch.arange(rows, device=dev)
    stalled = torch.zeros(rows, dtype=torch.bool, device=dev)
    grants = torch.zeros(rows, dtype=torch.long, device=dev)
    for _ in range(int(max_steps)):
        can = ((alloc < max_mant_bits) & (rem[:, None] >= nl[None])
               & (rem[:, None] > 0))
        act = can.any(1) & ~stalled
        if not bool(act.any()):
            break
        key = torch.where(can, lev, float("-inf"))
        nan = torch.isnan(key)
        cand = torch.where(nan.any(1), nan.to(torch.int8).argmax(1),
                           key.argmax(1))
        ok = act & can[row, cand]
        stalled = stalled | (act & ~ok)
        grants += ok
        alloc[row, cand] += ok.to(torch.int32)
        rem = rem - torch.where(ok, nl[cand], 0)
        lev[row, cand] = torch.where(ok, lev[row, cand] - 6.0,
                                     lev[row, cand])
    if stats is not None:
        stats["steps"] = int(grants.sum())
        stats["max_steps"] = int(grants.max()) if rows else 0
    return torch.where(alloc < 2, 0, torch.clamp(alloc, max=max_mant_bits))


# K9's jump (csrc/grant_fill.cu's kProbes, held equal by
# tests/test_torch_grant_jump.py): bisection probes after the first
GRANT_PROBES = 8
_SIX = np.float32(6.0)


def _grant_argmax(lev: list, can: list) -> int:
    """The first NaN among the grantable bands' levels, else the first of
    the largest (the others read -inf), as grant_fill_plain's arg-max."""
    key = [lev[b] if can[b] else -math.inf for b in range(len(lev))]
    nan = [b for b, k in enumerate(key) if math.isnan(k)]
    if nan:
        return nan[0]
    best = 0
    for b, k in enumerate(key):
        if k > key[best]:
            best = b
    return best


def _grant_row_jump(total: int, lev: list, nl: list, max_mant_bits: int,
                    max_steps: int, stats: dict) -> list:
    """One row of grant_fill_jump_plain: its allocation before the floor."""
    n = len(lev)
    mm = max_mant_bits
    alloc = [0] * n
    row = dict(rem=total, grants=0, walked=0)

    def payable(b):
        return alloc[b] < mm and row["rem"] >= nl[b] and row["rem"] > 0

    def keys(b):         # band b's keys from its allocation to the cap
        out, k = [], lev[b]
        for _ in range(alloc[b], mm):
            out.append(k)
            k = np.float32(k - _SIX)
        return out

    def jump():
        pay = [b for b in range(n) if payable(b)]
        if not pay:
            return
        ks = {b: keys(b) for b in pay}

        def counts(level):
            return {b: sum(1 for k in ks[b] if k > level) for b in pay}

        def feasible(level):
            c = counts(level)
            cost = sum(c[b] * nl[b] for b in pay)
            free = sum(c[b] for b in pay if nl[b] == 0)
            return (sum(c.values()) <= max_steps - row["grants"] and
                    (cost < row["rem"] or (cost == row["rem"] and not free)))

        hi = max(lev[b] for b in pay)
        lo = np.float32(min(ks[b][-1] for b in pay) - _SIX)
        probes = 1
        if not feasible(lo):        # hi always passes: no grant
            for _ in range(GRANT_PROBES):
                mid = np.float32(lo + np.float32(np.float32(hi - lo)
                                                 * np.float32(0.5)))
                probes += 1
                if feasible(mid):
                    hi = mid
                else:
                    lo = mid
            lo = hi
        c = counts(lo)
        for b in pay:
            for _ in range(c[b]):
                lev[b] = np.float32(lev[b] - _SIX)
            alloc[b] += c[b]
            row["rem"] -= c[b] * nl[b]
        row["grants"] += sum(c.values())
        stats["jumped"] += sum(c.values())
        stats["probes"] += probes

    if max_steps > 0 and all(math.isfinite(x) for x in lev):
        jump()
    while row["grants"] < max_steps:
        can = [payable(b) for b in range(n)]
        if not any(can):
            break
        cand = _grant_argmax(lev, can)
        if not can[cand]:
            break                   # a fixed point: nothing changes again
        alloc[cand] += 1
        row["rem"] -= nl[cand]
        lev[cand] = np.float32(lev[cand] - _SIX)
        row["grants"] += 1
        row["walked"] += 1
    stats["steps"] += row["walked"]
    stats["max_walked"] = max(stats["max_walked"], row["walked"])
    return alloc


def grant_fill_jump_plain(total, level, n_lines, max_mant_bits: int,
                          max_steps: int, stats: dict = None) -> torch.Tensor:
    """grant_fill_plain's result by K9's shorter walk, row by row: one jump
    over the grants that nothing can interrupt, then greedy steps.

    The grants follow the order of (level desc, band index asc) over every
    band's keys lev, lev - 6, ..., each subtraction rounded in float32, up
    to max_mant_bits keys a band, and only the budget interrupts them: a
    band leaves once it can no longer be paid for (remaining only falls),
    or at its cap.  So the grants of the keys above a level L, over the
    bands that can be paid for now, happen (in some order) if together
    their lines fit the budget, with something left or no zero-line band
    among them (the `remaining > 0` guard before each), and their count
    fits the steps left of max_steps.  All three are monotone in L: the
    jump takes every key if that passes, else the lowest of GRANT_PROBES
    bisections between the lowest key and the highest that passes (the
    highest key always does: no grant).  A row with a NaN or an infinite
    level takes the steps alone.  stats: adds the grants walked one at a
    time ("steps"), the grants of the jumps ("jumped") and the jumps'
    feasibility tests ("probes"), and keeps the most steps walked in a row
    ("max_walked")."""
    rows, n_bands = level.shape
    stats = {} if stats is None else stats
    for k in ("steps", "jumped", "probes", "max_walked"):
        stats.setdefault(k, 0)
    lev = level.detach().cpu().numpy().astype(np.float32) + np.float32(0.0)
    tot = [int(t) for t in total.cpu()]
    nl = [int(n) for n in n_lines.cpu()]
    out = np.zeros((rows, n_bands), np.int32)
    for r in range(rows):
        out[r] = _grant_row_jump(tot[r], list(lev[r]), nl,
                                 int(max_mant_bits), int(max_steps), stats)
    out = np.where(out < 2, 0, np.minimum(out, max_mant_bits))
    return torch.from_numpy(out.astype(np.int32)).to(level.device)


# -- K10 cost_table ----------------------------------------------------------

# allocations 0..16 of the exact mode's cost table
N_ALLOCS = 17
# K10's limits: 1,024 lines a block (32 a lane), 16 tables, allocations up
# to 16 with r = allocation + largest scale factor <= 31
MAX_COST_LINES = 1024


def _cost_check(mixed, lay, tab_lens, esc_len) -> None:
    dev = mixed.device
    _check("mixed", mixed, _FLOATS, 3, dev)
    _check("n_lines", lay["n_lines"], torch.int32, 1, dev)
    _check("tab_lens", tab_lens, torch.int32, 2, dev)
    _check("esc_len", esc_len, torch.int32, 1, dev)
    if esc_len.shape[0] != tab_lens.shape[0] or tab_lens.shape[1] < 1:
        raise ValueError("cost_table: table shapes disagree")


# unbounded: a captured CUDA graph reads it by address (codec/programs.py)
@functools.lru_cache(maxsize=None)
def _exp2_ks(device: torch.device, dtype: torch.dtype, largest: int,
             max_mant_bits: int) -> torch.Tensor:
    """quantize.exp2i(k) for k in [-largest - 1, largest + max_mant_bits]
    on `device`: every 2^k the cost table's quantizers read, computed by
    the function the final pass uses."""
    k = torch.arange(-largest - 1, largest + max_mant_bits + 1,
                     dtype=torch.int32, device=device)
    return q.exp2i(k, dtype).contiguous()


# K10's packed table set (csrc/cost_table.cu): 5 bits a length, six
# lengths a word, then the escape flags (word 1 from bit 20 up to 10 tables,
# else word 3 from bit 0)
_PACK_NARROW_TABLES = 10
_PACK_FIELD_BITS = 5
_PACK_MAX_LEN = (1 << _PACK_FIELD_BITS) - 1


def pack_tables(tab_lens: torch.Tensor, esc_len: torch.Tensor):
    """K10's packed table set: (packed i32[rows, W], n_pack).

    n_pack is the symbols up to the last one any table codes; packed holds
    one entry each, then one of escapes in every table, which the kernel
    reads for every later symbol (rows: n_pack + 1, rounded up to an even
    count for W = 2, so that the set is a whole number of 16-byte units).
    Entry s: table t's length at word t // 6, bit 5 (t % 6), its escape
    length where it has no code, and its escape flag at bit t of the flag
    word (word 1 from bit 20 for W = 2, word 3 for W = 4).  Lengths and
    escape lengths above 31 bits are refused (the codec's limit,
    huffman_train.build_table).  One host sync (n_pack)."""
    n_tab, n_sym = tab_lens.shape
    if n_tab > MAX_SCAN_TABLES:
        raise ValueError(f"pack_tables: at most {MAX_SCAN_TABLES} tables")
    if bool(((tab_lens < 0) | (tab_lens > _PACK_MAX_LEN)).any()
            | ((esc_len < 0) | (esc_len > _PACK_MAX_LEN)).any()):
        raise ValueError("pack_tables: code and escape lengths must be "
                         f"0..{_PACK_MAX_LEN} bits")
    coded = (tab_lens > 0).any(0).nonzero()
    n_pack = int(coded.max()) + 1 if coded.numel() else 0
    w = 2 if n_tab <= _PACK_NARROW_TABLES else 4
    dev = tab_lens.device
    lens = tab_lens[:, :n_pack].long()
    esc = esc_len.long()[:, None]
    length = torch.cat([torch.where(lens > 0, lens, esc), esc], 1)
    flag = torch.cat([(lens == 0).long(), torch.ones_like(esc)], 1)
    rows = n_pack + 1
    rows += rows % 2 if w == 2 else 0
    words = torch.zeros((rows, w), dtype=torch.long, device=dev)
    flag_word, flag_bit = (1, 20) if w == 2 else (3, 0)
    for t in range(n_tab):
        words[:n_pack + 1, t // 6] |= length[t] << (
            _PACK_FIELD_BITS * (t % 6))
        words[:n_pack + 1, flag_word] |= flag[t] << (flag_bit + t)
    return words.to(torch.int32).contiguous(), n_pack


def cost_table(mixed: torch.Tensor, lay: dict, tab_lens: torch.Tensor,
               esc_len: torch.Tensor, n_scale_bits: int,
               max_mant_bits: int, packed=None) -> torch.Tensor:
    """Huffman bits of every band at every allocation under every table
    (pactpu/codec/exact.py:cost_table_body): mixed f32[B, C, half] (or
    f64) -> i32[B, C, bands, 17, T], allocation 0 and those past
    max_mant_bits all zeros.  lay: psycho.layout_tensors (the kernel reads
    its n_lines, the plain version its gather tables); tab_lens i32[T, S]
    and esc_len i32[T]: the Huffman code lengths (0 = no code: the
    escape's length + the allocation) and escape lengths.  A symbol past S
    reads the table's last entry.  The kernel reads the table set packed:
    packed is pack_tables(tab_lens, esc_len), made once by the owner of
    the table set (exact.packed_tables); None packs it on this call."""
    _cost_check(mixed, lay, tab_lens, esc_len)
    dev = mixed.device
    if _on_cpu(dev):
        return cost_table_plain(mixed, lay, tab_lens, esc_len, n_scale_bits,
                                max_mant_bits)
    b, c, half = mixed.shape
    n_bands = lay["n_lines"].shape[0]
    n_tab, n_sym = tab_lens.shape
    largest = (1 << n_scale_bits) - 1
    if (half > MAX_COST_LINES or n_tab > MAX_SCAN_TABLES
            or n_bands > MAX_FILL_BANDS or not 1 <= max_mant_bits < N_ALLOCS
            or largest + max_mant_bits > 31):
        raise ValueError(
            f"cost_table kernel: at most {MAX_COST_LINES} lines, "
            f"{MAX_SCAN_TABLES} tables, {MAX_FILL_BANDS} bands and "
            "allocations 1..16 with allocation + largest scale <= 31")
    packed, n_pack = packed or pack_tables(tab_lens, esc_len)
    if (packed.device != dev or packed.dtype != torch.int32 or packed.shape[1]
            != (2 if n_tab <= _PACK_NARROW_TABLES else 4)):
        raise ValueError("cost_table: packed is not this table set's")
    exp2 = _exp2_ks(dev, mixed.dtype, largest, int(max_mant_bits))
    out = torch.empty((b, c, n_bands, N_ALLOCS, n_tab), dtype=torch.int32,
                      device=dev)
    if out.numel():
        _launch("cost_table", dev, _ptr(mixed), _ptr(lay["n_lines"]),
                _ptr(packed), _ptr(exp2), _ptr(out), b * c, half, n_bands,
                n_tab, n_sym, n_pack, packed.shape[0], int(n_scale_bits),
                int(max_mant_bits), f64=mixed.dtype == torch.float64)
    return out


def cost_table_plain(mixed, lay, tab_lens, esc_len, n_scale_bits: int,
                     max_mant_bits: int) -> torch.Tensor:
    """Plain version of cost_table, integer-equal to pactpu's
    cost_table_body.  Exact because a band's scale factor depends only on
    its peak and its allocation (reference codec/codec.py:269-278).  Per
    allocation a: the scale factors and BFP mantissas of every line at a
    bits, each line's code length in each table (or that table's escape
    length + a), and the band sums as differences of an int32 running sum
    over the lines (the bands are consecutive runs of lines)."""
    n_tab, n_sym = tab_lens.shape
    b, c, _ = mixed.shape
    n_bands = lay["n_lines"].shape[0]
    hi = torch.cumsum(lay["n_lines"].long(), 0)
    lo = hi - lay["n_lines"].long()
    # psycho.band_max(|mixed|, lay, fill=0.0)
    peak = torch.where(lay["band_empty"], 0.0,
                       torch.abs(mixed)[..., lay["band_lines"]].amax(-1))
    out = torch.zeros((b, c, n_bands, N_ALLOCS, n_tab), dtype=torch.int32,
                      device=mixed.device)
    zero = torch.zeros((n_tab, b, c, 1), dtype=torch.int32,
                       device=mixed.device)
    for a in range(1, max_mant_bits + 1):
        # a fill on the device: a host scalar copied up would wait for it
        a_t = torch.full((), a, dtype=torch.int32, device=mixed.device)
        sf = q.scale_factor(peak, n_scale_bits, a_t)
        mant = q.bfp_mantissa(mixed, sf[..., lay["seg"]], n_scale_bits, a_t)
        _, unsigned = huffman.split_sign(mant, a_t)
        lens = tab_lens[:, torch.clamp(unsigned.long(), max=n_sym - 1)]
        lens = torch.where(lens > 0, lens, esc_len[:, None, None, None] + a)
        run = torch.cat([zero, torch.cumsum(lens, -1, dtype=torch.int32)], -1)
        sums = run[..., hi] - run[..., lo]                # [T, B, C, bands]
        out[:, :, :, a] = sums.permute(1, 2, 3, 0)
    return out


# -- K11 reservoir_scan ------------------------------------------------------

def _wrap32(v: int) -> int:
    """v modulo 2^32 as a signed 32-bit value."""
    return (v + 2 ** 31) % 2 ** 32 - 2 ** 31


def _reservoir_check(savings, leftover, valid, carry, divisor):
    """The checked arguments of reservoir_scan, valid as a bool tensor."""
    dev = savings.device
    if not torch.is_tensor(valid):
        valid = torch.arange(savings.shape[0], device=dev) < int(valid)
    _check("savings", savings, torch.int32, 2, dev)
    _check("leftover", leftover, torch.int32, 1, dev)
    _check("valid", valid, torch.bool, 1, dev)
    _check("carry", carry, torch.int32, 1, dev)
    b = savings.shape[0]
    if leftover.shape[0] != b or valid.shape[0] != b or carry.shape[0] != 2:
        raise ValueError("reservoir_scan: shapes disagree")
    if int(divisor) <= 0:
        raise ValueError("reservoir_scan: the withdrawal divisor must be > 0")
    return valid


def reservoir_scan(savings: torch.Tensor, leftover: torch.Tensor, valid,
                   carry: torch.Tensor, divisor: int):
    """The reference reservoir policy over a chunk's measured blocks
    (pactpu/codec/engine.py:765 _reservoir_scan_fn; reference
    codec/Huffman.py:353-371, codec/codec.py:229, 258-260).

    savings: i32[B, C] each channel's Huffman savings of the measurement
    pass; leftover: i32[B] its allocation leftover; valid: bool[B], or the
    count of valid blocks (a prefix); carry: i32[2] (bitDeposit,
    extraBits) on the device.  Per valid block: withdraw deposit //
    divisor when the deposit is above 10, fold a negative deposit into the
    extra bits, grant them to channel 0, then deposit the block's savings
    and carry its leftover; an invalid block is a no-op granted 0.  The
    arithmetic is int32 and wraps, as pactpu's scan.  Returns (extras
    f32[B], carry' i32[2]), both on the device, with no host round
    trip."""
    valid = _reservoir_check(savings, leftover, valid, carry, divisor)
    dev = savings.device
    if _on_cpu(dev):
        return reservoir_scan_plain(savings, leftover, valid, carry, divisor)
    b, c = savings.shape
    extras = torch.empty(b, dtype=torch.float32, device=dev)
    carry_out = torch.empty(2, dtype=torch.int32, device=dev)
    _launch("reservoir_scan", dev, _ptr(savings), _ptr(leftover),
            _ptr(valid), _ptr(carry), _ptr(carry_out), _ptr(extras), b, c,
            int(divisor))
    return extras, carry_out


def reservoir_scan_plain(savings, leftover, valid, carry, divisor: int):
    """Plain version of reservoir_scan: pactpu's scan step as a loop over
    the blocks on the host, int32 wrapping made explicit; the results on
    the inputs' device."""
    valid = _reservoir_check(savings, leftover, valid, carry, divisor)
    divisor = int(divisor)
    sav = savings.long().sum(1).tolist()
    left, ok = leftover.tolist(), valid.tolist()
    deposit, extra = carry.tolist()
    granted = [0] * len(sav)
    for t, (s, l, v) in enumerate(zip(sav, left, ok)):
        w = deposit // divisor if deposit > 10 else 0
        neg = deposit < 0
        g = _wrap32(extra + w + (deposit if neg else 0))
        kept = deposit - w if deposit > 10 else (0 if neg else deposit)
        if v:
            deposit, extra, granted[t] = _wrap32(kept + s), l, g
    dev = savings.device
    return (torch.tensor(granted, dtype=torch.int32, device=dev).to(
                torch.float32),
            torch.tensor([deposit, extra], dtype=torch.int32, device=dev))
