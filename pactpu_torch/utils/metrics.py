"""Observability: structured per-block encode statistics, the program's
spans, stage timing, a device trace and the per-block debug dump
(pactpu.utils.metrics) on PyTorch.

The reference's observability is print statements: bits saved
(reference codec/pacfile.py:439), a `'*'` starvation warning
(codec/bitalloc.py:178) and matplotlib masking plots of block 1
(codec/psychoac.py:524-528).  Here the engine's outputs are reduced into
one `EncodeStats` object (per-block bit usage, Huffman savings, the
reservoir trajectory, stereo-coding decisions, table choice); `span`
records the program's own stages (each Engine stage, program replay and
stream push) while recording is on; `StageTimer` times host stages by the
wall clock, each stage a span; `device_trace` wraps `torch.profiler` and
writes a Chrome trace, the program's spans in it, and `idle_gaps`,
`innermost` and their kin read such a trace; `debug_block` dumps one
block's psychoacoustic and rate-control state.
"""

from __future__ import annotations

import contextlib
import dataclasses
import itertools
import json
import os
import threading
import time
from typing import Dict, Iterator, List

import numpy as np
import torch


@dataclasses.dataclass
class EncodeStats:
    """Per-block encode statistics (arrays of length n_blocks)."""

    n_blocks: int
    bits_per_channel: np.ndarray     # i64[B, C] payload bits (side info incl.)
    huffman_savings: np.ndarray      # i64[B, C] raw - coded mantissa bits
    alloc_leftover: np.ndarray       # i64[B] unspent budget after the last
    reservoir_deposit: np.ndarray    # i64[B] bitDeposit before block t
    extra_bits: np.ndarray           # i64[B] extraBits granted to block t
    ms_band_fraction: np.ndarray     # f64[B] fraction of bands coded M/S
    table_id: np.ndarray             # i8[B, C] selected Huffman table
    mant_bits_band: np.ndarray       # f64[C, n_bands] mean mantissa bits
    sample_rate: int
    n_mdct_lines: int

    def summary(self) -> Dict[str, float]:
        """Aggregate view, one flat dict (JSON-friendly)."""
        bits = self.bits_per_channel.sum()
        dur_s = self.n_blocks * self.n_mdct_lines / self.sample_rate
        tids, counts = np.unique(self.table_id, return_counts=True)
        return {
            "n_blocks": int(self.n_blocks),
            "total_payload_bits": int(bits),
            "mean_kbps": float(bits / max(dur_s, 1e-9) / 1000.0),
            "huffman_bits_saved": int(self.huffman_savings.sum()),
            "huffman_saving_pct": float(
                100.0 * self.huffman_savings.sum()
                / max(bits + self.huffman_savings.sum(), 1)),
            "mean_ms_band_fraction": float(self.ms_band_fraction.mean()),
            "reservoir_peak_bits": int(self.reservoir_deposit.max(initial=0)),
            "extra_bits_granted": int(self.extra_bits.sum()),
            "table_usage": {int(t): int(c) for t, c in zip(tids, counts)},
        }

    def to_json(self) -> str:
        return json.dumps(self.summary(), sort_keys=True)


def collect_encode_stats(out: Dict[str, np.ndarray], n_blocks: int,
                         cfg, measure=None) -> EncodeStats:
    """EncodeStats from `Engine.encode_arrays`' output.

    The device-packed output (words/nbits) carries each channel-block's
    payload bits; the host-pack output (sign/codes/lens) gives them as the
    code lengths, the signs and the side info.

    measure: (savings, leftover) of the reservoir measurement pass
    (`Engine.last_measure`), the numbers the reservoir decisions ran on;
    with it the extra_bits/deposit trajectory is an exact replay, without
    it the trajectory is derived from the final pass's savings and
    leftovers (computed with the extra bits applied), which can differ
    slightly from what was granted."""
    from pactpu_torch.codec.engine import reservoir_extras

    b, c = n_blocks, cfg.n_channels
    savings = np.asarray(out["savings"], np.int64)[:b]
    leftover = np.asarray(out["leftover"], np.int64)[:b]
    if measure is not None:
        m_savings = np.asarray(measure[0], np.int64)[:b]
        m_leftover = np.asarray(measure[1], np.int64)[:b]
    else:
        m_savings, m_leftover = savings, leftover
    lrms = np.asarray(out["lrms"])[:b]
    bits = np.asarray(out["bits"], np.int64)[:b]          # [B, C, bands]
    n_lines = np.asarray(cfg.band_layout.n_lines, np.int64)

    if "nbits" in out:
        bpc = np.asarray(out["nbits"], np.int64)[:c * b].reshape(b, c)
    else:
        lens = np.asarray(out["lens"], np.int64)[:b]      # [B, C, lines]
        side = (cfg.n_scale_bits * (cfg.n_bands + 1)
                + cfg.n_mant_size_bits * cfg.n_bands
                + cfg.n_table_id_bits + cfg.n_bands)
        signs = (bits > 0) * n_lines[None, None, :]
        bpc = lens.sum(-1) + signs.sum(-1) + side

    # the reservoir trajectory: the deposit/withdraw policy replayed over
    # the measurement pass's numbers where given (reference
    # codec/Huffman.py:353-371)
    extras, _ = reservoir_extras(m_savings, m_leftover,
                                 cfg.reservoir_withdraw_divisor)
    deposit = np.zeros(b, np.int64)
    d = 0
    for t in range(b):
        deposit[t] = d
        if d > 10:
            d -= d // cfg.reservoir_withdraw_divisor
        elif d < 0:
            d = 0
        d += int(m_savings[t].sum())

    transmit = bits > 0
    mant_mean = np.where(transmit, bits, 0).sum(0) / np.maximum(
        transmit.sum(0), 1)

    return EncodeStats(
        n_blocks=b,
        bits_per_channel=bpc,
        huffman_savings=savings,
        alloc_leftover=leftover,
        reservoir_deposit=deposit,
        extra_bits=extras,
        ms_band_fraction=lrms.mean(axis=-1).astype(np.float64),
        table_id=np.asarray(out["tid"], np.int8)[:b],
        mant_bits_band=mant_mean.astype(np.float64),
        sample_rate=cfg.sample_rate,
        n_mdct_lines=cfg.n_mdct_lines,
    )


# -- the program's spans ----------------------------------------------------
#
# One recorder for the whole port.  `span(name, **counts)` marks a stage
# of the program: an Engine stage (upload, analyze, rate, final,
# download, frame; parse, repack, compact, queue, assemble), a program's
# replay, capture or direct run ("replay:<stage>", ...), or a stream push
# and its carry read.  Recording is on inside `tracing()` and whenever a
# torch.profiler is recording; off, a span is one flag check and a shared
# null context.  On, a span records its name, start and end
# (time.perf_counter_ns), its parent (a per-thread stack: DeviceFleet
# runs an Engine a thread), its request (a root span takes a new one, its
# children inherit it), its thread and its counts, and under a profiler it
# is also a profiler range named PREFIX + name on the profiler's clock,
# beside the kernels and copies the host launched inside it.

# the profiler ranges' prefix
PREFIX = "pactpu_torch:"
# spans kept in memory; later ones are counted as dropped
MAX_SPANS = 1 << 17
# counts that give a call's width or route, not an amount of work (the
# native parse's and repack's threads; the final pass's and the repack's
# words a row; the parse's lut, 1 when it ran the word loop): totals()
# keeps the most of any call, and sums every other count
WIDTHS = frozenset({"threads", "words", "lut"})

_profiler = torch.autograd.profiler
# a profiler range of function scope: a user-scope range
# (torch.profiler.record_function) also puts a range over its kernels on
# the device's timeline, which a reader of device time would count as
# busy
_Range = torch._C._profiler._RecordFunctionFast
_depth = 0                       # tracing() contexts open
_lock = threading.Lock()
_done: List["Span"] = []
_dropped = 0
_ids = itertools.count(1)
_requests = itertools.count(1)
_local = threading.local()
_NULL = contextlib.nullcontext()


class Span:
    """One recorded span: name, start_ns and end_ns (perf_counter_ns), id,
    parent (the id of the enclosing span of its thread, None for a root),
    request (its root's request id), thread and counts (a dict, which the
    code inside the span may fill)."""

    __slots__ = ("name", "counts", "id", "parent", "request", "thread",
                 "start_ns", "end_ns", "_range")

    def __init__(self, name: str, counts: dict):
        self.name = name
        self.counts = counts
        self.end_ns = None
        self._range = None

    @property
    def ms(self) -> float:
        return (self.end_ns - self.start_ns) / 1e6

    def __enter__(self) -> "Span":
        # the profiler's range opens first and closes last, so that the
        # recorder's own work lies inside it, not between two ranges
        if _profiler._is_profiler_enabled:
            self._range = _Range(PREFIX + self.name)
            self._range.__enter__()
        stack = getattr(_local, "stack", None)
        if stack is None:
            stack = _local.stack = []
        top = stack[-1] if stack else None
        self.id = next(_ids)
        self.parent = None if top is None else top.id
        self.request = next(_requests) if top is None else top.request
        self.thread = threading.get_ident()
        stack.append(self)
        self.start_ns = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> bool:
        global _dropped
        self.end_ns = time.perf_counter_ns()
        stack = _local.stack
        if stack and stack[-1] is self:
            stack.pop()
        with _lock:
            if len(_done) < MAX_SPANS:
                _done.append(self)
            else:
                _dropped += 1
        if self._range is not None:
            self._range.__exit__(None, None, None)
            self._range = None
        return False


def span(name: str, **counts):
    """A context manager that records the stage `name` with `counts` while
    recording is on (it yields the Span, whose counts the stage may add
    to), and does nothing otherwise (it yields None: compute a count that
    costs anything only when it is not None)."""
    if not (_depth or _profiler._is_profiler_enabled):
        return _NULL
    return Span(name, counts)


@contextlib.contextmanager
def tracing() -> Iterator[None]:
    """Record the program's spans inside it (they are recorded under a
    recording torch.profiler too); nests, and holds for every thread."""
    global _depth
    with _lock:
        _depth += 1
    try:
        yield
    finally:
        with _lock:
            _depth -= 1


def spans() -> List[Span]:
    """The recorded spans, by start."""
    with _lock:
        out = list(_done)
    return sorted(out, key=lambda s: s.start_ns)


def dropped() -> int:
    """Spans not kept since the last reset (past MAX_SPANS)."""
    return _dropped


def totals(recorded=None) -> Dict[str, dict]:
    """Per span name, over the recorded spans (or `recorded`): host_s (the
    seconds they took), calls, and the sum of each of their counts (a
    pinned count sums the page-locked copies), but of WIDTHS the most of
    any call."""
    out: Dict[str, dict] = {}
    for s in spans() if recorded is None else recorded:
        t = out.setdefault(s.name, {"host_s": 0.0, "calls": 0})
        t["host_s"] += (s.end_ns - s.start_ns) / 1e9
        t["calls"] += 1
        for k, v in s.counts.items():
            t[k] = max(t.get(k, 0), v) if k in WIDTHS else t.get(k, 0) + v
    return dict(sorted(out.items()))


def reset() -> None:
    """Forget the recorded spans and the dropped count."""
    global _dropped
    with _lock:
        _done.clear()
        _dropped = 0


# -- reading a profiler trace ------------------------------------------------
#
# The program's spans in a torch.profiler trace are CPU ranges named
# PREFIX + span.  These read a trace's events (prof.events()): the
# device's operations and the runtime call that launched each, the
# device's idle gaps, and those gaps put down to the innermost range the
# host was in.  `skip` names the prefixes of other ranges that the
# profiler draws on the device's timeline over their kernels (a
# user-scope record_function's), which are no operations of the device.


def is_device_op(ev, skip=()) -> bool:
    """A kernel, copy or fill on the device (not a range drawn there)."""
    if ev.device_type.name != "CUDA":
        return False
    if getattr(ev, "is_user_annotation", False):
        return False
    return not ev.name.startswith((PREFIX, *skip))


def device_by_correlation(events, skip=()) -> Dict[int, list]:
    """The device's operations by the correlation id of the runtime call
    (cudaLaunchKernel, cudaGraphLaunch, cudaMemcpyAsync, ...) that
    launched them: a graph launch's kernels under its cudaGraphLaunch."""
    out: Dict[int, list] = {}
    for ev in events:
        if is_device_op(ev, skip):
            out.setdefault(ev.id, []).append(ev)
    return out


def host_ranges(events, prefix: str = PREFIX, thread=None) -> list:
    """The CPU ranges named prefix + span, [(start us, end us, span)], of
    one thread (the first range's where None)."""
    rs = [(ev.time_range.start, ev.time_range.end, ev.name[len(prefix):],
           ev.thread) for ev in events
          if ev.device_type.name == "CPU" and ev.name.startswith(prefix)]
    if not rs:
        return []
    if thread is None:
        thread = min(rs)[3]
    return [r[:3] for r in rs if r[3] == thread]


def innermost(ranges: list) -> list:
    """Properly nested ranges [(start, end, name)] of one thread flattened
    into [(start, end, name)] pieces, each under the innermost range."""
    out, stack, t = [], [], None
    for s, e, name in sorted(ranges, key=lambda r: (r[0], -r[1])):
        while stack and stack[-1][1] <= s:
            _, se, sn = stack.pop()
            out.append((t, se, sn))
            t = se
        if stack and t < s:
            out.append((t, s, stack[-1][2]))
        stack.append((s, e, name))
        t = s
    while stack:
        _, se, sn = stack.pop()
        out.append((t, se, sn))
        t = se
    return [p for p in out if p[1] > p[0]]


def idle_gaps(events, skip=()) -> list:
    """The device's idle intervals [(start us, end us)] between the first
    and the last of its operations."""
    ops = sorted((ev.time_range.start, ev.time_range.end) for ev in events
                 if is_device_op(ev, skip))
    gaps, end = [], None
    for s, e in ops:
        if end is not None and s > end:
            gaps.append((end, s))
        end = e if end is None else max(end, e)
    return gaps


def idle_by_range(gaps: list, pieces: list) -> Dict[str, float]:
    """Seconds of the gaps under each name of `pieces` (innermost()'s
    output), and under "outside" what no piece covers."""
    out: Dict[str, float] = {}
    j = 0
    for g0, g1 in gaps:
        covered = 0.0
        while j < len(pieces) and pieces[j][1] <= g0:
            j += 1
        k = j
        while k < len(pieces) and pieces[k][0] < g1:
            lo, hi = max(g0, pieces[k][0]), min(g1, pieces[k][1])
            if hi > lo:
                name = pieces[k][2]
                out[name] = out.get(name, 0.0) + (hi - lo) / 1e6
                covered += hi - lo
            k += 1
        out["outside"] = out.get("outside", 0.0) + (g1 - g0 - covered) / 1e6
    return out


class StageTimer:
    """Wall-clock time per named host stage; each stage is also a span
    (`span`), so that a stage and the program's spans inside it form one
    tree (for the device's own time, `device_trace`)."""

    def __init__(self):
        self.totals: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}

    @contextlib.contextmanager
    def stage(self, name: str) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            with span(name):
                yield
        finally:
            dt = time.perf_counter() - t0
            self.totals[name] = self.totals.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1

    def report(self) -> Dict[str, Dict[str, float]]:
        return {k: {"total_s": round(self.totals[k], 4),
                    "calls": self.counts[k]}
                for k in sorted(self.totals)}


@contextlib.contextmanager
def device_trace(log_dir: str, enabled: bool = True) -> Iterator[None]:
    """torch.profiler trace of a region (host, and the card's kernels where
    there is one), written as a Chrome trace `trace.json` into log_dir,
    the program's spans in it (PREFIX); nothing when disabled, so callers
    can gate on a flag."""
    if not enabled:
        yield
        return
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def debug_block(pcm: np.ndarray, block_index: int, cfg=None,
                extra_bits: float = 0.0, *,
                device="cuda") -> Dict[str, np.ndarray]:
    """The psychoacoustic and rate-control state of ONE stereo block: the
    numeric form of the reference's block-1 masking plots (reference
    codec/psychoac.py:524-658), by the engine's own analysis (window, peak
    picker and M/S rule of cfg; on the card kernel K4 in the masked
    thresholds) and its channel chain of water-fills (kernel K2).

    pcm: int16 [n, 2]; block_index counts coded blocks (0 = the first
    block, whose priorBlock is silence, as in pacfile.py:264-268).

    Returns a dict of numpy arrays, in dB at the MDCT line frequencies
    unless noted: line_freqs f64[half]; spl_lr/spl_ms f32[2, half] signal
    SPLs; bthr f32[6, half] the six masked thresholds (L, R, M, S and the
    no-drop MLD variants M', S'); thr_lr/thr_ms f32[2, half] the combined
    thresholds; mld f32[half]; smr_lr/smr_ms f32[2, bands]; lrms
    bool[bands]; smr f32[2, bands] the selected SMRs; bits i32[2, bands]
    the allocation; sf i32[2, bands] scale factors; overall i32[2];
    budget f64[]."""
    from pactpu_torch.codec import exact
    from pactpu_torch.codec.engine import (_transform, device_tables,
                                           resolve_device)
    from pactpu_torch.ops import bitalloc, psycho
    from pactpu_torch.ops import quantize as q
    from pactpu_torch.utils.config import CodecConfig

    cfg = cfg or CodecConfig()
    dev_t = resolve_device(device, "debug_block")
    dev = device_tables(cfg, dev_t)
    lay = dev["lay"]
    half = cfg.n_mdct_lines
    lo = (block_index - 1) * half
    frame = np.zeros((2, 2 * half), np.int16)
    seg = pcm[max(lo, 0):lo + 2 * half].T
    frame[:, max(-lo, 0):max(-lo, 0) + seg.shape[1]] = seg

    frames, sw, overall, scaled = _transform(
        cfg, torch.from_numpy(frame[None]).to(dev_t), dev)
    cur = psycho.stereo_curves(sw, scaled, overall, dev["psy"], lay,
                               cfg.sample_rate, cfg.peak_mode)
    max_mant = exact.max_mant(cfg)
    budget = float(cfg.bit_budget())
    if cfg.ms_decision == "bitalloc":
        # the decision the engine's analysis makes in this mode
        lrms = bitalloc.lrms_decision_bitalloc(
            cur["smr_lr"], cur["smr_ms"], lay["n_lines"], int(budget),
            max_mant, cfg.ms_stop_threshold_db, cfg.lr_stop_threshold_db)
    else:
        lrms = psycho.lrms_decision(frames, lay, cfg.ms_decision_factor)
    smr, mixed = psycho.select_coding(cur["smr_lr"], cur["smr_ms"], scaled,
                                      cur["ms_lines"], lrms, lay)

    def fill(total, ch):
        return bitalloc.water_fill(
            total, max_mant, lay["n_lines"], smr[:, ch], lrms,
            cfg.ms_stop_threshold_db, cfg.lr_stop_threshold_db)

    i32 = dict(dtype=torch.int32, device=dev_t)
    bits0, left0 = fill(torch.tensor([int(budget + extra_bits)], **i32), 0)
    bits1, _ = fill(torch.tensor([int(budget)], **i32) + left0, 1)
    bits = torch.cat([bits0, bits1])
    peak = psycho.band_max(torch.abs(mixed), lay, fill=0.0)
    sf = q.scale_factor(peak, cfg.n_scale_bits, bits[None])

    def host(t):
        return t.cpu().numpy()

    return dict(
        line_freqs=(np.arange(half) + 0.5) / half * (cfg.sample_rate / 2.0),
        spl_lr=host(cur["spl_lr"][0]), spl_ms=host(cur["spl_ms"][0]),
        bthr=host(cur["bthr"][0]), thr_lr=host(cur["thr_lr"][0]),
        thr_ms=host(cur["thr_ms"][0]), mld=host(cur["mld"]),
        smr_lr=host(cur["smr_lr"][0]), smr_ms=host(cur["smr_ms"][0]),
        lrms=host(lrms[0]), smr=host(smr[0]), bits=host(bits),
        sf=host(sf[0]), overall=host(overall[0]),
        budget=np.asarray(budget))


def encode_stats_for_file(path: str, rate_mode: str = "reservoir",
                          cfg=None, *, device="cuda") -> EncodeStats:
    """WAV path -> EncodeStats (the CLI's `stats`): the engine takes the
    file's sample rate and channel count."""
    from pactpu_torch.codec.engine import Engine
    from pactpu_torch.codec.wav import read_wav

    wav = read_wav(path)
    eng = Engine(device=device, cfg=cfg, rate_mode=rate_mode)
    eng.cfg = dataclasses.replace(eng.cfg, sample_rate=wav.sample_rate,
                                  n_channels=wav.samples.shape[1])
    out, b = eng.encode_arrays(wav.samples)
    return collect_encode_stats(out, b, eng.cfg, measure=eng.last_measure)
