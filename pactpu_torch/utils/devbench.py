"""Device-compute throughput: blocks/s of the codec's device programs
(pactpu.utils.devbench) on PyTorch.

The serving figures (the Engine's encode and decode) include the host:
dispatch of a few hundred small operations a chunk, the native parse, the
downloads.  This module measures what the card sustains on the compute
alone, stage by stage, on one device-resident chunk: the analysis, the
reservoir measurement pass, the reservoir scan (kernel K11), the final
pass, the dense compaction, and the decode chunk program by the
host-parse and the device-parse route, under pactpu's stage names.

Method.  pactpu repeats a stage `iters` times inside one XLA program (a
`fori_loop`), so that no dispatch latency enters the figure.  PyTorch has
no such program: a stage is a few hundred launches.  Here each stage is
captured once in a CUDA graph (whose replay is one launch, checked to give
the stage's own outputs), and the card is first given a spin
(`torch.cuda._sleep`) long enough for the host to queue n replays behind
it: the time between two CUDA events around them is device time alone.
The spin is sized from a timed enqueue and doubled (up to three times)
until the event after it is still pending when the last replay is
queued.  Per stage, `graph` says whether it ran as a graph (a stage that
cannot be captured is queued launch by launch, as the Engine runs it) and
`spin_covered` whether the spin outlasted the queueing (where it did not,
the card waited for the host, and the stage's time holds host time).  As
in pactpu, two trip counts are timed (min of 3 each) and the slope is the
time a repetition: the constant costs cancel.  On device="cpu" (an Engine
on the CPU, asked for explicitly) the same slope is taken by the host
clock.

The Engine runs the reservoir policy on the device, as pactpu does
(`reservoir_scan`, K11 on the chunk's measurements).  The host replay
that the cluster's ranges still run (engine.reservoir_extras, a Python
loop over blocks) is timed by the host clock under
`reservoir_replay_host_ms` and is not part of `stage_ms` or the encode
chain.

FLOPs.  XLA's cost analysis has no counterpart here; each stage's GEMM
FLOPs are counted from its shapes (gemm_flops): the MDCT basis product
and the masking product (`nonup`, the reference peak picker's dense path)
in the analysis, the inverse MDCT in both decode routes.  The count leaves
out the FFTs (the psychoacoustic spectra, the L/R-vs-M/S decision), the
custom kernels (the masking sums K4 and K6, the allocation K2, the packing
K3, the walk K5, the field extraction K1) and the elementwise operations.
MFU is against the float32 peak of an NVIDIA H100 SXM (the codec runs its
GEMMs in full float32, engine._full_fp32, not TF32): a run on another card
states its name beside the figure, and a CPU run reports none.
"""

from __future__ import annotations

import time
from typing import Callable, Optional

import numpy as np
import torch
from torch.utils._pytree import tree_leaves

# NVIDIA H100 SXM data sheet: float32 FLOP/s outside the tensor cores, at
# the full 700 W power limit
PEAK_F32_FLOPS = 67e12
PEAK_OF = "NVIDIA H100 SXM data sheet, float32 without tensor cores, 700 W"


def gemm_flops(cfg, blocks: int) -> dict:
    """GEMM FLOPs of each stage for a chunk of `blocks` blocks of cfg:
    analyze = the MDCT (frames [B, C, 2N] times the basis [2N, N]) and,
    with the reference peak picker, the masking product (R rows of masker
    intensities [R, N] times `nonup` [N, N]; R = 6 B in stereo, the six
    threshold inputs of a block, B in mono); decode and
    decode_device_parse = the inverse MDCT ([B, C, N] times [N, 2N]);
    the other stages none."""
    n, c = cfg.n_mdct_lines, cfg.n_channels
    mdct = 2 * blocks * c * (2 * n) * n
    rows = (6 if c == 2 else 1) * blocks
    masking = 2 * rows * n * n if cfg.peak_mode == "ref" else 0
    imdct = 2 * blocks * c * n * (2 * n)
    return dict(analyze=mdct + masking, measure=0, reservoir_scan=0,
                finalize=0, compact=0, decode=imdct,
                decode_device_parse=imdct)


def _cycles_per_s(device) -> float:
    """The spin's rate: torch.cuda._sleep cycles per second of the card."""
    cycles = 20_000_000
    torch.cuda._sleep(cycles)                     # warm
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    torch.cuda._sleep(cycles)
    b.record()
    b.synchronize()
    return cycles / (a.elapsed_time(b) / 1e3)


def _device_time(stage: Callable, n: int, rate: float, enqueue_s: float):
    """Seconds of device time of n repetitions of stage, queued behind a
    spin sized from enqueue_s (the host's time to queue one repetition),
    and whether the spin outlasted the queueing."""
    spin_s = 1.5 * enqueue_s * n + 1e-3
    for _ in range(4):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(int(spin_s * rate))
        a.record()
        for _ in range(n):
            stage()
        covered = not a.query()
        b.record()
        b.synchronize()
        if covered:
            break
        spin_s *= 2
    return a.elapsed_time(b) / 1e3, covered


def _tensors(out) -> list:
    """The tensors of a stage's output (a pytree of tensors and others)."""
    return [t for t in tree_leaves(out) if torch.is_tensor(t)]


def _graphed(stage: Callable, device: torch.device) -> Optional[Callable]:
    """stage captured in a CUDA graph (programs.Program.build: warmed on a
    side stream first, as torch.cuda.graph asks), as its replay, or None
    where it cannot be captured or its replay does not give the stage's
    own outputs."""
    from pactpu_torch.codec import programs
    try:
        prog, _ = programs.Program.build("devbench", stage, (), device)
    except programs.CaptureError:
        return None
    prog.replay()
    static, want = _tensors(prog.static_out), _tensors(stage())
    if len(want) != len(static) or not all(
            torch.equal(a, b) for a, b in zip(static, want)):
        return None
    return prog.replay


def _time_loop(stage: Callable, iters: int, device: torch.device,
               rate: Optional[float]):
    """(seconds a repetition of stage, as a CUDA graph, spin covered): the
    slope between n_lo and n_lo + iters repetitions, min of 3 timings
    each, retried on a non-positive slope (device time of the stage's
    graph, or launches, on a CUDA device; the host clock on the CPU)."""
    stage()                                       # warm
    cuda = device.type == "cuda"
    covered, replay = True, None
    if cuda:
        replay = _graphed(stage, device)
        stage = replay or stage
        torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        stage()
        enqueue_s = time.perf_counter() - t0
        torch.cuda.synchronize(device)

    def timed(n):
        nonlocal covered
        if cuda:
            secs, ok = _device_time(stage, n, rate, enqueue_s)
            covered = covered and ok
            return secs
        t0 = time.perf_counter()
        for _ in range(n):
            stage()
        return time.perf_counter() - t0

    n_lo = max(2, iters // 4)
    for _ in range(3):
        t_lo = min(timed(n_lo) for _ in range(3))
        t_hi = min(timed(n_lo + iters) for _ in range(3))
        if t_hi > t_lo:
            break
    return max(t_hi - t_lo, 1e-9) / iters, replay is not None, covered


def _chunk_pcm(pcm: Optional[np.ndarray], blocks: int, cfg) -> np.ndarray:
    """pactpu's input: `pcm` cropped or tiled to exactly `blocks` coded
    blocks ((blocks - 1) * N samples), or without it a seeded 440 Hz tone
    with noise."""
    half, c = cfg.n_mdct_lines, cfg.n_channels
    n = (blocks - 1) * half                  # b = n_blocks + 1 == blocks
    if pcm is None:
        rng = np.random.default_rng(0)
        t = np.arange(n) / cfg.sample_rate
        sig = 0.5 * np.sin(2 * np.pi * 440 * t) + 0.1 * rng.standard_normal(n)
        return np.clip(np.stack([sig] * c, 1) * 24000,
                       -32768, 32767).astype(np.int16)
    if pcm.shape[0] < n:
        pcm = np.tile(pcm, (-(-n // pcm.shape[0]), 1))
    return np.ascontiguousarray(pcm[:n])


def device_stages(pcm: np.ndarray, blocks: int, eng) -> tuple:
    """The stages measure_device_compute times, on one device-resident
    chunk of `blocks` blocks of pcm (already cut to that length): a dict
    of name -> callable (analyze, measure, reservoir_scan, finalize,
    compact, decode and, where the stream takes it, decode_device_parse),
    and the host reservoir replay's inputs (savings, leftover,
    divisor)."""
    from pactpu_torch.codec import engine as E
    from pactpu_torch.codec.header import read_header
    from pactpu_torch.ops import bitpack, kernels

    cfg, device = eng.cfg, eng.device
    half, c = cfg.n_mdct_lines, cfg.n_channels
    # the chain of Engine._encode_chunks on one device-resident chunk: the
    # frames in the Engine's layout, then each stage on the last's output
    glob = np.zeros((c, (blocks + 1) * half), np.int16)
    glob[:, half:half + pcm.shape[0]] = pcm.T
    frames = E._overlap_frames(torch.from_numpy(glob).to(device), half)
    dev = eng.consts()
    pack_words, dense = E.pack_widths(cfg)
    if not eng.device_pack:
        pack_words = 0
    zeros = torch.zeros(blocks, device=device)
    a_dev = E.analyze(cfg, frames, dev)
    m_dev = E.finalize(cfg, a_dev, zeros, dev, measure_only=True)
    divisor = cfg.reservoir_withdraw_divisor
    valid = torch.ones(blocks, dtype=torch.bool, device=device)
    carry0 = torch.zeros(2, dtype=torch.int32, device=device)
    extras, _ = kernels.reservoir_scan(m_dev["savings"], m_dev["leftover"],
                                       valid, carry0, divisor)
    out_dev = E.finalize(cfg, a_dev, extras, dev, pack_words=pack_words)
    sav = m_dev["savings"].cpu().numpy()
    left = m_dev["leftover"].cpu().numpy()

    stages = {
        "analyze": lambda: E.analyze(cfg, frames, dev),
        "measure": lambda: E.finalize(cfg, a_dev, zeros, dev,
                                      measure_only=True),
        "reservoir_scan": lambda: kernels.reservoir_scan(
            m_dev["savings"], m_dev["leftover"], valid, carry0, divisor),
        "finalize": lambda: E.finalize(cfg, a_dev, extras, dev,
                                       pack_words=pack_words),
    }
    if "words" in out_dev:
        cap = blocks * c * dense
        stages["compact"] = lambda: bitpack.compact_rows(
            out_dev["words"], out_dev["nbits"], cap)

    # the decode chunk programs of both routes, on uploaded arguments,
    # staged launch by launch (the chunk's stage function itself: this
    # module's own graph cannot capture the replay of the Engine's program)
    stream = eng.encode(pcm)
    scfg, _, off = read_header(stream)
    programmed, eng.use_programs = eng.use_programs, False
    try:
        staged = {"decode": eng._decode_staging_host_parse(stream, off,
                                                           scfg)}
        try:
            E._check_device_parse(scfg)
            routed = eng._decode_staging_device_parse(stream, off, scfg)
        except ValueError:
            routed = None         # a stream the device parse does not take
    finally:
        eng.use_programs = programmed
    if routed is not None:
        staged["decode_device_parse"] = routed
    carry = torch.zeros((c, half), dtype=dev["basis"].dtype, device=device)
    for name, st in staged.items():
        if st["b"] != blocks or len(st["chunk_args"]) != 1:
            raise ValueError(f"{name}: the stream is not one {blocks}-block "
                             "chunk (Engine.chunk_blocks too small)")
        args = [eng._upload(x) for x in st["chunk_args"][0]]
        stages[name] = (lambda run, args: lambda: run(*args, carry))(
            st["run"], args)
    return stages, (sav, left, divisor)


def measure_device_compute(pcm: Optional[np.ndarray] = None,
                           blocks: int = 512, iters: int = 20,
                           eng=None) -> dict:
    """Blocks/s of the encode compute chain (analyze, measure,
    reservoir_scan, finalize, compact), the decode chunk program and the
    serial encode + decode, each stage timed by itself (see the module
    docstring), with its ms and GEMM FLOPs.  `pcm` (int16 [n, C]) gives the payload its statistics; it
    is cropped or tiled to exactly `blocks` coded blocks, one chunk.
    eng: the Engine whose device, config and precision are measured
    (default Engine(rate_mode="reservoir"), on the card)."""
    from pactpu_torch.codec import engine as E

    eng = eng or E.Engine(rate_mode="reservoir")
    cfg, device = eng.cfg, eng.device
    cuda = device.type == "cuda"
    rate = _cycles_per_s(device) if cuda else None
    stages, (sav, left, divisor) = device_stages(
        _chunk_pcm(pcm, blocks, cfg), blocks, eng)

    stage_ms, graph, covered = {}, {}, {}
    for name, stage in stages.items():
        secs, graph[name], covered[name] = _time_loop(stage, iters, device,
                                                      rate)
        stage_ms[name] = 1000 * secs
    t_replay = []
    for _ in range(5):
        t0 = time.perf_counter()
        E.reservoir_extras(sav, left, divisor)
        t_replay.append(time.perf_counter() - t0)

    flops = gemm_flops(cfg, blocks)
    stage_flops = {k: flops[k] for k in stage_ms}
    enc = [k for k in stage_ms if not k.startswith("decode")]
    dt_enc = sum(stage_ms[k] for k in enc) / 1000
    dt_dec = stage_ms["decode"] / 1000
    enc_flops = sum(stage_flops[k] for k in enc)
    dec_flops = stage_flops["decode"]
    out = {
        "blocks": blocks,
        "iters": iters,
        "device": (torch.cuda.get_device_name(device) if cuda else "cpu"),
        "method": ("CUDA events around the stage's graph replays queued "
                   "behind a spin, slope of two trip counts" if cuda else
                   "host clock, slope of two trip counts"),
        "encode_blocks_per_s": blocks / dt_enc,
        "decode_blocks_per_s": blocks / dt_dec,
        "roundtrip_blocks_per_s": blocks / (dt_enc + dt_dec),
        "encode_ms_per_chunk": 1000 * dt_enc,
        "decode_ms_per_chunk": 1000 * dt_dec,
        "stage_ms": stage_ms,
        "stage_gflops": {k: v / 1e9 for k, v in stage_flops.items()},
        "reservoir_replay_host_ms": 1000 * min(t_replay),
        "encode_gflops_per_s": enc_flops / dt_enc / 1e9,
        "decode_gflops_per_s": dec_flops / dt_dec / 1e9,
        # against the card's float32 peak; none from a CPU run
        "encode_mfu_f32_pct": (100 * enc_flops / dt_enc / PEAK_F32_FLOPS
                               if cuda else None),
        "decode_mfu_f32_pct": (100 * dec_flops / dt_dec / PEAK_F32_FLOPS
                               if cuda else None),
        "peak_f32_flops": PEAK_F32_FLOPS,
        "peak_of": PEAK_OF,
    }
    if cuda:
        out["graph"] = graph
        out["spin_covered"] = covered
    return out
