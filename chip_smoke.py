#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (pactpu_torch) on one NVIDIA GPU.

Run from the root of a checkout:  python3 chip_smoke.py

Phases (each prints one line; any failure raises and exits non-zero):

0. environment: the card's name and power limit, torch and CUDA versions,
   the build times of the eleven CUDA kernels (nvcc, sm_90a) and of the
   native bitstream runtime (g++);
1. kernel parity at their paths' shapes: K1-K3 and K5 bit for bit against
   their plain PyTorch versions, K4 and K6 within a stated tolerance, each
   timed (median of 20 runs, CUDA events; "ms" around one call of the
   wrapper, "device_ms" the kernel alone) beside its plain version, its
   bound on this card (bytes over the memory rate or operations over the
   float32 rate, whichever is larger) and, where one exists, the PyTorch
   call that computes the same function; K1, K4, K2, K6 and K5 also on
   the edge inputs of k1_edge, k4_edge, k2_edge, k6_edge and k5_edge;
   beside K4's and K6's bound their special-function floor, beside K5's
   its longest chain and the share of lines whose code is past the root
   table;
2. the main path: Engine(device="cuda", rate_mode="reservoir") on four
   synthetic stereo files (three of 10 s, one of 60 s), serial encode ->
   decode and roundtrip_many, which must agree byte for byte and sample
   for sample; every stream parses back; SNR above a floor; every kernel
   launched;
3. cross-check against the JAX reference through the committed fixture
   tests/data/torch_port_fixture.npz (a stream and PCM the JAX package
   made on the CPU);
4. throughput: encode + decode blocks/s, serial and roundtrip_many, and
   decode alone on the host-parse and the device-parse route;
5. device-parse decode: Engine(decode_parse="device") decodes phase 2's
   streams to the host route's samples, the JAX fixture within 1 LSB, and
   raises on a corrupted copy; K5 and K1 launched;
6. the aidan peak modes: Engine(cfg=CodecConfig(peak_mode=m)) for "para"
   and "weighted", in float32 and float64 (K6's float64 form), encode ->
   decode of the 60 s file; streams parse back, SNR above the floor, K6,
   K2 and K3 launched; for "weighted" in float32 a second JAX fixture is
   decoded within 1 LSB and re-encoded at the same SNR;
7. the other codec modes (MODES): mono .wak, stereo and mono .pac
   (Engine(fmt="pac")), the KBD window and the bit-allocation M/S
   decision, each encode -> decode of a 10 s file by both parse routes
   (the same samples) and roundtrip_many of two files against serial,
   SNR above the floor, each step's kernels launched; mono .wak and
   stereo .pac also against their JAX fixtures
   (tests/data/torch_port_fixture_modes.npz) by both routes;
8. the exact rate mode (kernels K10 and K7): Engine(rate_mode="exact") on
   the 60 s file with 128- and 512-block chunks (the same bytes), decoded, SNR
   above the floor, its encode time beside the reservoir mode's; and
   Engine(rate_mode="exact", precision="f64") on a 40-block stereo slice
   and its first channel against the float64 oracle
   (pactpu_torch.compat.refcodec), byte for byte or within
   EXACT_F64_SNR_DB and EXACT_F64_SIZE with the first differing stage
   printed;
9. the other allocators and the rest of the Engine surface (phase9):
   closed_form (K8), uniform, const_snr and const_mnr (K9), each in cbr
   and reservoir on two 10 s files, with pactpu's streams of the same
   (tests/data/torch_port_fixture_alloc.npz) decoded and re-encoded; a
   table set trained on the card (huffman_train), pactpu's trained-table
   stream, a table set outside K5's LUT (host parse only),
   device_pack=False and debug_checks=True;
10. streams, jobs, the fleet and the CLI (phase10): the 60 s file through
   StreamingEncoder in four cuts (700-sample then 1 s pieces, 1 s pieces,
   10 s pieces, a boundary inside each of the Engine's batches) and from a
   checkpoint after block 700, byte-equal to Engine().encode and timed
   beside it; StreamingDecoder with 16- and 512-block chunks and across a
   restored state, sample-equal to Engine().decode; the float32 exact
   stream of a 10 s file (K7); run_encode_jobs on the 10 s files with
   injected faults; every command of `python -m pactpu_torch` (the
   "stream" path: K1-K4 launched);
11. distribution (phase11): one process in a process group of one (NCCL)
   with meshes of 1, 2 and 4 shards on the card: encode_distributed of the
   60 s file byte-equal to the Engine's (cbr at 2.27 and 4.93
   bits/sample, reservoir at 2.27), the histogram the same for every
   mesh, the wide-packer re-run and the dense-download fallback forced
   once each, decode_distributed
   within 1 LSB of Engine.decode (K5 and K1 on every shard), a corrupted
   copy refused, a 6-size-bit stream by the host-parse route, a lost
   range of a two-process partition recovered (the "distributed" path:
   K1-K5 launched); then two gloo processes of two shards each sharing
   the card (spawned here): cbr byte-equal to the Engine, the
   histograms identical, the reservoir with rank 1's part lost and
   recovered, the decode assembled within 1 LSB, and what the per-range
   reservoir restart costs (bytes, SNR); a 10-minute file over 1 and 4
   shards timed beside Engine.encode; a second cbr encode capturing no
   program (the shard devices' owners hold them), the owners' captures
   and replays and the memory reserved; devbench.measure_device_compute
   on the 60 s file's first 512 blocks;
12. the public surface ported last (phase12): Engine(CodecConfig(),
   "cbr") and Engine(cfg=..., rate_mode="cbr") give the same bytes on a
   10 s file; pactpu_torch.StreamingEncoder(chunk_blocks=64) in 1 s
   pieces, and restored from a mid-file checkpoint, gives
   Engine().encode's bytes; the four top-level names resolve;
   dequantize_uniform, fp_mantissa and fp_dequantize on 1 M seeded
   values equal the CPU's (floats within QUANT_ULP_BOUND ulp);
   HuffmanTrainer on the card gives np.bincount's counts and the CPU's
   table, and Engine(tables=...) of the trained set round-trips the file;
   frame_blocks on the card equals frame_blocks_np; stereo_smrs on the 60 s
   file's first 512 blocks gives the Engine's own SMRs and mixed lines
   (the "surface" path: K4 launched);
13. the program layer (phase13): the four files through Engines whose
   chunk stages run as CUDA-graph replays (pactpu_torch.codec.programs),
   serial encode -> decode by both parse routes and roundtrip_many, in
   the reservoir and cbr modes, against the eager stage chain in the same
   run (eager_encode: the stage functions called chunk by chunk, the
   reservoir replayed on the host by engine.reservoir_extras; eager_decode:
   each chunk's stage function launch by launch): the same bytes and
   samples, the streams' SHA-256 printed; the reservoir encode's dispatch
   half (analysis, measurement and K11, final pass, compaction) under
   torch.cuda.set_sync_debug_mode("error"), so no host sync and no
   device-to-host copy between the PCM upload and the payload download;
   the capture seconds, the memory reserved after the 60 s file's encode
   and decode and again after a file of each tail bucket's size (every
   bucket's programs captured, all an Engine's graphs in one memory pool),
   and serial and batch blocks/s of the programs against the eager chain
   in turns (the "programs" path: K1-K5 and K11 launched); then phase
   13b (phase13_modes): the exact mode at 128- and 512-block chunks and
   in float64, the four other allocators and device_pack=False on a 10 s
   file, each through programs against the same Engine launch by launch
   (use_programs False): the routes stage by stage, the same bytes, the
   same samples by both parse routes, the dispatch half under
   set_sync_debug_mode("error"), the capture seconds, the memory
   reserved and the graph pools; and the exact mode's serial encode
   blocks/s on the 60 s file in float32 and float64, programs against
   launches in turns (the "programs-modes" path: K7-K10 launched); then
   phase 13c (phase13_paths): the paths that took programs last, each
   against itself launch by launch (programs.launch_by_launch): the 60 s
   file streamed in 1 s pushes, restored after block 700, and a 10 s
   exact stream (the same bytes, the Engine's), the streamed decode at 16
   and 512 blocks (the same samples); encode_distributed in cbr and
   reservoir and decode_distributed on 1, 2 and 4 shards of the card
   (the same bytes and samples, a second call capturing nothing); .pac
   stereo and mono encoded and decoded by both parse routes; a stream
   push's, a shard encode's, a .pac encode's and a device-parse decode's
   dispatch under set_sync_debug_mode("error"); each path's captures,
   replays by stage, capture seconds and graph pools, and in turns the 1 s
   pushes, the 16-block streamed decode, the 10-minute file's cbr encode
   on 1 and 4 shards and the .pac encode and device-parse decode (the
   "programs-paths" path).

K3 is held in both of its forms: pack_payload, the whole payload pack as
the engine launches it (its plain version bitpack.pack_payload_bits_plain),
on the payload fields of the 60 s file's first 512 blocks at the word
buckets 256, 384 and 968 and on the k3_edge rows, also against the parent
commit's pack step (pack_prologue_and_k3: the torch prologue, then
pack_words), timed beside that step, the launch floor and its byte bound,
with its ptxas registers and spills; and pack_words, the TPU kernel's own
contract, on k3_args.  The kernels line names K3 by pack_payload; phase 2
checks that the main path launches pack_words no more.

Phase 1 also holds K2 past 32 bands (k2_edge "40-bands") and in float64,
K4 and K6 in float64, K5 on a 96-band stream, K10 and K7 on a real
512-block chunk in float32 and float64 (K10 also mono, on a trained table
set, on a set with a code on every symbol that it reads from device
memory, on 96 bands and with 6 size bits; K7 also on a padded tail, mono,
40 and 96 bands), and K8 (both types) and K9 on the rows of that chunk and
on the edge inputs of k8_edge / k9_edge to their plain versions (K8 also
on k8_nonfinite and 203 bands), with K8's ns a trip, its time on rows
that take no trip and the launch floor, and K9's walk (the grants its
jump takes, the steps it walks, its probes) and its ns a walked step apart
from the jump; and K11 (reservoir_scan) bit for bit on the 60 s file's
measurements chunk by chunk with its carry (and against the host replay)
and on k11_edge's inputs, timed beside the launch floor.

Then a JSON line with each kernel's launches (on its path, and on every
path and mode measured), error and times, the nvidia-smi line, and last
{"ok": true, "device": {...}}.  With no CUDA device the script exits
non-zero before printing any result.
"""

from __future__ import annotations

import gc
import json
import os
import re
import statistics
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
DEV = "cuda"   # phases 2-4 also run on "cpu" (tests/test_torch_chip_smoke.py)
FIXTURE = os.path.join(ROOT, "tests", "data", "torch_port_fixture.npz")
FIXTURE_WEIGHTED = os.path.join(ROOT, "tests", "data",
                                "torch_port_fixture_weighted.npz")
FIXTURE_MODES = os.path.join(ROOT, "tests", "data",
                             "torch_port_fixture_modes.npz")
FIXTURE_ALLOC = os.path.join(ROOT, "tests", "data",
                             "torch_port_fixture_alloc.npz")
FS = 44100
# The reference decoder's M/S aliasing (L' = M - S, R' = M; Q1) caps the
# SNR of material whose channels differ: these files decode at 5.4 to 9.8 dB
# (the port on the CPU), as the fixture does in the JAX package (9.7 dB).
# A broken decode scores 0 dB or less.
SNR_FLOOR_DB = 3.0
# Engine(rate_mode="exact", precision="f64") against the float64 oracle:
# byte-equal is expected; where the card's FFT or GEMM order flips a
# borderline decision, SNR within this many dB and size within this share
EXACT_F64_SNR_DB = 0.01
EXACT_F64_SIZE = 0.001
# K4: every term has the plain version's bits (the same unfused float32
# operations, exp2f or its bare instruction where the two agree); the sum
# runs in masker order with a fused multiply-add, the plain version's as a
# tree: a few float32 ulp
K4_RTOL = 1e-5
K4_SPL_ATOL_DB = 1e-3
# phase 12: float32 ulp between the card's and the CPU's dequantize_uniform
# and fp_dequantize (exp2i's float64 exp, an IEEE division: none expected)
QUANT_ULP_BOUND = 0
# phase 12's FP quantizer formats (n_scale_bits, n_mantissa_bits): those of
# tests/test_quantize.py and R = 31
FP_FORMATS = ((3, 5), (4, 8), (2, 3), (4, 16))
K6_RTOL = 1e-5               # as K4: the terms are equal, the sum's order not
# K4's float64 form: exp2 in double on the card against torch's on the card,
# the sum in another order: a few float64 ulp
K4_F64_RTOL = 1e-12
K6_SPL_ATOL_DB = 1e-3
# K6's float64 form: as K4's
K6_F64_RTOL = 1e-12
REPLACES = {                 # the TPU kernel body each CUDA kernel replaces
    "extract_codes": ("extract_codes.cu", "pactpu/ops/pallas_ops.py:240"),
    "water_fill": ("water_fill.cu", "pactpu/ops/pallas_ops.py:339"),
    # K3 as the engine launches it: pactpu/ops/bitpack.py:90
    # pack_payload_bits whole, its Pallas call's body included
    "pack_payload": ("pack_words.cu", "pactpu/ops/pallas_ops.py:176"),
    "spread_maskers_up": ("spread_up.cu", "pactpu/ops/pallas_ops.py:85"),
    "huffman_walk": ("huffman_walk.cu", "pactpu/ops/huffman_walk.py:230"),
    "spread_maskers": ("spread.cu", "pactpu/ops/pallas_ops.py:50"),
    # not Pallas kernels: the loops the JAX package runs as XLA ops
    "exact_scan": ("exact_scan.cu",
                   "none: pactpu/codec/exact.py:152 (lax.scan)"),
    "closed_form": ("closed_form.cu",
                    "none: pactpu/ops/bitalloc.py:241 (lax.while_loop)"),
    "grant_fill": ("grant_fill.cu",
                   "none: pactpu/ops/bitalloc.py:458 (lax.while_loop)"),
    "cost_table": ("cost_table.cu",
                   "none: pactpu/codec/exact.py:106 (lax.map)"),
    "reservoir_scan": ("reservoir_scan.cu",
                       "none: pactpu/codec/engine.py:765 (lax.scan)"),
}
# the path whose launches each kernel's "launches" reports
PATH_OF = {"extract_codes": "main", "water_fill": "main",
           "pack_payload": "main", "spread_maskers_up": "main",
           "huffman_walk": "device-parse", "spread_maskers": "aidan",
           "exact_scan": "exact", "closed_form": "alloc-closed_form",
           "grant_fill": "alloc-const_mnr", "cost_table": "exact",
           "reservoir_scan": "main"}
# phase 11's bit rates: the default and the high-quality one, whose rows
# pass 256 words (its packer is wider: engine.pack_widths)
DIST_BPS = (2.27, 4.93)
# NVIDIA H100 SXM data sheet: HBM3 bytes/s, and float32 operations/s outside
# the tensor cores (also taken as the rate of the 32-bit integer operations)
PEAK_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = 67e12
# the same data sheet's float64 rate outside the tensor cores, for the
# float64 forms of K2, K4, K6, K7 and K8
PEAK_F64_OPS_PER_S = 34e12


class SmokeError(RuntimeError):
    pass


def check(cond, msg: str) -> None:
    if not cond:
        raise SmokeError(msg)


def say(phase: str, **kv) -> None:
    print(json.dumps({"phase": phase, **kv}), flush=True)


def synth(seconds: float, seed: int) -> np.ndarray:
    """Stereo int16 test signal: a mixture of five tones shared by both
    channels (the right one attenuated, plus a tone of its own) and
    independent noise, all from `seed`."""
    rng = np.random.default_rng(seed)
    n = int(FS * seconds)
    t = np.arange(n) / FS
    mono = sum(a * np.sin(2 * np.pi * f * t + p) for f, a, p in zip(
        rng.uniform(80, 9000, 5), rng.uniform(600, 3500, 5),
        rng.uniform(0, 2 * np.pi, 5)))
    own = 1500 * np.sin(2 * np.pi * rng.uniform(200, 5000) * t)
    sig = np.stack([mono, 0.8 * mono + own], 1)
    sig = sig + rng.standard_normal((n, 2)) * 150
    return np.clip(sig, -32767, 32767).astype(np.int16)


def snr_db(ref: np.ndarray, out: np.ndarray) -> float:
    x = ref.astype(np.float64)
    e = x - out[:len(ref)].astype(np.float64)
    return float(10 * np.log10((x * x).sum() / max((e * e).sum(), 1e-30)))


def n_blocks(pcm: np.ndarray) -> int:
    return -(-pcm.shape[0] // 1024) + 1


def rows_of(stream: bytes) -> list:
    """The channel-block payloads of a stream, past the header."""
    from pactpu_torch.codec.header import read_header
    _, _, off = read_header(stream)
    p, out, i = stream[off:], [], 0
    while i < len(p):
        n = int.from_bytes(p[i:i + 4], "little")
        out.append(p[i + 4:i + 4 + n])
        i += 4 + n
    return out


def sync(torch) -> None:
    if DEV != "cpu":
        torch.cuda.synchronize()


def median_ms(torch, fn, runs: int = 20) -> float:
    """Median time of one call of fn, in ms, over `runs` calls timed with
    CUDA events."""
    fn()                                         # warm
    times = []
    for _ in range(runs):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def device_ms(torch, fn, runs: int = 20) -> float:
    """Median time on the card of what one call of fn launches, in ms: the
    card is first given about half a millisecond of spinning, during which
    the host enqueues the two events and fn's launches between them, so the
    time between the events holds no wait for the host (median_ms does: a
    wrapper's checks, allocations and launch take the host tens of
    microseconds, more than the smaller kernels run)."""
    fn()                                         # warm
    times = []
    for _ in range(runs):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(1_000_000)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def phase0(torch) -> str:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    from pactpu_torch import native
    from pactpu_torch.ops import kernels
    t0 = time.perf_counter()
    built = kernels.build()
    kernels._load()
    k_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    native._load()
    n_s = time.perf_counter() - t0
    ptxas = []
    if os.path.exists(kernels.BUILD_LOG):
        with open(kernels.BUILD_LOG) as f:
            ptxas = [ln.strip() for ln in f if "registers" in ln]
    say("0-environment", nvidia_smi=smi, torch=torch.__version__,
        cuda=torch.version.cuda, python=sys.version.split()[0],
        kernels_build_s=round(k_s, 3), kernels_nvcc_s=round(built, 3),
        wakbits_build_s=round(n_s, 3), ptxas=ptxas)
    return smi


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


K4_EDGES = ("no-peak", "all-peaks", "k4096", "ragged", "two-tiles",
            "lowest-bark", "highest-bark")
K2_EDGES = ("neg-zero", "all-tied", "pair-ties", "one-band", "32-bands",
            "zero-budget", "to-the-cap", "max-mant-1", "nan", "dead-key",
            "40-bands")
K6_EDGES = ("no-valid", "all-valid", "lowest-highest", "ascending",
            "descending", "shuffled", "k1", "k513", "k4096", "ragged",
            "l300", "l2500", "rising-upslope", "denormal-far")
K5_EDGES = ("garbage", "garbage-5-bits", "all-escape", "escape-32",
            "sign-jump", "zero-words", "ends-inside-code", "one-word",
            "w1024", "w1500", "w40000")
K1_EDGES = ("width-0", "width-32", "last-word", "past-row", "one-bit",
            "lrms-25", "ragged-lines", "one-word", "wide-rows")


def k1_edge(name: str):
    """Edge inputs of K1 extract_codes as numpy arrays (words u32[R, W],
    off i32[R, L], width i32[R, L]): every width 0, every width 32, fields
    that end exactly at the row's last bit (rows too sparse in fields to be
    staged in shared memory), offsets past the row and below it, 1-bit
    fields over 1,024 lines (the sign shape), 25 consecutive 1-bit fields
    (the LRMS shape), 1,021 lines (no multiple of 4) packed back to back in
    63-word rows (no row 16-byte aligned), one-word rows (many rows a
    block), and 12,300-word rows, past the kernel's 48 KB of shared
    memory."""
    rng = np.random.default_rng(300 + K1_EDGES.index(name))
    rows, n_words, n_lines = {
        "last-word": (5, 600, 256), "past-row": (4, 32, 256),
        "one-bit": (8, 128, 1024), "lrms-25": (40, 128, 25),
        "ragged-lines": (6, 63, 1021), "one-word": (300, 1, 7),
        "wide-rows": (2, 12300, 6400)}.get(name, (4, 64, 512))
    words = rng.integers(0, 2 ** 32, (rows, n_words), dtype=np.uint64)
    bits = 32 * n_words
    off = rng.integers(0, bits, (rows, n_lines))
    width = rng.integers(0, 33, (rows, n_lines))
    if name == "width-0":
        width[:] = 0
    elif name == "width-32":
        width[:] = 32
    elif name == "last-word":
        width = rng.integers(1, 33, (rows, n_lines))
        off = bits - width
    elif name == "past-row":
        off = rng.integers(bits - 40, bits + 2000, (rows, n_lines))
        off[:, ::5] = rng.integers(-64, 0, (rows, -(-n_lines // 5)))
    elif name == "one-bit":
        width = rng.integers(0, 2, (rows, n_lines))
    elif name == "lrms-25":
        off = rng.integers(0, bits - 25, (rows, 1)) + np.arange(n_lines)
        width[:] = 1
    elif name == "ragged-lines":
        width = rng.integers(0, 4, (rows, n_lines))
        off = np.cumsum(width, 1) - width
    elif name == "one-word":
        off = rng.integers(0, 40, (rows, n_lines))
    return (words.astype(np.uint32), off.astype(np.int32),
            width.astype(np.int32))


def k4_edge(name: str):
    """Edge inputs of K4 spread_maskers_up as numpy arrays (iprime, mspl,
    bark, zvec): a row with no peak, rows where every bin is a peak, 4,096
    maskers, masker and line counts that are no multiple of 32 or of the
    kernel's 1,024-line tile, one masker at the lowest and at the highest
    bark."""
    rng = np.random.default_rng(K4_EDGES.index(name))
    rows, k, n = {"no-peak": (3, 128, 256), "all-peaks": (3, 256, 256),
                  "k4096": (2, 4096, 1024), "ragged": (5, 37, 1000),
                  "two-tiles": (2, 300, 1100), "lowest-bark": (2, 128, 300),
                  "highest-bark": (2, 128, 300)}[name]
    zvec = np.sort(rng.uniform(0, 25, n)).astype(np.float32)
    bark = np.sort(rng.uniform(0, 25, k)).astype(np.float32)
    mspl = rng.uniform(-30, 100, (rows, k)).astype(np.float32)
    ip = np.where(rng.random((rows, k)) < 0.2, rng.random((rows, k)),
                  0.0).astype(np.float32)
    if name == "no-peak":
        ip[1] = 0.0
    elif name in ("all-peaks", "k4096"):
        ip[0] = (rng.random(k) + 0.1).astype(np.float32)
    elif name == "lowest-bark":
        ip[:] = 0.0
        ip[:, 0] = 1.0
    elif name == "highest-bark":
        ip[:] = 0.0
        ip[:, -1] = 1.0
    return ip, mspl, bark, zvec


def k2_edge(name: str):
    """Edge inputs of K2 water_fill as (total_bits, max_mant_bits, n_lines,
    smr, lrms), numpy arrays and an int: -0.0 beside +0.0, ties, 1, 25 and
    32 bands, zero budgets, budgets that drive every band to the cap, a cap
    of one bit, NaN SMRs, SMRs at and below the dead bands' key -1e30, and
    40 bands (two a lane) with zero-line bands and ties across a lane's two
    bands and across lanes, where the lowest lane holding the maximum does
    not hold the lowest band (band 33 in lane 1 against band 2 in lane
    2)."""
    rng = np.random.default_rng(K2_EDGES.index(name))
    n_bands = {"one-band": 1, "32-bands": 32, "40-bands": 40}.get(name, 25)
    rows = 9
    max_mant = 1 if name == "max-mant-1" else 16
    smr = rng.uniform(-20, 60, (rows, n_bands)).astype(np.float32)
    lrms = rng.random((rows, n_bands)) < 0.4
    n_lines = rng.integers(0, 60, n_bands).astype(np.int32)
    total = rng.integers(0, 3000, rows).astype(np.int32)
    if name == "neg-zero":
        # float ties that an integer order would break: -0.0 ahead of +0.0
        smr[:] = np.where(rng.random(smr.shape) < 0.5, -0.0, 0.0)
        smr[:, 0] = -0.0
        smr[1::2, 2::5] = 6.0
        total[:] = rng.integers(20, 400, rows)
    elif name == "all-tied":
        smr[:] = 12.5
    elif name == "pair-ties":
        smr[:, ::2] = smr[:, 1:2]
    elif name == "32-bands":
        smr[::2, 16:] = smr[::2, :16]
    elif name == "zero-budget":
        total[:] = 0
    elif name == "to-the-cap":
        smr += 120.0
        total[:] = 10 ** 6
    elif name == "nan":
        smr[::2, 3] = np.nan
        smr[1] = np.nan
        smr[3, 7] = -np.nan
    elif name == "dead-key":
        smr[0] = -np.inf
        smr[1] = -2e30
        smr[2, ::2] = -1e30
        smr[3, 5] = -np.inf
        smr[4, 1] = np.inf
    elif name == "40-bands":
        n_lines[[3, 17, 35]] = 0
        smr[:, 33] = smr[:, 2] = 70.0          # lane 1 slot 1 vs lane 2
        smr[:, 32] = smr[:, 0]                 # one lane's two bands tie
        smr[::3, 8:] = smr[::3, :1]            # most bands tied
        smr[1::3, 20:40] = smr[1::3, 0:20]
        total[::4] = rng.integers(3000, 9000, -(-rows // 4))
    return total, max_mant, n_lines, smr, lrms


# a layout of 96 bands (64 of 8 lines, 32 of 16): past the 64 bands that
# K5 once took by value, three bands a lane of K2 and K7
WIDE_BANDS = (8,) * 64 + (16,) * 32
# 40 bands: two a lane in K2's and K7's warps
BANDS_40 = (16,) * 24 + (40,) * 16


def k6_edge(name: str):
    """Edge inputs of K6 spread_maskers as numpy arrays (mspl, lev, bark,
    valid, drop, zvec): rows with no valid slot, every slot valid, one slot
    at the lowest and one at the highest bark, slots in ascending,
    descending and shuffled bark order with holes in `valid`, 1, 513, 4,096
    and 37 slots, 300, 1,000 and 2,500 lines, upslopes that rise (lev above
    27), and single slots whose far lines fall below 2^-126."""
    rng = np.random.default_rng(100 + K6_EDGES.index(name))
    rows, k, n = {"k1": (3, 1, 1024), "k513": (4, 513, 1024),
                  "k4096": (2, 4096, 1024), "ragged": (5, 37, 1000),
                  "l300": (3, 128, 300), "l2500": (2, 128, 2500)}.get(
                      name, (4, 128, 1024))
    zvec = np.sort(rng.uniform(0, 25, n)).astype(np.float32)
    mspl = rng.uniform(-30, 100, (rows, k)).astype(np.float32)
    bark = rng.uniform(0, 25, (rows, k)).astype(np.float32)
    valid = (rng.random((rows, k)) < 0.5).astype(np.float32)
    drop = rng.choice([0.0, 15.0], rows).astype(np.float32)
    if name == "no-valid":
        valid[1:3] = 0.0
    elif name in ("all-valid", "k4096"):
        valid[:] = 1.0
    elif name == "lowest-highest":
        valid[:] = 0.0
        bark[:, 0], bark[:, -1] = 0.0, 25.0
        valid[0, 0] = valid[1, -1] = 1.0
        valid[2:, 0] = valid[2:, -1] = 1.0
    elif name == "ascending":
        bark.sort(axis=1)
    elif name == "descending":
        bark[:] = -np.sort(-bark, axis=1)
    elif name == "k1":
        valid[1:] = 1.0
    elif name == "denormal-far":
        valid[:2] = 0.0
        valid[:2, 0] = 1.0
        mspl[0, 0], bark[0, 0], drop[0] = 100.0, 20.0, 0.0
        mspl[1, 0], bark[1, 0], drop[1] = -30.0, 12.0, 15.0
    lev = (0.37 * np.maximum(mspl - 40.0, 0.0)).astype(np.float32)
    if name == "rising-upslope":
        mspl = np.minimum(mspl, 60.0)
        lev = rng.uniform(20, 40, (rows, k)).astype(np.float32)
    return mspl, lev, bark, valid, drop, zvec


K8_EDGES = ("zero-budget", "negative-budget", "everything", "ties",
            "zero-lines", "grid", "40-bands", "exact-hit", "last-band",
            "signed-zero", "96-bands")
# checked kernel against plain version only: pactpu's init casts a NaN r
# to int32, which is not defined
K8_NONFINITE = ("nan", "inf", "nan-inf")
K9_EDGES = ("zero-budget", "negative-budget", "everything", "ties",
            "zero-lines", "nan", "inf", "stall", "40-bands")


def _alloc_rows(name: str, seed: int):
    """What K8's and K9's edge inputs share: (budget i32[9], values
    f32[9, bands], n_lines i32[bands]) with the budgets, ties and line
    counts `name` asks for."""
    rng = np.random.default_rng(seed)
    n_bands = 40 if name == "40-bands" else 25
    rows = 9
    vals = rng.uniform(-20, 60, (rows, n_bands)).astype(np.float32)
    n_lines = rng.integers(1, 60, n_bands).astype(np.int32)
    budget = rng.integers(0, 3000, rows).astype(np.int32)
    lines = int(n_lines.sum())
    if name == "zero-budget":
        budget[:] = 0
    elif name == "negative-budget":
        budget[:] = -rng.integers(1, 5000, rows)
        budget[0] = -1
    elif name == "everything":
        # at and past 16 bits on every line
        budget[:] = 16 * lines + rng.integers(0, 500, rows)
        budget[0] = 16 * lines
        budget[1] = 16 * lines - 1
    elif name == "ties":
        vals[:] = np.round(vals / 6.0) * 6.0     # ties across lanes
        vals[0] = 12.0
        vals[1, 0:24:2] = vals[1, 1:24:2]         # pairwise ties
    elif name == "zero-lines":
        n_lines[[0, 3, 17, 24]] = 0
        budget[::2] = 0
    elif name == "grid":
        vals[:] = rng.integers(-320, 480, vals.shape) / 8.0
        budget[1] = 16 * lines + 7
    elif name == "40-bands":
        n_lines[[3, 17, 35]] = 0
        vals[:, 33] = vals[:, 2] = 30.0          # lane 1 slot 1 vs lane 2
        vals[:, 32] = vals[:, 0]                 # one lane's two bands tie
        vals[::3, 8:] = vals[::3, :1]            # most bands tied
        budget[::4] = rng.integers(3000, 9000, -(-rows // 4))
    return budget, vals, n_lines


def k8_edge(name: str):
    """Edge inputs of K8 closed_form as (budget, smr, n_lines,
    max_mant_bits), numpy arrays and an int: zero and negative budgets,
    budgets at, just below and past 16 bits on every line, SMRs on a
    6 dB grid (ties across lanes and, after the +6 dB steps, across trips),
    zero-line bands, SMRs on a 1/8-dB grid (every product and sum exact),
    40 bands (two a lane) with ties across a lane's slots and across
    lanes, and the take-back's own edges: a trip that lands spent on the
    budget (so that `spent >= budget` takes one more), the trip that
    retires the last live band bringing spent under the budget, -0.0 and
    +0.0 SMRs tied across lanes, and 96 bands (four slots a lane) tied
    across a lane's slots."""
    if name in ("exact-hit", "last-band", "signed-zero", "96-bands"):
        return _k8_takeback_rows(name, 400 + K8_EDGES.index(name))
    budget, smr, n_lines = _alloc_rows(name, 400 + K8_EDGES.index(name))
    return budget, smr, n_lines, 16


def _k8_takeback_rows(name: str, seed: int):
    """k8_edge's inputs for the take-back's edges, nine rows each.

    "exact-hit": 24 bands tied at 60 dB and one far below (-3,000 dB, 30
    lines), so that the init caps the 24 at 16 bits and gives the low band
    none; the low band's trip retires it, then the tied bands give back a
    bit each in band order.  Row k's budget is what is left after k
    give-backs: spent lands on it exactly, and one more trip follows.
    "last-band": one band high (16 bits, or fewer where its SMR is lower),
    the rest far below (no bits: each retires on its trip); the high band
    gives back to 2 bits, then to 0 on the trip that retires it, the last
    live band, with a budget of 1 to 2 x its lines, so that this trip is
    also the one that brings spent under the budget.
    "signed-zero": random SMRs with -0.0 and +0.0 on bands of both orders
    of sign, a band far below to push spent past the budget, so that the
    zero bands are taken back while tied.
    "96-bands": random SMRs on a 6 dB grid, slots 1-2 of each lane tied
    with slot 0 in some rows, and low bands pushing spent past the
    budget."""
    rng = np.random.default_rng(seed)
    rows = 9
    if name == "exact-hit":
        n_lines = rng.integers(1, 60, 25).astype(np.int32)
        n_lines[[24, 0, 13]] = 30                  # the low band's places
        smr = np.full((rows, 25), 60.0, np.float32)
        budget = np.zeros(rows, np.int32)
        for k in range(rows):
            low = (24, 0, 13)[k % 3]
            smr[k, low] = -3000.0
            tied = [b for b in range(25) if b != low]
            # 16 bits on every tied band's lines, less k give-backs
            budget[k] = 16 * int(n_lines[tied].sum()) - int(
                n_lines[tied[:k]].sum())
        return budget, smr, n_lines, 16
    if name == "last-band":
        n_lines = rng.integers(1, 60, 25).astype(np.int32)
        smr = np.full((rows, 25), -400.0, np.float32)
        budget = np.zeros(rows, np.int32)
        for k, (hi, level) in enumerate(((0, 200.0), (24, 200.0),
                                         (13, 200.0), (6, 60.0),
                                         (7, 200.0), (20, 120.0),
                                         (3, 200.0), (16, 200.0),
                                         (9, 90.0))):
            smr[k, hi] = level
            smr[k] += rng.uniform(0.0, 1.0, 25).astype(np.float32)
            # 1 to 2 x its lines: over at 2 bits, under at 0
            budget[k] = (1, 2 * int(n_lines[hi]), int(n_lines[hi]) + 1)[k % 3]
        return budget, smr, n_lines, 16
    if name == "signed-zero":
        n_lines = rng.integers(1, 60, 25).astype(np.int32)
        smr = rng.uniform(-20, 60, (rows, 25)).astype(np.float32)
        smr[:, 5] = -300.0
        n_lines[5] = 50
        smr[:, [2, 11, 17, 22]] = 0.0
        smr[::2, [11, 22]] = -0.0                  # -0.0 behind +0.0
        smr[1::2, [2, 17]] = -0.0                  # -0.0 ahead of +0.0
        smr[4] = np.where(smr[4] > 0, smr[4], -0.0)
        smr[4, 5] = -300.0
        budget = rng.integers(200, 3000, rows).astype(np.int32)
        return budget, smr, n_lines, 16
    # 96 bands
    n_lines = rng.integers(1, 40, 96).astype(np.int32)
    smr = (rng.integers(-4, 10, (rows, 96)) * 6.0).astype(np.float32)
    smr[::2, 32:64] = smr[::2, :32]                # slot 1 ties slot 0
    smr[::3, 64:] = smr[::3, :32]                  # slot 2 too
    smr[:, [7, 40, 71, 95]] = -400.0
    budget = rng.integers(0, 9000, rows).astype(np.int32)
    return budget, smr, n_lines, 16


def k8_nonfinite(name: str):
    """K8's non-finite inputs (K8_NONFINITE), as k8_edge returns them:
    NaN SMRs of both signs (the arg-min takes the first NaN), +inf and
    -inf SMRs (a live +inf band ties a retired one), and both in one row;
    every third budget zero, so that such rows take trips.  A NaN, or +inf
    beside -inf, makes the row's mean NaN and every r NaN (no bits); -inf
    alone makes every finite band's r +inf (capped), so those rows give
    bits back."""
    budget, smr, n_lines = _alloc_rows(name, 450 + K8_NONFINITE.index(name))
    if name in ("nan", "nan-inf"):
        smr[::2, 3] = np.nan
        smr[1, 20:] = np.nan
        smr[3, 7] = -np.nan
        smr[5] = np.nan
        n_lines[3] = 0
    if name in ("inf", "nan-inf"):
        smr[0, 4] = np.inf
        smr[2] = -np.inf
        smr[4, ::3] = -np.inf
        smr[6, 1] = np.inf
        smr[6, 24] = -np.inf
        smr[7, 9:] = np.inf
    budget[::3] = 0
    return budget, smr, n_lines, 16


def k3_args(torch, dev) -> list:
    """K3 pack_words' inputs of phase 1: 1,024 rows of 1,148 random parts
    at sorted word indices (a few out of range at both ends) for n_words
    968 and 256, as [(p0, p1, w0, n_words), ...]; phase 1 times the last."""
    rng = np.random.default_rng(1)
    out = []
    for n_words in (968, 256):
        p0, p1 = (torch.from_numpy(rng.integers(
            -2 ** 31, 2 ** 31, (1024, 1148), dtype=np.int64).astype(
                np.int32)).to(dev) for _ in range(2))
        w0 = torch.from_numpy(np.sort(rng.integers(
            -2, n_words + 2, (1024, 1148)), axis=1).astype(np.int32))
        out.append((p0, p1, w0.to(dev), n_words))
    return out


K3_EDGES = ("all-off", "escape-29", "wide-values", "overflow")
# the engine's word buckets that the packer runs at
K3_WORDS = (256, 384, 968)


def k3_fields(rng, rows: int, n_lines) -> dict:
    """Payload fields as the final pass gives them to the packer, numpy
    int32 (overall, tid [rows]; ba, sf, lrms [rows, bands]; sign, codes,
    lens [rows, lines]): allocations 0 or 2-16 bits, codes below 2^lens
    of 1 to 20 bits, sign, codes and lens zero on bands without bits."""
    n_lines = np.asarray(n_lines)
    nb, total = len(n_lines), int(n_lines.sum())
    seg = np.repeat(np.arange(nb), n_lines)
    ba = np.where(rng.random((rows, nb)) < 0.3, 0,
                  rng.integers(2, 17, (rows, nb)))
    on = ba[:, seg] > 0
    lens = np.where(on, rng.integers(1, 21, (rows, total)), 0)
    codes = rng.integers(0, 1 << 20, (rows, total)) & ((1 << lens) - 1)
    f = dict(overall=rng.integers(0, 16, rows),
             tid=rng.integers(1, 11, rows), ba=ba,
             sf=rng.integers(0, 16, (rows, nb)),
             sign=np.where(on, rng.integers(0, 2, (rows, total)), 0),
             codes=codes, lens=lens, lrms=rng.integers(0, 2, (rows, nb)))
    return {k: v.astype(np.int32) for k, v in f.items()}


K3_KEYS = ("overall", "tid", "ba", "sf", "sign", "codes", "lens", "lrms")


def k3_edge(name: str, n_lines) -> dict:
    """Edge rows of K3's payload pack (k3_fields' form, 6 rows): every band
    off (the header, allocation, scale and LRMS fields alone); every line
    coded at the longest escape, 29 bits (30,953 bits a row: the 968-word
    bucket's case, past 256 and 384 words); values wider than their
    widths (codes and every other field over all 32 bits, signs 0-7 and
    negative, allocations up to 2^31: each spills into the bits before
    it); rows whose items run past 256 words (10-20-bit codes; dropped
    words, the full nbits)."""
    rng = np.random.default_rng(320 + K3_EDGES.index(name))
    f = k3_fields(rng, 6, n_lines)
    shape = f["codes"].shape
    if name == "all-off":
        for k in ("ba", "sign", "codes", "lens"):
            f[k][:] = 0
    elif name == "escape-29":
        f["ba"] = rng.integers(2, 17, f["ba"].shape)
        f["lens"] = np.full(shape, 29)
        f["codes"] = rng.integers(0, 1 << 29, shape)
        f["sign"] = rng.integers(0, 2, shape)
    elif name == "wide-values":
        i32 = lambda s: rng.integers(-2 ** 31, 2 ** 31, s)  # noqa: E731
        for k in ("overall", "tid", "sf", "lrms", "codes"):
            f[k] = i32(f[k].shape)
        f["ba"] = np.where(rng.random(f["ba"].shape) < 0.2, 0,
                           rng.integers(1, 2 ** 31, f["ba"].shape))
        f["ba"][0, ::2] = -5
        f["sign"] = rng.integers(-3, 8, shape)
        f["lens"] = rng.integers(0, 30, shape)
    elif name == "overflow":
        f["lens"] = np.where(f["lens"] > 0, rng.integers(10, 21, shape), 0)
    return {k: np.asarray(v).astype(np.int32) for k, v in f.items()}


def k3_tensors(torch, fields: dict, dev) -> tuple:
    """k3_fields' arrays as the packer's first eight arguments on dev."""
    return tuple(torch.from_numpy(fields[k]).to(dev) for k in K3_KEYS)


def pack_prologue_and_k3(fields: tuple, cfg, n_words: int):
    """The parent commit's pack_payload_bits on the card: the int64 torch
    prologue (bitpack.payload_parts, about 60 launches a chunk) and then
    K3's one-to-one form, kernels.pack_words, on its pre-shifted parts."""
    from pactpu_torch.ops import bitpack
    from pactpu_torch.ops import kernels as K
    p = bitpack._plan_tensors(tuple(cfg.band_layout.n_lines),
                              cfg.n_scale_bits, cfg.n_mant_size_bits,
                              cfg.n_table_id_bits, str(fields[0].device))
    part0, part1, w0, nbits = bitpack.payload_parts(*fields, p)
    return K.pack_words(part0, part1, w0, n_words), nbits


def k8_args(torch, dev_tables, pcm: np.ndarray, blocks: int = 512):
    """K8 closed_form's arguments on the rows of one chunk of pcm (both
    channels, the flat per-channel budget), in dev_tables' precision."""
    from pactpu_torch import CodecConfig
    from pactpu_torch.codec import engine as E
    cfg = CodecConfig()
    dev = dev_tables["win"].device
    a = E.analyze(cfg, chunk_frames(torch, pcm, blocks, dev), dev_tables)
    total = torch.full((2 * blocks,), int(cfg.bit_budget()),
                       dtype=torch.int32, device=dev)
    return (total, a["smr"].reshape(2 * blocks, -1).contiguous(),
            dev_tables["lay"]["n_lines"], 16)


def k8_step_rows(torch, n_lines, rows: int, dtype=None):
    """Inputs that time a K8 trip, free of the launch and of the init:
    SMRs of 300 dB (plus up to 1 dB) on every band but the last (0 dB), so
    that the init caps every other band at 16 bits, far past a budget of
    1,300 bits (347 trips a row at 25 bands), against a budget past 16
    bits on every line (no trip: the launch, one row's init and the
    store).  Returns (many, none), argument tuples of kernels.closed_form,
    in float32 or `dtype`."""
    dev = n_lines.device
    gen = torch.Generator().manual_seed(8)
    smr = 300.0 + torch.rand(rows, n_lines.shape[0], generator=gen)
    smr[:, -1] = 0.0
    smr = smr.to(dev, dtype or torch.float32).contiguous()
    lines = int(n_lines.sum())
    many = torch.full((rows,), 1300, dtype=torch.int32, device=dev)
    none = torch.full((rows,), 16 * lines + 1, dtype=torch.int32,
                      device=dev)
    return (many, smr, n_lines, 16), (none, smr, n_lines, 16)


def k8_wide(name: str = "203-bands"):
    """K8's wide form (past 128 bands) with a tail past its whole octets:
    203 bands, nine rows, budgets from below zero to past 16 bits on every
    line, in k8_edge's form."""
    rng = np.random.default_rng(470)
    n_lines = rng.integers(0, 30, 203).astype(np.int32)
    lines = int(n_lines.sum())
    budget = rng.integers(-lines, 17 * lines, 9).astype(np.int32)
    smr = rng.uniform(-30, 90, (9, 203)).astype(np.float32)
    return budget, smr, n_lines, 16


def launch_floor_ms(torch) -> float:
    """The card's time alone for the least launch, as device_ms times a
    kernel: a one-element fill_ (a PyTorch yardstick the port never
    calls)."""
    one = torch.empty(1, device="cuda")
    return device_ms(torch, lambda: one.fill_(1.0))


K11_EDGES = ("deposit-10", "deposit-11", "deposit-negative", "divisor-1",
             "divisor-100", "all-invalid", "ragged-13", "mono",
             "near-int32-limit", "deposit-at-limit", "1000-blocks")
I32_MAX = 2 ** 31 - 1


def k11_edge(name: str):
    """Edge inputs of K11 reservoir_scan as numpy (savings i32[B, C],
    leftover i32[B], valid bool[B], carry i32[2], divisor): a deposit of
    exactly 10 and 11 and a negative one, divisors 1 and 100, a chunk of
    invalid blocks only, 13 blocks (pactpu pads its scan to a multiple of
    8; the kernel walks 32 a pass), mono savings, magnitudes that wrap in
    int32 (and a deposit held at its limit), and 1,000 blocks."""
    rng = np.random.default_rng(len(name))
    i32 = lambda a: np.asarray(a, np.int32)  # noqa: E731
    small = lambda shape: i32(rng.integers(-40, 60, shape))  # noqa: E731
    if name in ("deposit-10", "deposit-11", "deposit-negative"):
        d = {"deposit-10": 10, "deposit-11": 11, "deposit-negative": -37}
        return (small((8, 2)), small(8), np.ones(8, bool),
                i32([d[name], 5]), 3)
    if name in ("divisor-1", "divisor-100"):
        return (i32(rng.integers(-3000, 9000, (40, 2))),
                i32(rng.integers(-200, 400, 40)), rng.random(40) < 0.9,
                i32([500, -20]), 1 if name == "divisor-1" else 100)
    if name == "all-invalid":
        return (small((16, 2)), small(16), np.zeros(16, bool),
                i32([1234, -56]), 100)
    if name == "ragged-13":
        return (small((13, 2)), small(13), rng.random(13) < 0.7,
                i32([20, 1]), 7)
    if name == "mono":
        return (i32(rng.integers(-900, 2000, (24, 1))),
                i32(rng.integers(-90, 90, 24)), np.ones(24, bool),
                i32([0, 0]), 100)
    if name == "near-int32-limit":
        return (i32(rng.integers(-2 ** 31, 2 ** 31, (32, 2))),
                i32(rng.integers(-2 ** 31, 2 ** 31, 32)),
                rng.random(32) < 0.8, i32([I32_MAX - 3, -2 ** 31 + 2]), 2)
    if name == "deposit-at-limit":
        return (i32(np.full((8, 2), I32_MAX)), i32(np.full(8, I32_MAX)),
                np.ones(8, bool), i32([I32_MAX, I32_MAX]), 1)
    if name == "1000-blocks":
        return (i32(rng.integers(-2000, 4000, (1000, 2))),
                i32(rng.integers(-100, 300, 1000)), rng.random(1000) < 0.95,
                i32([-5, 3]), 100)
    raise KeyError(name)


def k9_edge(name: str):
    """Edge inputs of K9 grant_fill as (total, level, n_lines,
    max_mant_bits, budget_cap): the budgets, ties and line counts of
    k8_edge, NaN levels of both signs, +inf and -inf levels, rows whose
    arg-max falls on a band that cannot be paid for (every other level
    -inf: the walk stops), and 40 bands.  budget_cap is the engine's, four
    times the largest budget (pactpu's loop bound)."""
    total, level, n_lines = _alloc_rows(name, 500 + K9_EDGES.index(name))
    if name == "nan":
        level[::2, 3] = np.nan
        level[1] = np.nan
        level[3, 7] = -np.nan
    elif name == "inf":
        level[0, 4] = np.inf
        level[2] = -np.inf
        level[4, ::3] = -np.inf
        level[5, 1] = np.inf
        level[5, 6] = np.inf
    elif name == "stall":
        # band 0 costs more than any budget: where every level is -inf the
        # arg-max is band 0 and nothing is granted from there on
        n_lines[0] = 4000
        level[:5] = -np.inf
        level[5:, 1:] = -np.inf
    cap = 4 * max(int(total.max()), 1)
    return total, level, n_lines, 16, cap


def k5_rows(ba_of, value_of, n_words: int, size_bits: int = 4,
            seed: int = 0):
    """Well-formed payload rows under the default band layout, one per
    shipped Huffman table: band b allocates ba_of(b) bits (0 = inactive),
    line i of an active band carries value_of(table, ba, i, rng) -> (value,
    as_escape); a value its table lacks goes as an escape too.  Sign bits
    are random.  Returns (words u32[tables, n_words], cut off after n_words,
    and the codes i32[tables, lines] the rows decode to)."""
    from pactpu_torch.ops.huffman import load_tables
    from pactpu_torch.utils.config import CodecConfig
    rng = np.random.default_rng(seed)
    n_lines = CodecConfig().band_layout.n_lines
    lengths, codes, esc_len, esc_code = load_tables()
    words = np.zeros((len(esc_len), n_words), np.uint32)
    want = np.zeros((len(esc_len), sum(n_lines)), np.uint32)
    for t in range(len(esc_len)):
        bits, line = [], 0

        def put(v, n):
            bits.extend((int(v) >> (n - 1 - i)) & 1 for i in range(n))

        put(3, 4)
        put(t + 1, 4)
        for b, nl in enumerate(n_lines):
            ba = ba_of(b)
            put(ba - 1 if ba else 0, size_bits)
            put(5, 4)
            line += nl
            if not ba:
                continue
            bits.extend(int(x) for x in rng.integers(0, 2, nl))   # signs
            for i in range(nl):
                v, as_escape = value_of(t, ba, i, rng)
                if (as_escape or v >= lengths.shape[1]
                        or lengths[t, v] == 0):
                    put(esc_code[t], int(esc_len[t]))
                    put(v, ba)
                else:
                    put(codes[t, v], int(lengths[t, v]))
                want[t, line - nl + i] = v
        bits += [0] * (-len(bits) % 32)
        packed = np.packbits(np.asarray(bits, np.uint8)).view(">u4")[:n_words]
        words[t, :packed.shape[0]] = packed
    return words, want.view(np.int32)


def k5_edge(name: str) -> dict:
    """Edge inputs of K5 huffman_walk under the default band layout:
    dict(words u32[R, W], size_bits, want).  Random words (every table id,
    dead codes, cursors that run far past the row) at 32, 1, 1,024, 1,500
    and 40,000 words a row (the last too wide for the kernel's shared
    memory) and with 5 mantissa-size bits; well-formed rows, one
    per table (k5_rows), whose every code is an escape (16- and 2-bit
    mantissas, and 32-bit ones under 5 size bits), whose only active bands
    are the two widest (163 and 304 sign bits to jump over), and the same
    rows cut off inside a code; rows of zero words.  `want` is the code
    i32[R, lines] that the well-formed rows decode to (None otherwise)."""
    seed = 200 + K5_EDGES.index(name)
    rng = np.random.default_rng(seed)
    shape = {"garbage": (70, 32), "garbage-5-bits": (33, 32),
             "one-word": (9, 1), "w1024": (35, 1024), "w1500": (8, 1500),
             "w40000": (3, 40000), "zero-words": (5, 128)}.get(name)
    size_bits = 5 if name in ("garbage-5-bits", "escape-32") else 4
    if name == "zero-words":
        return dict(words=np.zeros(shape, np.uint32), size_bits=4, want=None)
    if shape is not None:
        words = rng.integers(0, 2 ** 32, shape, dtype=np.uint64)
        return dict(words=words.astype(np.uint32), size_bits=size_bits,
                    want=None)
    if name == "all-escape":
        words, want = k5_rows(
            lambda b: 16 if b == 0 else 2 if b < 14 else 0,
            lambda t, ba, i, r: (int(r.integers(0, 1 << ba)), True), 512,
            seed=seed)
    elif name == "escape-32":
        words, want = k5_rows(
            lambda b: 32 if b == 0 else 0,
            lambda t, ba, i, r: (0xFFFFFFFF if i == 0
                                 else int(r.integers(0, 1 << 32)), True),
            64, 5, seed)
    else:
        words, want = k5_rows(
            lambda b: 3 if b >= 23 else 0,
            lambda t, ba, i, r: (int(r.integers(0, 8)), False),
            40 if name == "ends-inside-code" else 256, seed=seed)
    return dict(words=words, size_bits=size_bits,
                want=None if name == "ends-inside-code" else want)


def k1_main_input(torch, lay: dict, rows: int = 1024, seed: int = 1):
    """K1's input on the host-parse decode of a 512-block chunk: `rows`
    channel-block rows of 1,024 mantissa fields repacked into 256 words
    (native.repack_codes) from random allocations (0 or 2..16 bits a band,
    at most 4 above band 12, so that a row fits), with the offsets and
    widths the engine computes from them.  Returns (words, off, width,
    mant): tensors on lay's device and the codes as numpy."""
    from pactpu_torch import native
    from pactpu_torch.codec import engine as E
    rng = np.random.default_rng(seed)
    seg = lay["seg"].cpu().numpy()
    ba = rng.integers(0, 17, (rows, 25)).astype(np.int32)
    ba[ba == 1] = 0
    ba[:, 12:] = np.minimum(ba[:, 12:], 4)          # rows fit 256 words
    width = ba[:, seg]
    mant = np.where(width > 0, rng.integers(0, 2 ** 16, width.shape)
                    & ((1 << width) - 1), 0).astype(np.int32)
    words = native.repack_codes(mant, ba, lay["n_lines"].cpu().numpy(), 256)
    dev = lay["seg"].device
    off, wid, _ = E._line_bit_offsets(torch.from_numpy(ba).to(dev), lay)
    return torch.from_numpy(words.view(np.int32)).to(dev), off, wid, mant


def chunk_frames(torch, pcm: np.ndarray, blocks: int, device):
    """The first `blocks` blocks of pcm [n, C] as one chunk's frames
    i16[blocks, C, 2048] on `device`, the leading half-block of zeros
    included, as the engine frames a file."""
    from pactpu_torch.codec import engine as E
    glob = np.zeros((pcm.shape[1], (blocks + 1) * 1024), np.int16)
    n = min(pcm.shape[0], blocks * 1024)
    glob[:, 1024:1024 + n] = pcm[:n].T
    return E._overlap_frames(torch.from_numpy(glob).to(device), 1024)


def k7_args(torch, cfg, dev_tables, pcm: np.ndarray, blocks: int,
            n_valid: int = None, carry=(0, 0)):
    """K7 exact_scan's arguments on one chunk of pcm under cfg (float64
    where dev_tables are): the chunk's SMRs and LRMS flags (engine.analyze)
    and its cost table (exact.cost_table), n_valid real blocks (all by
    default), the carry (deposit, extra)."""
    from pactpu_torch.codec import engine as E
    from pactpu_torch.codec import exact
    dev = dev_tables["win"].device
    a = E.analyze(cfg, chunk_frames(torch, pcm[:, :cfg.n_channels], blocks,
                                    dev), dev_tables)
    return (a["smr"].contiguous(), a["lrms"].contiguous(),
            exact.cost_table(cfg, a, dev_tables),
            blocks if n_valid is None else n_valid,
            torch.tensor(carry, dtype=torch.int32, device=dev),
            float(cfg.bit_budget()), dev_tables["lay"]["n_lines"],
            exact.max_mant(cfg), cfg.ms_stop_threshold_db,
            cfg.lr_stop_threshold_db, cfg.n_table_id_bits,
            cfg.reservoir_withdraw_divisor)


def k10_args(torch, cfg, dev_tables, pcm: np.ndarray, blocks: int,
             tables=None):
    """K10 cost_table's arguments on one chunk of pcm under cfg (float64
    where dev_tables are): the chunk's MDCT lines (engine.analyze's
    "mixed"), the band layout, the Huffman table set's code and escape
    lengths (dev_tables' own, or `tables`, a 4-tuple of arrays as
    Engine(tables=...) takes it), the scale-factor bits and the
    allocation cap."""
    from pactpu_torch.codec import engine as E
    from pactpu_torch.codec import exact
    dev = dev_tables["win"].device
    a = E.analyze(cfg, chunk_frames(torch, pcm[:, :cfg.n_channels], blocks,
                                    dev), dev_tables)
    lens, _, esc, _ = (dev_tables["tabs"] if tables is None else tuple(
        torch.as_tensor(np.ascontiguousarray(t, np.int32), device=dev)
        for t in tables))
    return (a["mixed"].contiguous(), dev_tables["lay"], lens, esc,
            cfg.n_scale_bits, exact.max_mant(cfg))


def k9_args(torch, dev_tables, pcm: np.ndarray, blocks: int = 512) -> dict:
    """K9 grant_fill's arguments on the rows of one chunk of pcm (both
    channels, the flat per-channel budget, the engine's step cap): "mnr",
    its SMRs as const_mnr takes them, and "snr", its peak SPLs as
    const_snr does."""
    from pactpu_torch import CodecConfig
    from pactpu_torch.codec import engine as E
    from pactpu_torch.ops import bitalloc, psycho
    cfg = CodecConfig()
    dev = dev_tables["win"].device
    a = E.analyze(cfg, chunk_frames(torch, pcm, blocks, dev), dev_tables)
    nl = dev_tables["lay"]["n_lines"]
    budget = int(cfg.bit_budget())
    total = torch.full((2 * blocks,), budget, dtype=torch.int32, device=dev)
    cap = bitalloc._legacy_iter_bound(4 * max(budget, 1),
                                      cfg.band_layout.n_lines, cfg.n_bands)
    pk = psycho.band_max(torch.abs(a["mixed"]), dev_tables["lay"], fill=0.0)
    peak_spl = (psycho.spl(4.0 * pk * pk)
                - 6.02 * a["overall"][..., None].to(pk.dtype))
    return {what: (total, level.reshape(2 * blocks, -1).float().contiguous(),
                   nl, 16, cap)
            for what, level in (("mnr", a["smr"]), ("snr", peak_spl))}


def k9_step_rows(torch, n_lines, rows: int) -> dict:
    """Inputs that time a K9 grant, free of the launch and of what a row
    costs besides its grants: levels near 200 dB (a band's 16 keys above
    every later band's) and a budget past 16 bits on every line (400 grants
    a row at 25 bands) against a zero budget (no grant).  "walk": a NaN
    level in the last band, so that no row jumps; "jump": finite levels,
    which the jump takes at once.  form -> (many, none, grants a row),
    many and none argument tuples of kernels.grant_fill."""
    dev = n_lines.device
    n_bands = n_lines.shape[0]
    lines = int(n_lines.sum())
    cap = 16 * n_bands + 1
    gen = torch.Generator().manual_seed(9)
    level = 200.0 + torch.rand(rows, n_bands, generator=gen)
    walk = level.clone()
    walk[:, -1] = float("nan")
    out = {}
    for form, lev in (("walk", walk), ("jump", level)):
        lev = lev.to(dev).contiguous()
        many = torch.full((rows,), 16 * lines, dtype=torch.int32, device=dev)
        none = torch.zeros(rows, dtype=torch.int32, device=dev)
        out[form] = ((many, lev, n_lines, 16, cap),
                     (none, lev, n_lines, 16, cap), 16 * n_bands)
    return out


def main_path_inputs(torch, dev_tables, pcm: np.ndarray, blocks: int = 512,
                     stream: bytes = None,
                     parts=("k1", "k4", "k2", "k6", "k3")):
    """What one chunk of its path hands to K1, K4, K2, K6, K3 and K5: K1's
    from k1_main_input; K4's arguments from the chunk's masker levels
    (6 * blocks rows); K3's payload fields (`k3`, the packer's first eight
    arguments, 2 * blocks rows) from the chunk's final pass without the
    reservoir's extra bits; K2's from
    its SMRs plus edge rows (zero budgets, budgets that drive bands to the
    16-bit cap, ties in SMR); K6's from the compacted weighted-mode maskers
    of the same rows; and, given `stream` (the encode of `pcm`), K5's: the
    stream's first 2 * blocks channel-block rows at their word bucket plus
    64 copies with one word XORed with random bits (`k5`, with the rows'
    bit counts as `k5_nbits`).  `parts` names the inputs to make; the
    float inputs are float64 where dev_tables are."""
    from pactpu_torch.codec import engine as E
    from pactpu_torch.ops import psycho
    from pactpu_torch.ops import quantize as q
    dev = dev_tables["win"].device
    psy = dev_tables["psy"]
    frames = chunk_frames(torch, pcm, blocks, dev)
    sw = q.pcm16_to_float(frames, dev_tables["win"].dtype) * dev_tables["win"]
    variants, drops = psycho.six_variants(sw, psy["hann"])
    out = {}
    if "k4" in parts:
        mspl, peak = psycho.masker_levels(variants, psy["hann"])
        iprime = psycho.masker_intensity(mspl, peak, drops)
        out["k4"] = (iprime, mspl, psy["bin_bark"], psy["zvec"])
    if "k2" in parts or "k3" in parts:
        analysis = E.analyze(E.CodecConfig(), frames, dev_tables)
    if "k3" in parts:
        out["k3"] = E.payload_rows(E.finalize(
            E.CodecConfig(), analysis, torch.zeros(blocks, device=dev),
            dev_tables, pack_words=0))
    if "k2" in parts:
        smr = analysis["smr"][:, 0].contiguous().clone()
        lrms = analysis["lrms"].contiguous().clone()
        total = torch.full((blocks,), 2116, dtype=torch.int32, device=dev)
        total[:16] = 0
        total[16:32] = 30000
        total[32:48] = int(1e6)
        smr[48:64] = 20.0                               # all bands tied
        smr[64:80, ::2] = smr[64:80, 1::2].mean()       # pairwise ties
        total[64:80] = torch.arange(16, device=dev, dtype=torch.int32) * 300
        out["k2"] = (total, 16, dev_tables["lay"]["n_lines"], smr, lrms)
    if "k6" in parts:
        height, bark, keep = psycho.aidan_peaks(variants, FS, "weighted",
                                                psy["hann"])
        check(int(keep.sum(1).max()) <= 513, "more peaks than slots")
        out["k6"] = (*psycho.compact_slots(height, keep, bark, psy, 0.37),
                     drops, psy["zvec"])
    if "k1" in parts:
        *k1, out["k1_mant"] = k1_main_input(torch, dev_tables["lay"],
                                            2 * blocks)
        out["k1"] = tuple(k1)
    if stream is not None:
        from pactpu_torch.codec.header import read_header
        from pactpu_torch.ops import huffman_decode as hd
        from pactpu_torch.ops import huffman_walk as hw
        cfg, _, hoff = read_header(stream)
        rows_w, rows_n = hd.frame_rows(stream[hoff:])
        bucket = next(w for w in E._PAYLOAD_WORD_BUCKETS
                      if w >= rows_w.shape[1])
        n = 2 * blocks
        check(rows_w.shape[0] >= n, "stream shorter than the chunk")
        wk = np.zeros((n + 64, bucket), np.uint32)
        wk[:n, :rows_w.shape[1]] = rows_w[:n]
        wk[n:] = wk[:64]
        nk = np.concatenate([rows_n[:n], rows_n[:64]])
        rng = np.random.default_rng(1)
        for r in range(n, n + 64):
            wk[r, rng.integers(0, max(1, nk[r] // 32))] ^= np.uint32(
                rng.integers(1, 1 << 32))
        out["k5"] = (torch.from_numpy(wk.view(np.int32)).to(dev),
                     hw.device_walk_lut(device=dev), cfg.band_layout.n_lines,
                     cfg.n_scale_bits, cfg.n_mant_size_bits,
                     cfg.n_table_id_bits)
        out["k5_nbits"] = torch.from_numpy(nk).to(dev)
    return out


def sm_clock_mhz() -> float:
    """The SM clock as nvidia-smi reports it now."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm", "--format=csv,noheader,"
         "nounits"], capture_output=True, text=True, check=True, timeout=60)
    return float(out.stdout.strip().splitlines()[0])


def phase1(torch, dev_tables, pcm: np.ndarray, stream: bytes) -> dict:
    """Each kernel against its plain version on its path's shapes (one
    512-block chunk; `stream` is the encode of `pcm`)."""
    from pactpu_torch import native
    from pactpu_torch.ops import kernels as K
    from pactpu_torch.ops import psycho
    dev = torch.device("cuda")
    blocks = 512
    res, extra = {}, {}      # extra: beside the times, on the 1-kernel line
    lay = dev_tables["lay"]
    n_lines = lay["n_lines"].cpu().numpy()

    def record(name, err, fast, plain, moved, ops, library=None,
               plain_runs=20):
        """moved: bytes of every input and output once; ops: operations
        these inputs need; the bound is the larger of their times."""
        t_bytes = moved / PEAK_BYTES_PER_S * 1e3
        t_ops = ops / PEAK_OPS_PER_S * 1e3
        # the call's time first, as tools/kernel_ab.py takes them
        call_ms = median_ms(torch, fast)
        extra[name] = dict(device_ms=device_ms(torch, fast))
        res[name] = dict(
            max_abs_err=err, ms=call_ms,
            plain_ms=median_ms(torch, plain, plain_runs),
            bound_ms=max(t_bytes, t_ops),
            bound_by="bytes" if t_bytes >= t_ops else "operations",
            library_ms=median_ms(torch, library) if library else None)

    # K1: 1024 rows x 1024 lines at a 256-word bucket, realistic widths
    chunk = main_path_inputs(torch, dev_tables, pcm, blocks, stream)
    words_t, off, wid = chunk["k1"]
    mant = chunk["k1_mant"]
    check(bool(((off & 31) + wid > 32).any()), "K1 input has no field "
          "that spans two words")
    out = K.extract_codes(words_t, off, wid)
    plain = K.extract_codes_plain(words_t, off, wid)
    check(torch.equal(out, plain), "K1 differs from its plain version")
    check(np.array_equal(out.cpu().numpy(), mant), "K1 does not "
          "reproduce the repacked codes")
    # per field: two shifts, a funnel shift, a compare, address arithmetic
    record("extract_codes", 0.0, lambda: K.extract_codes(words_t, off, wid),
           lambda: K.extract_codes_plain(words_t, off, wid),
           nbytes(words_t, off, wid, out), 8 * out.numel())
    for name in K1_EDGES:
        e_words, e_off, e_wid = (torch.from_numpy(a.view(np.int32)).to(dev)
                                 for a in k1_edge(name))
        check(torch.equal(K.extract_codes(e_words, e_off, e_wid),
                          K.extract_codes_plain(e_words, e_off, e_wid)),
              f"K1 differs from its plain version on the edge input {name}")
    # the card's fixed cost of one launch, timed the same way: K1 on one
    # row of four fields
    tiny = [t[:1, :4].contiguous() for t in (words_t, off, wid)]
    extra["extract_codes"]["device_ms_one_row"] = device_ms(
        torch, lambda: K.extract_codes(*tiny))

    # K4 on the masker levels of one chunk (3072 rows)
    psy = dev_tables["psy"]
    args = chunk["k4"]
    iprime = args[0]
    check(iprime.shape == (3072, 1024), f"K4 rows {tuple(iprime.shape)}")
    out = K.spread_maskers_up(*args)
    plain = K.spread_maskers_up_plain(*args)
    err = (out - plain).abs()
    check(bool((err <= K4_RTOL * plain.abs() + 1e-30).all()),
          f"K4 beyond rtol {K4_RTOL}: max rel "
          f"{float((err / plain.abs().clamp(min=1e-30)).max())}")
    base = psy["quiet_i"][None] + torch.matmul(iprime, psy["nonup"])
    d_spl = (psycho.spl(base + out) - psycho.spl(base + plain)).abs().max()
    check(float(d_spl) <= K4_SPL_ATOL_DB, f"K4 threshold off by {d_spl} dB")
    for name in K4_EDGES:
        e_args = [torch.from_numpy(a).to(dev) for a in k4_edge(name)]
        e_out = K.spread_maskers_up(*e_args)
        e_plain = K.spread_maskers_up_plain(*e_args)
        check(bool(((e_out - e_plain).abs() <= K4_RTOL * e_plain.abs()).all()),
              f"K4 beyond rtol {K4_RTOL} on the edge input {name}")
    # operations: 6 per (row, peak masker, line on its upslope) triple
    reach = (psy["zvec"][None, :] - psy["bin_bark"][:, None] > 0.5).sum(1)
    triples = int(((iprime != 0).long() * reach[None, :]).sum())
    record("spread_maskers_up", float(err.max()),
           lambda: K.spread_maskers_up(*args),
           lambda: K.spread_maskers_up_plain(*args),
           nbytes(*args, out), 6 * triples)
    # beside the bound: one exp2 a triple on the special-function units,
    # 16 a clock on each SM, at the clock nvidia-smi reports after the runs
    clock = sm_clock_mhz()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    extra["spread_maskers_up"].update(
        exp2_count=triples, sm_clock_mhz=clock, sms=sms,
        peaks_per_row=float((iprime != 0).sum(1).float().mean()),
        sfu_floor_ms=triples / (sms * 16 * clock * 1e6) * 1e3)

    # K2: 512 rows of a chunk's real SMRs plus edge rows
    k2 = chunk["k2"]
    bits, left = K.water_fill(*k2)
    pbits, pleft = K.water_fill_plain(*k2)
    check(torch.equal(bits, pbits) and torch.equal(left, pleft),
          "K2 differs from its plain version")
    check(int(bits[32:48].max()) == 16, "K2 input never reaches the cap")
    check(int(bits[:16].abs().sum()) == 0, "K2 spent a zero budget")
    for name in K2_EDGES:
        e_args = [torch.from_numpy(a).to(dev) if isinstance(a, np.ndarray)
                  else a for a in k2_edge(name)]
        got, want = K.water_fill(*e_args), K.water_fill_plain(*e_args)
        check(torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]),
              f"K2 differs from its plain version on the edge input {name}")
    # operations: a greedy step is an argmax and a max over the bands
    # (2 x 25 compares and as many residuals); a row takes at least one
    # step per granted bit plus one per band to retire it
    steps = int(pbits.sum()) + pbits.shape[0] * pbits.shape[1]
    record("water_fill", 0.0, lambda: K.water_fill(*k2),
           lambda: K.water_fill_plain(*k2),
           nbytes(k2[0], *k2[2:], bits, left), 4 * 25 * steps)
    # the kernel's time is the longest row's chain of dependent steps
    extra["water_fill"].update(
        chain_steps_max=int(pbits.sum(1).max()) + pbits.shape[1])

    # K3: 1024 rows x 1148 items at n_words 256 and 968 (time at 256)
    err3 = 0.0
    for p0, p1, w0, n_words in k3_args(torch, dev):
        out = K.pack_words(p0, p1, w0, n_words)
        check(torch.equal(out, K.pack_words_plain(p0, p1, w0, n_words)),
              f"K3 differs from its plain version at n_words {n_words}")
    # the same function as two Tensor.scatter_add_ calls (indices made
    # beforehand; out-of-range parts go to a spare column)
    i0 = torch.where((w0 >= 0) & (w0 < 256), w0, 256).long()
    i1 = torch.where((w0 + 1 >= 0) & (w0 + 1 < 256), w0 + 1, 256).long()
    acc = torch.zeros((1024, 257), dtype=torch.int32, device=dev)

    def scatter():
        acc.zero_()
        acc.scatter_add_(1, i0, p0)
        acc.scatter_add_(1, i1, p1)

    scatter()
    check(torch.equal(acc[:, :256], out), "K3 differs from scatter_add_")
    record("pack_words", err3, lambda: K.pack_words(p0, p1, w0, 256),
           lambda: K.pack_words_plain(p0, p1, w0, 256),
           nbytes(p0, p1, w0, out), 2 * p0.numel(), library=scatter)
    phase1_pack(torch, chunk["k3"], record, extra)

    # K5: the first 1,024 channel-block rows of the 60 s stream at their
    # word bucket, plus 64 copies with one word XORed with random bits
    from pactpu_torch.codec.header import read_header
    from pactpu_torch.ops import huffman_decode as hd
    from pactpu_torch.ops.huffman import load_tables
    cfg, _, hoff = read_header(stream)
    walk_args, nk_t = chunk["k5"], chunk["k5_nbits"]
    wk_t, lut = walk_args[:2]
    bucket = wk_t.shape[1]
    check(wk_t.shape[0] == 1088, f"K5 rows {tuple(wk_t.shape)}")
    rec = K.huffman_walk(*walk_args)
    torch.cuda.synchronize()
    rec_plain = K.huffman_walk_plain(*walk_args)
    for name, a, b in zip(("code", "basf", "soff", "misc"), rec, rec_plain):
        check(torch.equal(a, b), f"K5 {name} differs from its plain version")
    parsed = hd.parse_post(rec, wk_t, nk_t, lay)
    check(not bool(parsed["bad"][:1024].any()), "K5 flags a clean row")
    check(bool(parsed["bad"][1024:].any()), "K5 flags no corrupted row")
    host = native.unpack_file(
        stream[hoff:], n_lines, cfg.n_scale_bits, cfg.n_mant_size_bits,
        cfg.n_table_id_bits, read_lrms=True, n_channels=2)
    for key in ("ba", "sf", "mant"):
        check(np.array_equal(parsed[key][:1024].cpu().numpy(),
                             host[key][:1024]),
              f"K5 + post-pass {key} differs from the host parser")
    # a block's LRMS flags are its last channel's row
    check(np.array_equal(
        parsed["lrms"][:1024].reshape(512, 2, -1)[:, -1].cpu().numpy() != 0,
        host["lrms"][:512] != 0),
        "K5 + post-pass lrms differs from the host parser")
    # K1 at the two shapes the post-pass gives it: one sign bit per line of
    # an active band, and the 25 LRMS flags behind the walk's end
    ba_k = torch.where((rec[1] & 0xFF) > 0, (rec[1] & 0xFF) + 1, 0)
    sign_off = (rec[2][:, lay["seg"]] + lay["line_in_band"]).to(
        torch.int32).contiguous()
    sign_w = (ba_k[:, lay["seg"]] > 0).to(torch.int32)
    lrms_pos = (rec[3][:, 3:4] + torch.arange(
        rec[1].shape[1], dtype=torch.int32, device=dev)).contiguous()
    for what, o, w in (("sign", sign_off, sign_w),
                       ("lrms", lrms_pos, torch.ones_like(lrms_pos))):
        check(torch.equal(K.extract_codes(wk_t, o, w),
                          K.extract_codes_plain(wk_t, o, w)),
              f"K1 differs from its plain version at the {what} shape")
        extra["extract_codes"][f"device_ms_{what}"] = device_ms(
            torch, lambda: K.extract_codes(wk_t, o, w))
    # K5 past the rows the default stream gives it: 1,024-word rows, and
    # the same bits read with 5 mantissa-size bits (allocations up to 32)
    wide_t = torch.nn.functional.pad(wk_t, (0, 1024 - bucket)).contiguous()
    for what, a in (("1,024-word rows", (wide_t, *walk_args[1:])),
                    ("5 size bits", (wide_t, *walk_args[1:4], 5,
                                     walk_args[5]))):
        got = K.huffman_walk(*a)
        for name, x, y in zip(("code", "basf", "soff", "misc"), got,
                              K.huffman_walk_plain(*a)):
            check(torch.equal(x, y),
                  f"K5 {name} differs from its plain version at {what}")
    for name in K5_EDGES:
        edge = k5_edge(name)
        a = (torch.from_numpy(edge["words"].view(np.int32)).to(dev),
             *walk_args[1:4], edge["size_bits"], walk_args[5])
        got = K.huffman_walk(*a)
        for what, x, y in zip(("code", "basf", "soff", "misc"), got,
                              K.huffman_walk_plain(*a)):
            check(torch.equal(x, y), f"K5 {what} differs from its plain "
                  f"version on the edge input {name}")
        if edge["want"] is not None:
            check(np.array_equal(got[0].cpu().numpy(), edge["want"])
                  and not bool(got[3][:, 2].any()),
                  f"K5 does not decode the edge input {name}")
    # operations: ~20 integer operations per decoded line, ~10 per band
    active = (rec[1] & 0xFF) > 0
    lines_of = (active.long() * lay["n_lines"][None, :]).sum(1)
    record("huffman_walk", 0.0, lambda: K.huffman_walk(*walk_args),
           lambda: K.huffman_walk_plain(*walk_args),
           nbytes(wk_t, *lut.values(), *rec),
           20 * int(lines_of.sum()) + 10 * active.numel(), plain_runs=3)
    # the kernel's time is the longest row's chain of dependent steps; a
    # step is longer for a code past the root table's 11 bits (the clean
    # rows' share of such lines, from the tables and the decoded symbols:
    # a symbol the row's table lacks was sent as an escape)
    tab_len, _, esc_len, _ = (torch.from_numpy(a).to(dev)
                              for a in load_tables())
    n_clean = wk_t.shape[0] - 64
    sym = rec[0][:n_clean].long()
    tab = (rec[3][:n_clean, 1].long() - 1).clamp(0, tab_len.shape[0] - 1)
    n_sym = tab_len.shape[1]
    ln = torch.where(sym < n_sym,
                     tab_len[tab[:, None], sym.clamp(max=n_sym - 1)], 0)
    ln = torch.where(ln > 0, ln, esc_len[tab][:, None])
    on_line = active[:n_clean][:, lay["seg"]]
    extra["huffman_walk"].update(
        chain_steps_max=int(lines_of.max()) + active.shape[1],
        lines_mean=float(lines_of.float().mean()),
        deep_share=float((on_line & (ln > K.WALK_ROOT_BITS)).sum()
                         / on_line.sum()))

    # K6 on the compacted weighted-mode maskers of the same chunk
    args6 = chunk["k6"]
    check(args6[0].shape == (3072, 513), f"K6 slots {tuple(args6[0].shape)}")
    out = K.spread_maskers(*args6)
    plain = K.spread_maskers_plain(*args6)
    err = (out - plain).abs()
    check(bool((err <= K6_RTOL * plain.abs() + 1e-30).all()),
          f"K6 beyond rtol {K6_RTOL}: max rel "
          f"{float((err / plain.abs().clamp(min=1e-30)).max())}")
    d_spl = (psycho.spl(psy["quiet_i"][None] + out)
             - psycho.spl(psy["quiet_i"][None] + plain)).abs().max()
    check(float(d_spl) <= K6_SPL_ATOL_DB, f"K6 threshold off by {d_spl} dB")
    for name in K6_EDGES:
        e_args = [torch.from_numpy(a).to(dev) for a in k6_edge(name)]
        e_out = K.spread_maskers(*e_args)
        e_plain = K.spread_maskers_plain(*e_args)
        check(bool(((e_out - e_plain).abs()
                    <= K6_RTOL * e_plain.abs() + 1e-30).all()),
              f"K6 beyond rtol {K6_RTOL} on the edge input {name}")
    # operations: 11 per (row, valid slot, line) triple
    triples = int(args6[3].sum()) * out.shape[1]
    record("spread_maskers", float(err.max()),
           lambda: K.spread_maskers(*args6),
           lambda: K.spread_maskers_plain(*args6),
           nbytes(*args6, out), 11 * triples)
    # beside the bound, as for K4: one exp2 a triple
    clock = sm_clock_mhz()
    extra["spread_maskers"].update(
        exp2_count=triples, sm_clock_mhz=clock, sms=sms,
        slots_per_row=float(args6[3].sum(1).mean()),
        sfu_floor_ms=triples / (sms * 16 * clock * 1e6) * 1e3)
    phase1_alloc(torch, dev_tables, pcm, record, res, extra)
    phase1_bands_f64_exact(torch, pcm, record, res, extra)
    phase1_reservoir(torch, pcm, record, extra)
    torch.cuda.synchronize()
    for name, r in res.items():
        say("1-kernel", name=name, **r, **extra[name])
    return res


def measured_chunks(torch, pcm: np.ndarray, seed: int = 11):
    """The reservoir measurement of pcm's encode (Engine.last_measure) cut
    into the Engine's chunks as K11 takes them: [(savings i32[n, 2],
    leftover i32[n], valid bool[n]), ...] on the device, the padded tail's
    rows seeded garbage that valid turns off; and the file's blocks."""
    from pactpu_torch import Engine
    from pactpu_torch.codec import engine as E
    eng = Engine(device=DEV)
    eng.encode(pcm)
    sav, left = eng.last_measure
    b = sav.shape[0]
    offs = E._offsets(E._chunk_sizes(b, E._pad_blocks(b)))
    rng = np.random.default_rng(seed)
    pad = offs[-1] - b
    sav = np.concatenate([sav, rng.integers(-5000, 5000, (pad, 2))])
    left = np.concatenate([left, rng.integers(-500, 500, pad)])
    t = lambda a: torch.from_numpy(np.ascontiguousarray(  # noqa: E731
        a, np.int32)).to(DEV)
    return [(t(sav[lo:hi]), t(left[lo:hi]),
             torch.arange(hi - lo, device=DEV) < b - lo)
            for lo, hi in zip(offs, offs[1:])], b, eng


def phase1_reservoir(torch, pcm: np.ndarray, record, extra: dict) -> None:
    """K11 bit for bit against its plain version on the measurements of
    pcm's encode, chunk by chunk with its carry on the device (the extras
    also against the host replay engine.reservoir_extras and the Engine's
    own last_extras), and on k11_edge's inputs; timed on a full chunk
    beside the launch floor."""
    from pactpu_torch.codec import engine as E
    from pactpu_torch.ops import kernels as K
    chunks, b, eng = measured_chunks(torch, pcm)
    div = eng.cfg.reservoir_withdraw_divisor
    carry_k = carry_p = torch.zeros(2, dtype=torch.int32, device="cuda")
    extras = []
    for k, (sav, left, valid) in enumerate(chunks):
        ek, carry_k = K.reservoir_scan(sav, left, valid, carry_k, div)
        ep, carry_p = K.reservoir_scan_plain(sav, left, valid, carry_p, div)
        check(torch.equal(ek.view(torch.int32), ep.view(torch.int32))
              and torch.equal(carry_k, carry_p),
              f"K11 differs from its plain version on chunk {k}")
        extras.append(ek)
    extras = torch.cat(extras).cpu().numpy()
    sav_h = torch.cat([c[0] for c in chunks]).cpu().numpy()[:b]
    left_h = torch.cat([c[1] for c in chunks]).cpu().numpy()[:b]
    host, host_carry = E.reservoir_extras(sav_h, left_h, div)
    check(np.array_equal(extras[:b], host.astype(np.float32))
          and not extras[b:].any()
          and tuple(carry_k.tolist()) == host_carry,
          "K11 differs from the host replay of the reservoir")
    check(np.array_equal(eng.last_extras, extras[:b]),
          "the Engine's extras differ from K11's")
    for name in K11_EDGES:
        s, lf, v, c, d = (torch.from_numpy(np.asarray(a)).to("cuda")
                          if isinstance(a, np.ndarray) else a
                          for a in k11_edge(name))
        got, want = K.reservoir_scan(s, lf, v, c, d), \
            K.reservoir_scan_plain(s, lf, v, c, d)
        check(torch.equal(got[0].view(torch.int32), want[0].view(torch.int32))
              and torch.equal(got[1], want[1]),
              f"K11 differs from its plain version on the edge input {name}")
    sav, left, valid = chunks[0]
    zero = torch.zeros(2, dtype=torch.int32, device="cuda")
    out = K.reservoir_scan(sav, left, valid, zero, div)
    # operations: about 10 integer operations a step (the division's
    # sequence counted as one)
    record("reservoir_scan", 0.0,
           lambda: K.reservoir_scan(sav, left, valid, zero, div),
           lambda: K.reservoir_scan_plain(sav, left, valid, zero, div),
           nbytes(sav, left, valid, zero, *out), 10 * sav.shape[0],
           plain_runs=5)
    extra["reservoir_scan"].update(
        blocks=sav.shape[0], chunks=len(chunks),
        launch_floor_ms=launch_floor_ms(torch),
        ptxas=ptxas_of("reservoir_scan"))


def ptxas_of(kernel: str) -> dict:
    """ptxas's registers and spill bytes for the entry function whose name
    holds `kernel`, from the kernels' build log."""
    from pactpu_torch.ops import kernels as K
    with open(K.BUILD_LOG) as f:
        lines = f.read().splitlines()
    out = {}
    for i, line in enumerate(lines):
        if "Compiling entry function" not in line or kernel not in line:
            continue
        for nxt in lines[i + 1:i + 6]:
            if m := re.search(r"(\d+) bytes spill stores, (\d+) bytes "
                              r"spill loads", nxt):
                out.update(spill_stores=int(m[1]), spill_loads=int(m[2]))
            if m := re.search(r"Used (\d+) registers", nxt):
                out["registers"] = int(m[1])
                break
    return out


def phase1_pack(torch, fields: tuple, record, extra: dict) -> None:
    """K3 as the engine launches it (kernels.pack_payload, through
    bitpack.pack_payload_bits) bit for bit against its plain version on a
    real chunk's payload fields at every word bucket and on the k3_edge
    rows; timed at 256 words beside the launch floor and the parent's way
    (pack_prologue_and_k3)."""
    from pactpu_torch import CodecConfig
    from pactpu_torch.ops import bitpack
    cfg = CodecConfig()
    layout = (cfg.band_layout.n_lines, cfg.n_scale_bits,
              cfg.n_mant_size_bits, cfg.n_table_id_bits)
    dev = fields[0].device
    check(fields[4].shape == (1024, 1024), "K3 payload rows "
          f"{tuple(fields[4].shape)}")
    for n_words in K3_WORDS:
        words, nbits = bitpack.pack_payload_bits(*fields, *layout, n_words)
        pw, pn = bitpack.pack_payload_bits_plain(*fields, *layout, n_words)
        check(torch.equal(words, pw) and torch.equal(nbits, pn),
              f"K3 pack_payload differs from its plain version at n_words "
              f"{n_words}")
        ow, on = pack_prologue_and_k3(fields, cfg, n_words)
        check(torch.equal(words, ow) and torch.equal(nbits, on),
              f"K3 pack_payload differs from the parts' K3 at {n_words}")
        for name in K3_EDGES:
            e = k3_tensors(torch, k3_edge(name, layout[0]), dev)
            got = bitpack.pack_payload_bits(*e, *layout, n_words)
            want = bitpack.pack_payload_bits_plain(*e, *layout, n_words)
            check(all(torch.equal(a, b) for a, b in zip(got, want)),
                  f"K3 pack_payload differs from its plain version on the "
                  f"edge rows {name} at n_words {n_words}")
    check(int(nbits.max()) <= 32 * 256, "a real row needs more than 256 "
          "words")
    words, nbits = bitpack.pack_payload_bits(*fields, *layout, 256)
    items, groups = bitpack.device_plan(tuple(layout[0]), *layout[1:],
                                        str(dev))
    rows = fields[0].shape[0]

    def fused():
        return bitpack.pack_payload_bits(*fields, *layout, 256)

    # bytes once: the fields, the plan, the words and nbits; operations
    # about 30 integer operations an item
    record("pack_payload", 0.0, fused,
           lambda: bitpack.pack_payload_bits_plain(*fields, *layout, 256),
           nbytes(*fields, items, groups, words, nbits),
           30 * rows * items.shape[0])
    parent = lambda: pack_prologue_and_k3(fields, cfg, 256)  # noqa: E731
    extra["pack_payload"].update(
        launch_floor_ms=launch_floor_ms(torch),
        parent_ms=median_ms(torch, parent),
        parent_device_ms=device_ms(torch, parent),
        rows=rows, items=int(items.shape[0]),
        nbits_mean=float(nbits.float().mean()),
        ptxas=ptxas_of("pack_payload_kernel"))


def phase1_alloc(torch, dev_tables, pcm: np.ndarray, record, res: dict,
                 extra: dict, blocks: int = 512) -> None:
    """Phase 1's checks of the other allocators' kernels: K8 closed_form
    and K9 grant_fill bit-equal with their plain versions on the rows of
    a real 512-block chunk (both channels, the flat per-channel budget;
    K8 also in float64 on the chunk's float64 analysis, K9 on its SMRs as
    const_mnr takes them and on its peak SPLs as const_snr does) and on
    every k8_edge / k9_edge input, K8 also on every k8_nonfinite input and
    past 128 bands (k8_wide); their times, steps a row and ns a step
    (the kernel's time alone over its longest row's chain), K8's time on
    rows that take no trip and the launch floor beside it; K9's walk:
    the grants its jump takes, the steps it walks one at a time and its
    probes (kernels.grant_fill_jump_plain), and its ns a walked step and a
    grant with the jump (k9_step_rows)."""
    from pactpu_torch import CodecConfig
    from pactpu_torch.codec import engine as E
    from pactpu_torch.ops import bitalloc
    from pactpu_torch.ops import kernels as K
    dev = torch.device("cuda")
    cfg = CodecConfig()
    nl = dev_tables["lay"]["n_lines"]
    budget = int(cfg.bit_budget())
    total = torch.full((2 * blocks,), budget, dtype=torch.int32, device=dev)
    cap = bitalloc._legacy_iter_bound(4 * max(budget, 1),
                                      cfg.band_layout.n_lines, cfg.n_bands)
    up = lambda a: torch.from_numpy(a).to(dev)  # noqa: E731

    def steps_of(plain, *args):
        stats = {}
        want = plain(*args, stats=stats)
        return want, stats

    # K8 on the chunk's rows, float32 then float64
    for prec in ("f32", "f64"):
        tables = dev_tables if prec == "f32" else E.device_tables(
            cfg, "cuda", "f64")
        args = k8_args(torch, tables, pcm, blocks)
        smr = args[1]
        got = K.closed_form(*args)
        want, stats = steps_of(K.closed_form_plain, *args)
        check(torch.equal(got, want),
              f"K8 ({prec}) differs from its plain version on the chunk")
        check(int(got.sum()) > 0, "K8's chunk input allocates nothing")
        moved = nbytes(total, smr, nl, got)
        ops = 4 * smr.shape[1] * stats["steps"]
        if prec == "f32":
            record("closed_form", 0.0, lambda: K.closed_form(*args),
                   lambda: K.closed_form_plain(*args), moved, ops,
                   plain_runs=3)
            r = extra["closed_form"]
        else:
            r = res["closed_form"]["f64"] = dict(
                ms=median_ms(torch, lambda: K.closed_form(*args)),
                device_ms=device_ms(torch, lambda: K.closed_form(*args)),
                plain_ms=median_ms(torch, lambda: K.closed_form_plain(*args),
                                   3))
            t_bytes = moved / PEAK_BYTES_PER_S * 1e3
            t_ops = ops / PEAK_F64_OPS_PER_S * 1e3
            r.update(bound_ms=max(t_bytes, t_ops),
                     bound_by="bytes" if t_bytes >= t_ops else "operations")
        r.update(chain_steps_max=stats["max_steps"],
                 steps_per_row=stats["steps"] / smr.shape[0],
                 ns_per_step=r["device_ms"] * 1e6 / max(stats["max_steps"],
                                                        1))
    for name, make in ([(n, k8_edge) for n in K8_EDGES]
                       + [(n, k8_nonfinite) for n in K8_NONFINITE]
                       + [("203-bands", k8_wide)]):
        e = [up(x) if isinstance(x, np.ndarray) else x for x in make(name)]
        for dt in (torch.float32, torch.float64):
            e[1] = e[1].to(dt)
            check(torch.equal(K.closed_form(*e), K.closed_form_plain(*e)),
                  f"K8 ({dt}) differs from its plain version on {name}")

    # K9 on the chunk's SMRs (const_mnr) and peak SPLs (const_snr); the
    # walk's grants (the plain version's steps) and the shorter walk of
    # K9's design as its plain mirror (grant_fill_jump_plain) takes it:
    # the grants the jump takes, the steps walked (all rows and the most
    # in a row) and the probes.  The mirror's counts, not the kernel's:
    # the card shows only that the kernel's result is the same
    for what, args in k9_args(torch, dev_tables, pcm, blocks).items():
        level = args[1]
        got = K.grant_fill(*args)
        want, stats = steps_of(K.grant_fill_plain, *args)
        check(torch.equal(got, want),
              f"K9 differs from its plain version on the chunk's {what} rows")
        jumped, walk = steps_of(K.grant_fill_jump_plain, *args)
        check(torch.equal(jumped, want), "K9's jump (plain) differs from "
              f"the steps on the chunk's {what} rows")
        walk = dict(mirror_walked_steps=walk["steps"],
                    mirror_walked_max_row=walk["max_walked"],
                    mirror_jumped_grants=walk["jumped"],
                    mirror_probes=walk["probes"])
        if what == "mnr":
            record("grant_fill", 0.0, lambda: K.grant_fill(*args),
                   lambda: K.grant_fill_plain(*args),
                   nbytes(total, level, nl, got),
                   4 * level.shape[1] * stats["steps"], plain_runs=3)
            r = extra["grant_fill"]
            r.update(chain_steps_max=stats["max_steps"],
                     steps_per_row=stats["steps"] / level.shape[0],
                     step_cap=cap, **walk,
                     ns_per_step=r["device_ms"] * 1e6
                     / max(stats["max_steps"], 1))
        else:
            ms = device_ms(torch, lambda: K.grant_fill(*args))
            extra["grant_fill"].update(
                snr_device_ms=ms, snr_chain_steps_max=stats["max_steps"],
                snr_steps_per_row=stats["steps"] / level.shape[0],
                **{f"snr_{k}": v for k, v in walk.items()})
    for name in K9_EDGES:
        t, lev, n_l, mm, bcap = k9_edge(name)
        e = (up(t), up(lev), up(n_l), mm,
             bitalloc._legacy_iter_bound(bcap, n_l, n_l.shape[0]))
        check(torch.equal(K.grant_fill(*e), K.grant_fill_plain(*e)),
              f"K9 differs from its plain version on {name}")
    # a step inside each chain, free of the launch and of what a row costs
    # besides its steps: the time alone on rows that take many steps less
    # the time on the same rows taking none.  K8: SMRs 300 dB on every band
    # but the last (0 dB), so that the init caps 24 bands at 16 bits, far
    # past a budget of 1,300 bits, against a budget past 16 bits on every
    # line (its time alone is kept too: the launch, one row's init and the
    # store, beside the launch floor); K9: levels near 200 dB and a budget
    # past 16 bits on every line (400 grants a row) against a zero budget
    rows = 2 * blocks
    many, none = k8_step_rows(torch, nl, rows)
    _, stats = steps_of(K.closed_form_plain, *many)
    _, zero = steps_of(K.closed_form_plain, *none)
    check(zero["max_steps"] == 0 and stats["max_steps"] > 100,
          "K8's step timing input takes other trips than planned")
    zero_ms = device_ms(torch, lambda: K.closed_form(*none))
    step = device_ms(torch, lambda: K.closed_form(*many)) - zero_ms
    extra["closed_form"].update(step_input_trips=stats["max_steps"],
                                step_ns=step * 1e6 / stats["max_steps"],
                                zero_trip_device_ms=zero_ms,
                                launch_floor_ms=launch_floor_ms(torch))
    # K9: a walked step on rows that cannot jump (a NaN level), and a grant
    # with the jump on the same finite rows ("ns a grant, jumps included")
    for form, (many, none, grants) in k9_step_rows(torch, nl, rows).items():
        _, stats = steps_of(K.grant_fill_plain, *many)
        _, walk = steps_of(K.grant_fill_jump_plain, *many)
        check(stats["max_steps"] == grants and torch.equal(
            K.grant_fill(*many), K.grant_fill_plain(*many)),
              f"K9's {form} timing input takes other grants than planned")
        check((walk["jumped"] == 0) == (form == "walk"),
              f"K9's {form} timing input jumps otherwise than planned")
        step = (device_ms(torch, lambda: K.grant_fill(*many))
                - device_ms(torch, lambda: K.grant_fill(*none)))
        key = "step_ns" if form == "jump" else "walked_step_ns"
        extra["grant_fill"].update({key: step * 1e6 / grants,
                                    f"{form}_input_grants": grants})
    # K2's ns a step (its time alone over its longest row's steps) beside
    # K8's and K9's
    k2_ns = (extra["water_fill"]["device_ms"] * 1e6
             / extra["water_fill"]["chain_steps_max"])
    for name in ("closed_form", "grant_fill"):
        extra[name]["k2_ns_per_step"] = k2_ns


def phase1_bands_f64_exact(torch, pcm: np.ndarray, record, res: dict,
                           extra: dict) -> None:
    """Phase 1's checks of the wider layouts, float64 and the exact mode:
    K2 past 32 bands and in float64, K4 in float64, K5 past 64 bands, and
    K7 on a real 512-block chunk of `pcm` in float32 and float64 (each
    bit-equal with its plain version, K4 within K4_F64_RTOL), with their
    times; a float64 form's times go under its kernel's "f64" key."""
    from pactpu_torch import CodecConfig, Engine
    from pactpu_torch.codec import engine as E
    from pactpu_torch.codec.header import read_header
    from pactpu_torch.ops import huffman_decode as hd
    from pactpu_torch.ops import huffman_walk as hw
    from pactpu_torch.ops import kernels as K
    dev = torch.device("cuda")
    blocks = 512

    def times(fast, plain, moved, ops, plain_runs=3):
        """A float64 form's times and its bound (float64 operations)."""
        t_bytes = moved / PEAK_BYTES_PER_S * 1e3
        t_ops = ops / PEAK_F64_OPS_PER_S * 1e3
        return dict(ms=median_ms(torch, fast),
                    device_ms=device_ms(torch, fast),
                    plain_ms=median_ms(torch, plain, plain_runs),
                    bound_ms=max(t_bytes, t_ops),
                    bound_by="bytes" if t_bytes >= t_ops else "operations")

    # K2 and K4 in float64 on the same chunk (precision="f64")
    cfg = CodecConfig()
    dev64 = E.device_tables(cfg, "cuda", "f64")
    chunk64 = main_path_inputs(torch, dev64, pcm, blocks,
                               parts=("k4", "k2", "k6"))
    k2 = chunk64["k2"]
    check(k2[3].dtype == torch.float64, "K2's float64 input is not float64")
    bits, left = K.water_fill(*k2)
    pbits, pleft = K.water_fill_plain(*k2)
    check(torch.equal(bits, pbits) and torch.equal(left, pleft),
          "K2's float64 form differs from its plain version")
    for name in K2_EDGES:
        e_args = [torch.from_numpy(a).to(dev) if isinstance(a, np.ndarray)
                  else a for a in k2_edge(name)]
        e_args[3] = e_args[3].double()
        got, want = K.water_fill(*e_args), K.water_fill_plain(*e_args)
        check(torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]),
              f"K2's float64 form differs from its plain version on {name}")
    k2_steps = int(pbits.sum()) + pbits.shape[0] * pbits.shape[1]
    res["water_fill"]["f64"] = dict(
        times(lambda: K.water_fill(*k2), lambda: K.water_fill_plain(*k2),
              nbytes(k2[0], *k2[2:], bits, left), 4 * 25 * k2_steps),
        chain_steps_max=int(pbits.sum(1).max()) + pbits.shape[1])
    args = chunk64["k4"]
    check(args[0].dtype == torch.float64, "K4's float64 input is not float64")
    out = K.spread_maskers_up(*args)
    plain = K.spread_maskers_up_plain(*args)
    err = (out - plain).abs()
    rel = float((err / plain.abs().clamp(min=1e-300)).max())
    check(bool((err <= K4_F64_RTOL * plain.abs() + 1e-300).all()),
          f"K4's float64 form beyond rtol {K4_F64_RTOL}: max rel {rel}")
    for name in K4_EDGES:
        e_args = [torch.from_numpy(a).to(dev).double() for a in k4_edge(name)]
        e_out = K.spread_maskers_up(*e_args)
        e_plain = K.spread_maskers_up_plain(*e_args)
        check(bool(((e_out - e_plain).abs()
                    <= K4_F64_RTOL * e_plain.abs()).all()),
              f"K4's float64 form beyond rtol {K4_F64_RTOL} on {name}")
    psy64 = dev64["psy"]
    reach = (psy64["zvec"][None, :] - psy64["bin_bark"][:, None] > 0.5).sum(1)
    triples = int(((args[0] != 0).long() * reach[None, :]).sum())
    res["spread_maskers_up"]["f64"] = dict(
        times(lambda: K.spread_maskers_up(*args),
              lambda: K.spread_maskers_up_plain(*args),
              nbytes(*args, out), 6 * triples),
        max_abs_err=float(err.max()), max_rel_err=rel)

    # K6 in float64 on the chunk's weighted-mode maskers (precision="f64")
    args = chunk64["k6"]
    check(args[0].dtype == torch.float64, "K6's float64 input is not float64")
    out = K.spread_maskers(*args)
    plain = K.spread_maskers_plain(*args)
    err = (out - plain).abs()
    rel = float((err / plain.abs().clamp(min=1e-300)).max())
    check(bool((err <= K6_F64_RTOL * plain.abs() + 1e-300).all()),
          f"K6's float64 form beyond rtol {K6_F64_RTOL}: max rel {rel}")
    for name in K6_EDGES:
        e_args = [torch.from_numpy(a).to(dev).double() for a in k6_edge(name)]
        e_out = K.spread_maskers(*e_args)
        e_plain = K.spread_maskers_plain(*e_args)
        check(bool(((e_out - e_plain).abs()
                    <= K6_F64_RTOL * e_plain.abs() + 1e-300).all()),
              f"K6's float64 form beyond rtol {K6_F64_RTOL} on {name}")
    triples = int(args[3].sum()) * out.shape[1]
    res["spread_maskers"]["f64"] = dict(
        times(lambda: K.spread_maskers(*args),
              lambda: K.spread_maskers_plain(*args),
              nbytes(*args, out), 11 * triples),
        max_abs_err=float(err.max()), max_rel_err=rel, exp2_count=triples)

    # K5 past 64 bands: a 96-band stream's rows and random rows
    wide = CodecConfig(band_line_counts=WIDE_BANDS)
    stream = Engine(device="cuda", cfg=wide).encode(pcm[:2 * FS])
    rows_w, _ = hd.frame_rows(stream[read_header(stream)[2]:])
    rng = np.random.default_rng(96)
    garbage = rng.integers(0, 2 ** 32, (64, rows_w.shape[1]),
                           dtype=np.uint64).astype(np.uint32)
    for what, words in (("stream", rows_w), ("garbage", garbage)):
        a = (torch.from_numpy(words.view(np.int32)).to(dev),
             hw.device_walk_lut(device=dev), wide.band_layout.n_lines,
             wide.n_scale_bits, wide.n_mant_size_bits, wide.n_table_id_bits)
        got = K.huffman_walk(*a)
        for name, x, y in zip(("code", "basf", "soff", "misc"), got,
                              K.huffman_walk_plain(*a)):
            check(torch.equal(x, y), f"K5 {name} differs from its plain "
                  f"version on the 96-band {what} rows")
    extra["huffman_walk"]["bands_96_rows"] = int(rows_w.shape[0])

    # K10 on the first 512 blocks of the file, float32 then float64, bit
    # for bit; then a mono chunk, a trained table set, the 96-band layout
    # and 6 mantissa-size bits
    for prec, tables in (("f32", E.device_tables(cfg, "cuda")),
                         ("f64", dev64)):
        a10 = k10_args(torch, cfg, tables, pcm, blocks)
        # the table set packed once, as the exact mode keeps it
        packed = K.pack_tables(a10[2], a10[3])
        out = K.cost_table(*a10, packed)
        check(torch.equal(out, K.cost_table_plain(*a10)),
              f"K10 ({prec}) differs from its plain version")
        # bytes: the lines, the packed table set and the band layout in,
        # the cost out; operations: per line and allocation the
        # quantizer's (about 8) and one length a table
        lines = a10[0].numel()
        moved = nbytes(a10[0], a10[1]["n_lines"], packed[0], out)
        ops = a10[5] * lines * (8 + a10[2].shape[0])
        if prec == "f32":
            record("cost_table", 0.0, lambda: K.cost_table(*a10, packed),
                   lambda: K.cost_table_plain(*a10), moved, ops, plain_runs=3)
            r = extra["cost_table"]
        else:
            r = res["cost_table"]["f64"] = times(
                lambda: K.cost_table(*a10, packed),
                lambda: K.cost_table_plain(*a10), moved, ops)
        r.update(items=a10[0].shape[0] * a10[0].shape[1],
                 allocations=a10[5], cost_bytes=nbytes(out),
                 packed_bytes=nbytes(packed[0]))
    for what, c10, tabs in (
            ("mono", CodecConfig(n_channels=1), None),
            ("trained tables", cfg, trained_tables()),
            ("full tables", cfg, full_tables()),
            ("96 bands", wide, None),
            ("6 size bits", CodecConfig(n_mant_size_bits=6), None)):
        a10 = k10_args(torch, c10, E.device_tables(c10, "cuda"), pcm, 64,
                       tabs)
        check(torch.equal(K.cost_table(*a10), K.cost_table_plain(*a10)),
              f"K10 differs from its plain version on the {what} chunk")

    # K7 on the first 512 blocks of the file, float32 then float64, from a
    # zero carry; then the chain on: a 300-block tail from its carry.  The
    # kernel jumps (kernels.water_fill_row_jump_plain): "steps" is the
    # greedy steps of the chain (the plain version without the jump), the
    # kernel walks "walked_steps" of them one at a time
    steps = {}
    for prec, tables in (("f32", E.device_tables(cfg, "cuda")),
                         ("f64", dev64)):
        a7 = k7_args(torch, cfg, tables, pcm, blocks)
        # the valid mask read on the device, as the exact mode's program
        # hands it over (the count form: the tail below)
        a7 = (*a7[:3], torch.arange(blocks, device=dev) < a7[3], *a7[4:])
        ex, carry = K.exact_scan(*a7)
        stats = dict(steps=0, fills=0)
        walked = dict(steps=0, fills=0)
        pex, pcarry = K.exact_scan_plain(*a7, stats=stats, jump=False)
        check(torch.equal(ex, pex) and torch.equal(carry, pcarry),
              f"K7 ({prec}) differs from its plain version")
        check(all(torch.equal(x, y) for x, y in zip(
            (pex, pcarry), K.exact_scan_plain(*a7, stats=walked)))
            and walked["steps"] < stats["steps"],
            f"K7's plain jump ({prec}) differs from the greedy steps")
        tail = (*a7[:3], 300, carry, *a7[5:])
        masked = (*a7[:3], torch.arange(blocks, device=dev) < 300, carry,
                  *a7[5:])
        want = K.exact_scan_plain(*tail)
        check(all(torch.equal(x, y) for got in (
            K.exact_scan(*tail), K.exact_scan(*masked),
            K.exact_scan_plain(*masked)) for x, y in zip(got, want)),
            f"K7 ({prec}) differs from its plain version on a padded tail "
            "(a count or a valid mask)")
        steps[prec] = stats
        # bytes: what the scan reads of the cost table (each fill's gathered
        # row, bands x tables), the SMRs, LRMS flags and line counts, the
        # extras and the carry in and out; operations: a greedy step
        # compares and selects over the bands
        smr, lrms, cost = a7[:3]
        gathered = stats["fills"] * smr.shape[2] * cost.shape[4] * 4
        moved = gathered + nbytes(smr, lrms, a7[6], ex) + 16
        ops = 4 * smr.shape[2] * stats["steps"]
        if prec == "f32":
            record("exact_scan", 0.0, lambda: K.exact_scan(*a7),
                   lambda: K.exact_scan_plain(*a7), moved, ops, plain_runs=1)
            r = extra["exact_scan"]
        else:
            r = res["exact_scan"]["f64"] = times(
                lambda: K.exact_scan(*a7), lambda: K.exact_scan_plain(*a7),
                moved, ops, plain_runs=1)
        r.update(chain_steps=stats["steps"], fills=stats["fills"],
                 ns_per_step=r["device_ms"] * 1e6 / max(stats["steps"], 1),
                 gathered_cost_bytes=gathered,
                 walked_steps=walked["steps"], jumped=walked["jumped"],
                 probes=walked["probes"])
    # K7's step inside its chain and its cost around each fill: SMRs near
    # 200 dB (the stop rule never fires) and a zero cost table, with a
    # budget that takes every band to the cap (16 steps a band) or pays for
    # none (one step a band); the difference is free of what a fill costs
    # besides its steps.  A NaN SMR in band 0 keeps the kernel from
    # jumping (its grants come first, to the cap), so both take the steps
    rng = np.random.default_rng(7)
    for prec, dt in (("f32", torch.float32), ("f64", torch.float64)):
        smr = torch.from_numpy(200 + rng.random((blocks, 2, 25))).to(dt)
        smr[:, :, 0] = float("nan")
        a7 = (smr.to(dev), torch.zeros((blocks, 25), dtype=torch.bool,
                                       device=dev),
              torch.zeros((blocks, 2, 25, 17, 10), dtype=torch.int32,
                          device=dev), blocks,
              torch.zeros(2, dtype=torch.int32, device=dev))
        ms = {}
        for budget, per_band in ((1e5, 16), (-1e5, 1)):
            args = (*a7, budget, dev64["lay"]["n_lines"], 16, -5.0, -15.0, 4,
                    100)
            stats = dict(steps=0, fills=0)
            if per_band == 1:
                K.exact_scan_plain(*args, stats=stats)
                check(stats["steps"] == blocks * 2 * 25,
                      "K7's timing input takes other steps than planned")
            ms[per_band] = device_ms(torch, lambda: K.exact_scan(*args))
        fills = blocks * 2
        step = (ms[16] - ms[1]) / (fills * 25 * 15)
        r = extra["exact_scan"] if prec == "f32" else res["exact_scan"]["f64"]
        r.update(fill_ns_per_step=step * 1e6,
                 fill_overhead_us=(ms[1] / fills - 25 * step) * 1e3)
    # beside the bound, the dependent chain's: blocks x channels x greedy
    # steps (this chunk's) x one step at K2's (K2's time alone over its
    # longest row's steps)
    k2_ns = (extra["water_fill"]["device_ms"] * 1e6
             / extra["water_fill"]["chain_steps_max"])
    k2_ns64 = (res["water_fill"]["f64"]["device_ms"] * 1e6
               / res["water_fill"]["f64"]["chain_steps_max"])
    extra["exact_scan"].update(
        k2_ns_per_step=k2_ns,
        chain_bound_ms=steps["f32"]["steps"] * k2_ns * 1e-6)
    res["exact_scan"]["f64"].update(
        k2_ns_per_step=k2_ns64,
        chain_bound_ms=steps["f64"]["steps"] * k2_ns64 * 1e-6)
    # K7's other shapes: mono, 40 bands (two a lane) and the 96-band layout
    # (three bands a lane, its cost rows read from device memory)
    for what, c7 in (("mono", CodecConfig(n_channels=1)),
                     ("40 bands", CodecConfig(band_line_counts=BANDS_40)),
                     ("96 bands", wide)):
        a7 = k7_args(torch, c7, E.device_tables(c7, "cuda"), pcm, 64, 50,
                     (1234, -56))
        check(all(torch.equal(x, y) for x, y in zip(
            K.exact_scan(*a7), K.exact_scan_plain(*a7))),
            f"K7 differs from its plain version on the {what} chunk")


def check_launched(launches: dict, names, path: str) -> None:
    for name in names:                 # (the CPU rehearsal launches none)
        check(launches[name] > 0 or DEV == "cpu",
              f"kernel {name} was never launched on {path}")


def parses_back(stream: bytes, cfg, pcm: np.ndarray) -> None:
    from pactpu_torch import native
    from pactpu_torch.codec.header import read_header
    parsed = native.unpack_file(
        stream[read_header(stream)[2]:],
        np.asarray(cfg.band_layout.n_lines, np.int32), cfg.n_scale_bits,
        cfg.n_mant_size_bits, cfg.n_table_id_bits)
    check(parsed["n_cblocks"] == 2 * n_blocks(pcm),
          "stream does not parse back to its block count")


def phase2(torch, eng, files):
    from pactpu_torch.ops import kernels as K
    eng.decode(eng.encode(files[0][:FS]))            # warm the libraries
    sync(torch)
    K.reset_launches()
    serial = []
    for pcm in files:
        s = eng.encode(pcm)
        serial.append((s, eng.decode(s)))
    batch, streams = eng.roundtrip_many(files, return_streams=True)
    sync(torch)
    launches = dict(K.LAUNCHES)
    snrs = []
    cfg = eng.cfg
    for pcm, (s, (fs, out)), (fs2, out2), s2 in zip(files, serial, batch,
                                                   streams):
        check(s == s2, "roundtrip_many stream differs from serial encode")
        check(fs == fs2 == FS and np.array_equal(out, out2),
              "roundtrip_many PCM differs from serial decode")
        check(out.shape[0] >= pcm.shape[0], "decoded PCM too short")
        parses_back(s, cfg, pcm)
        snr = snr_db(pcm, out)
        check(np.isfinite(snr) and snr > SNR_FLOOR_DB,
              f"SNR {snr:.2f} dB not above the {SNR_FLOOR_DB} dB floor")
        snrs.append(round(snr, 3))
    check_launched(launches, [k for k, v in PATH_OF.items() if v == "main"],
                   "the main path")
    check(launches["pack_words"] == 0, "the main path packed through the "
          "pre-shifted parts' K3 (pack_words)")
    say("2-main-path", files=len(files),
        blocks=[n_blocks(p) for p in files], snr_db=snrs,
        bytes=[len(s) for s, _ in serial], launches=launches)
    return launches, [s for s, _ in serial], [out for _, (_, out) in serial]


def fixture_decode(eng, path: str = FIXTURE, prefix: str = ""):
    """Decode the stream of a JAX-made fixture (its arrays `prefix`pcm,
    stream and decoded): within 1 LSB of the JAX PCM.  Returns (input pcm,
    stream, JAX pcm, |difference|)."""
    z = np.load(path)
    pcm, stream, ref = (z[prefix + "pcm"], z[prefix + "stream"].tobytes(),
                        z[prefix + "decoded"])
    fs, out = eng.decode(stream)
    check(out.shape == ref.shape, "fixture decode has the wrong shape")
    d = np.abs(out.astype(np.int32) - ref.astype(np.int32))
    check(int(d.max()) <= 1, f"fixture decode off by {int(d.max())} LSB")
    return pcm, stream, ref, d


def phase3(eng, path: str = FIXTURE, phase: str = "3-fixture",
           prefix: str = "") -> None:
    pcm, stream, ref, d = fixture_decode(eng, path, prefix)
    mine = eng.encode(pcm)
    _, mine_pcm = eng.decode(mine)
    rj, rt = rows_of(stream), rows_of(mine)
    snr_j, snr_t = snr_db(pcm, ref), snr_db(pcm, mine_pcm)
    check(abs(snr_j - snr_t) <= 0.1,
          f"re-encode SNR {snr_t:.3f} dB vs JAX {snr_j:.3f} dB")
    check(abs(len(mine) - len(stream)) <= 0.01 * len(stream),
          f"re-encode size {len(mine)} vs JAX {len(stream)}")
    say(phase, identical_share=float((d == 0).mean()),
        max_lsb=int(d.max()), rows=len(rj),
        rows_differing=sum(a != b for a, b in zip(rj, rt)) + abs(
            len(rj) - len(rt)),
        snr_jax_db=round(snr_j, 4), snr_port_db=round(snr_t, 4),
        bytes_jax=len(stream), bytes_port=len(mine))


def phase4(torch, eng, eng_dev, files, streams, reps: int = 3) -> None:
    """eng decodes by host parse, eng_dev by device parse."""
    blocks = sum(n_blocks(p) for p in files)
    serial, batch = [], []
    decode = {"host": [], "device": []}
    for _ in range(reps):
        t0 = time.perf_counter()
        for pcm in files:
            eng.decode(eng.encode(pcm))
        serial.append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        eng.roundtrip_many(files)
        batch.append(time.perf_counter() - t0)
        for route, e in (("host", eng), ("device", eng_dev), ("device",
                         eng_dev), ("host", eng)):
            t0 = time.perf_counter()
            for s in streams:
                e.decode(s)
            decode[route].append(time.perf_counter() - t0)
    say("4-throughput", blocks=blocks,
        decode_host_parse_blocks_per_s=[round(blocks / s, 1)
                                        for s in decode["host"]],
        decode_device_parse_blocks_per_s=[round(blocks / s, 1)
                                          for s in decode["device"]],
        serial_blocks_per_s=[round(blocks / s, 1) for s in serial],
        batch_blocks_per_s=[round(blocks / s, 1) for s in batch],
        peak_mem_mb=(round(torch.cuda.max_memory_allocated() / 2 ** 20, 1)
                     if DEV != "cpu" else None))


def phase5(torch, eng_dev, streams, host_pcm) -> dict:
    """The device-parse decode route against the host route's PCM."""
    from pactpu_torch.codec.header import read_header
    from pactpu_torch.ops import kernels as K
    eng_dev.decode(streams[0])                       # warm (LUT upload)
    sync(torch)
    K.reset_launches()
    outs = [eng_dev.decode(s) for s in streams]
    sync(torch)
    launches = dict(K.LAUNCHES)
    for (fs, out), ref in zip(outs, host_pcm):
        check(fs == FS and np.array_equal(out, ref),
              "device-parse PCM differs from the host-parse PCM")
    check_launched(launches, ["huffman_walk", "extract_codes"],
                   "the device-parse route")
    _, stream, _, d = fixture_decode(eng_dev)
    # table id 15 in the first channel-block (the byte behind its prefix)
    hoff = read_header(stream)[2]
    bad = bytearray(stream)
    bad[hoff + 4] |= 0x0F
    try:
        eng_dev.decode(bytes(bad))
    except ValueError as e:
        msg = str(e)
    else:
        raise SmokeError("device-parse decoded a corrupt stream")
    say("5-device-parse", streams=len(streams), launches=launches,
        fixture_identical_share=float((d == 0).mean()),
        fixture_max_lsb=int(d.max()), corrupt=msg)
    return launches


def phase6(torch, make_engine, pcm) -> dict:
    """The aidan peak modes: encode -> decode of one file per mode, in
    float32 and in float64 (K6's float64 form)."""
    from pactpu_torch import CodecConfig
    from pactpu_torch.ops import kernels as K
    launches = {}
    for mode, prec in (("para", "f32"), ("weighted", "f32"),
                       ("para", "f64"), ("weighted", "f64")):
        eng = make_engine(cfg=CodecConfig(peak_mode=mode), precision=prec)
        sync(torch)
        K.reset_launches()
        stream = eng.encode(pcm)
        fs, out = eng.decode(stream)
        sync(torch)
        launches[mode, prec] = dict(K.LAUNCHES)
        check_launched(launches[mode, prec],
                       ["spread_maskers", "water_fill", "pack_payload"],
                       f"the {mode} {prec} path")
        check(launches[mode, prec]["spread_maskers_up"] == 0,
              f"the {mode} {prec} path ran the dense upslope kernel")
        parses_back(stream, eng.cfg, pcm)
        snr = snr_db(pcm, out)
        check(fs == FS and np.isfinite(snr) and snr > SNR_FLOOR_DB,
              f"{mode} {prec}: SNR {snr:.2f} dB not above the "
              f"{SNR_FLOOR_DB} dB floor")
        say("6-aidan", mode=mode, precision=prec, blocks=n_blocks(pcm),
            bytes=len(stream), snr_db=round(snr, 3),
            launches=launches[mode, prec])
        if mode == "weighted" and prec == "f32":
            phase3(eng, FIXTURE_WEIGHTED, "6-aidan-fixture")
    return launches["weighted", "f32"]


# phase 7: (name, CodecConfig fields, Engine fmt); each the default
# configuration but for the fields named
MODES = (("mono-wak", dict(n_channels=1), "wak"),
         ("stereo-pac", {}, "pac"),
         ("mono-pac", dict(n_channels=1), "pac"),
         ("kbd-wak", dict(window="kbd"), "wak"),
         ("bitalloc-wak", dict(ms_decision="bitalloc"), "wak"))
# the modes with a JAX fixture (their prefix in FIXTURE_MODES)
MODE_FIXTURES = {"mono-wak": "mono_wak_", "stereo-pac": "stereo_pac_"}


def mode_needs(fmt: str) -> dict:
    """The kernels each step of a mode must launch: K4 and K2 on every
    encode, K3 on the .wak packer; K1 on the host-parse decode; K5 (and K1
    for signs and flags) on the .wak device-parse decode, K1 alone on the
    .pac one."""
    wak = fmt == "wak"
    return {"encode": ["spread_maskers_up", "water_fill"]
            + (["pack_payload"] if wak else []),
            "decode-host": ["extract_codes"],
            "decode-device": ["extract_codes"]
            + (["huffman_walk"] if wak else [])}


def phase7(torch, make_engine, files) -> dict:
    """The codec modes beside the main path (MODES): for each, encode ->
    decode of files[0] by both parse routes (the same samples), the
    launches of each step, roundtrip_many of all files against serial
    encode and decode, SNR above the floor; the mono modes take channel 0.
    The modes with a JAX fixture decode it within 1 LSB by both routes and
    re-encode it within 0.1 dB and 1%.  Returns each mode's launches
    (encode and both decodes)."""
    from pactpu_torch import CodecConfig
    from pactpu_torch.ops import kernels as K
    launches = {}
    for name, fields, fmt in MODES:
        cfg = CodecConfig(**fields)
        eng = make_engine(cfg=cfg, fmt=fmt)
        eng_dev = make_engine(cfg=cfg, fmt=fmt, decode_parse="device")
        pcms = [np.ascontiguousarray(f[:, :cfg.n_channels]) for f in files]
        counts = {}

        def counted(step, fn, arg):
            sync(torch)
            K.reset_launches()
            out = fn(arg)
            sync(torch)
            counts[step] = dict(K.LAUNCHES)
            return out

        stream = counted("encode", eng.encode, pcms[0])
        fs, out = counted("decode-host", eng.decode, stream)
        fs2, out2 = counted("decode-device", eng_dev.decode, stream)
        check(fs == fs2 == FS and np.array_equal(out, out2),
              f"{name}: the device-parse PCM differs from the host-parse")
        for step, names in mode_needs(fmt).items():
            check_launched(counts[step], names, f"{name} {step}")
        batch, streams = eng.roundtrip_many(pcms, return_streams=True)
        check(streams[0] == stream and np.array_equal(batch[0][1], out),
              f"{name}: roundtrip_many differs from serial")
        for pcm, s, (_, o) in zip(pcms[1:], streams[1:], batch[1:]):
            check(s == eng.encode(pcm) and np.array_equal(o, eng.decode(s)[1]),
                  f"{name}: roundtrip_many differs from serial")
        snr = snr_db(pcms[0], out)
        check(np.isfinite(snr) and snr > SNR_FLOOR_DB,
              f"{name}: SNR {snr:.2f} dB not above the {SNR_FLOOR_DB} dB "
              "floor")
        launches[name] = {k: sum(c[k] for c in counts.values())
                          for k in K.LAUNCHES}
        say("7-modes", mode=name, fmt=fmt, blocks=n_blocks(pcms[0]),
            bytes=len(stream), snr_db=round(snr, 3), launches=counts)
        if name in MODE_FIXTURES:
            phase3(eng, FIXTURE_MODES, f"7-modes-fixture-{name}",
                   MODE_FIXTURES[name])
            d = fixture_decode(eng_dev, FIXTURE_MODES, MODE_FIXTURES[name])[3]
            say(f"7-modes-fixture-{name}-device-parse",
                identical_share=float((d == 0).mean()), max_lsb=int(d.max()))
    return launches


ALLOC_MODES = ("closed_form", "uniform", "const_snr", "const_mnr")
# the kernel each allocator's finalize launches in place of K2
ALLOC_KERNEL = {"closed_form": "closed_form", "uniform": None,
                "const_snr": "grant_fill", "const_mnr": "grant_fill"}


def trained_tables():
    """A table set of eight tables trained from geometric symbol
    histograms made from a seed (pactpu_torch.ops.huffman_train), as
    Engine(tables=...) takes it."""
    from pactpu_torch.ops import huffman_train as ht
    rng = np.random.default_rng(3)
    hists = {}
    for tid in range(1, 9):
        h = np.zeros(ht.NUM_SYMBOLS, np.int64)
        np.add.at(h, np.minimum(rng.geometric(0.4 / tid, 50_000),
                                ht.NUM_SYMBOLS - 1), 1)
        hists[tid] = h
    return tuple(np.ascontiguousarray(t, np.int32)
                 for t in ht.train_tables(hists))


def full_tables(n_tables: int = 10):
    """A table set with a code on every symbol (lengths 9..31, varying by
    symbol and table; escape lengths 5..): K10's packed set is 256 KB, past
    a CTA's shared memory, so the kernel reads it from device memory.  As
    Engine(tables=...) takes a set; only the lengths are read."""
    n_sym = 1 << 15
    lengths = (9 + (np.arange(n_sym)[None] * 7 + np.arange(n_tables)[:, None])
               % 23).astype(np.int32)
    return (lengths, np.zeros_like(lengths),
            np.arange(5, 5 + n_tables, dtype=np.int32),
            np.zeros(n_tables, np.int32))


def unfit_tables(n_tables: int = 10):
    """A Huffman table set outside K5's LUT: every table codes symbols
    0..4094 with 12-bit codes (and the escape as the 4,096th), so each has
    2,048 prefixes deeper than the 11-bit root table, past the LUT's 128.
    Valid for the encoder and the host parser."""
    n_sym = 1 << 15
    lengths = np.zeros((n_tables, n_sym), np.int32)
    codes = np.zeros((n_tables, n_sym), np.int32)
    lengths[:, :4095] = 12
    codes[:, :4095] = np.arange(4095)
    return (lengths, codes, np.full(n_tables, 12, np.int32),
            np.full(n_tables, 4095, np.int32))


def phase9(torch, make_engine, files) -> dict:
    """The other allocators and the rest of the Engine surface.

    Each allocator in cbr and reservoir: encode -> decode of files[0] by
    both routes (the same samples), roundtrip_many of all files against
    serial, SNR above the floor, the launches of each step (K8 for
    closed_form, K9 for const_snr/const_mnr, one a channel a pass and
    chunk, none of K2; neither for uniform); pactpu's stream of the same
    allocator and rate mode (FIXTURE_ALLOC) decoded by both routes within
    1 LSB of the float64 oracle's decode (pactpu_torch.compat.refcodec,
    which the CPU tests hold within 1 LSB of pactpu's) and re-encoded
    within 0.1 dB and 1%.  Then a table set trained on the card from the
    engine's own symbols (huffman_train): its cbr stream decodes by both
    routes to the samples of the shipped tables' cbr stream; pactpu's
    stream on its trained tables decodes by both routes alike; a table
    set outside K5's LUT encodes and decodes by host parse and raises on
    decode_parse="device"; device_pack=False gives the same bytes with no
    K3 launch; debug_checks=True gives the same bytes.  Returns each
    allocator's launches (its reservoir encode and both decodes)."""
    from pactpu_torch import CodecConfig
    from pactpu_torch.codec import engine as E
    from pactpu_torch.compat import refcodec
    from pactpu_torch.ops import huffman_train
    from pactpu_torch.ops import kernels as K
    fx = np.load(FIXTURE_ALLOC)
    fx_pcm = np.load(FIXTURE)["pcm"]
    pcm = files[0]
    counts = {}

    def counted(key, fn, arg):
        sync(torch)
        K.reset_launches()
        out = fn(arg)
        sync(torch)
        counts[key] = dict(K.LAUNCHES)
        return out

    b = n_blocks(pcm) + 1
    chunks = len(E._chunk_sizes(b, E._pad_blocks(b)))
    launches = {}
    for alloc in ALLOC_MODES:
        for rate in ("cbr", "reservoir"):
            cfg = CodecConfig(alloc_mode=alloc)
            eng = make_engine(cfg=cfg, rate_mode=rate)
            eng_dev = make_engine(cfg=cfg, rate_mode=rate,
                                  decode_parse="device")
            tag = f"{alloc}-{rate}"
            stream = counted((tag, "encode"), eng.encode, pcm)
            fs, out = counted((tag, "decode-host"), eng.decode, stream)
            fs2, out2 = counted((tag, "decode-device"), eng_dev.decode,
                                stream)
            check(fs == fs2 == FS and np.array_equal(out, out2),
                  f"{tag}: the device-parse PCM differs from the host-parse")
            enc = counts[tag, "encode"]
            kern = ALLOC_KERNEL[alloc]
            passes = 2 if rate == "reservoir" else 1
            check_launched(enc, ["spread_maskers_up", "pack_payload"]
                           + ([kern] if kern else []), f"{tag} encode")
            if DEV != "cpu":
                # one launch a channel, pass and chunk (a chunk re-finalized
                # for a wider packer adds its own)
                check(kern is None or enc[kern] >= 2 * passes * chunks,
                      f"{tag}: {enc.get(kern)} launches of {kern}, expected "
                      f"{2 * passes * chunks}")
                check(enc["water_fill"] == 0 and all(
                    enc[k] == 0 for k in ("closed_form", "grant_fill")
                    if k != kern), f"{tag} ran another allocator's kernel")
            check_launched(counts[tag, "decode-host"], ["extract_codes"],
                           f"{tag} decode-host")
            check_launched(counts[tag, "decode-device"],
                           ["huffman_walk", "extract_codes"],
                           f"{tag} decode-device")
            batch, streams = eng.roundtrip_many(files, return_streams=True)
            check(streams[0] == stream and np.array_equal(batch[0][1], out),
                  f"{tag}: roundtrip_many differs from serial")
            for p, st, (_, o) in zip(files[1:], streams[1:], batch[1:]):
                check(st == eng.encode(p)
                      and np.array_equal(o, eng.decode(st)[1]),
                      f"{tag}: roundtrip_many differs from serial")
            snr = snr_db(pcm, out)
            check(np.isfinite(snr) and snr > SNR_FLOOR_DB,
                  f"{tag}: SNR {snr:.2f} dB not above the {SNR_FLOOR_DB} "
                  "dB floor")
            if rate == "reservoir":
                launches[f"alloc-{alloc}"] = {
                    k: sum(counts[tag, step][k] for step in
                           ("encode", "decode-host", "decode-device"))
                    for k in K.LAUNCHES}
            # pactpu's stream of this allocator and rate mode
            ref = fx[f"{alloc}_{rate}_stream"].tobytes()
            _, oracle = refcodec.decode_file(ref)
            d = []
            for e in (eng, eng_dev):
                _, got = e.decode(ref)
                check(got.shape == oracle.shape,
                      f"{tag}: fixture decode has the wrong shape")
                d.append(np.abs(got.astype(np.int32) - oracle))
            check(max(int(x.max()) for x in d) <= 1,
                  f"{tag}: fixture decode off the oracle's by "
                  f"{max(int(x.max()) for x in d)} LSB")
            mine = eng.encode(fx_pcm)
            snr_t = snr_db(fx_pcm, eng.decode(mine)[1])
            snr_j = float(fx[f"{alloc}_{rate}_snr_db"])
            check(abs(snr_t - snr_j) <= 0.1,
                  f"{tag}: re-encode SNR {snr_t:.3f} dB vs JAX {snr_j:.3f}")
            check(abs(len(mine) - len(ref)) <= 0.01 * len(ref),
                  f"{tag}: re-encode size {len(mine)} vs JAX {len(ref)}")
            say("9-alloc", alloc=alloc, rate_mode=rate,
                blocks=n_blocks(pcm), bytes=len(stream),
                snr_db=round(snr, 3), launches={
                    step: counts[tag, step] for step in
                    ("encode", "decode-host", "decode-device")},
                fixture_identical_share=float((d[0] == 0).mean()),
                fixture_max_lsb=int(max(x.max() for x in d)),
                fixture_snr_port_db=round(snr_t, 4),
                fixture_snr_jax_db=round(snr_j, 4),
                fixture_bytes_port=len(mine), fixture_bytes_jax=len(ref))

    # a table set trained on the card from the engine's own symbols
    eng = make_engine(rate_mode="cbr")
    _, sizes, analyses = eng._analyze(pcm)
    syms = [E.finalize(eng.cfg, a, torch.zeros(n, device=eng.device),
                       eng.consts(), return_syms=True)["syms"]
            for a, n in zip(analyses, sizes)]
    hist = sum(huffman_train.symbol_histogram(x) for x in syms)
    tabs = huffman_train.train_tables(
        {t: hist.cpu().numpy() for t in range(1, 11)})
    trained = make_engine(rate_mode="cbr", tables=tabs)
    trained_dev = make_engine(rate_mode="cbr", tables=tabs,
                              decode_parse="device")
    shipped = eng.encode(pcm)
    stream = trained.encode(pcm)
    check(stream != shipped, "the trained tables gave the shipped bytes")
    _, out = trained.decode(stream)
    _, out_dev = trained_dev.decode(stream)
    _, out_shipped = eng.decode(shipped)
    check(np.array_equal(out, out_dev) and np.array_equal(out, out_shipped),
          "the trained tables' cbr stream decodes to other samples")
    # pactpu's stream on its own trained tables
    fx_tabs = tuple(fx[f"tables_{k}"] for k in
                    ("lengths", "codes", "escape_lengths", "escape_codes"))
    ref = fx["trained_cbr_stream"].tobytes()
    _, a = make_engine(rate_mode="cbr", tables=fx_tabs).decode(ref)
    _, b_ = make_engine(rate_mode="cbr", tables=fx_tabs,
                        decode_parse="device").decode(ref)
    check(np.array_equal(a, b_), "pactpu's trained-table stream decodes "
          "to other samples by device parse")
    snr_t, snr_j = snr_db(fx_pcm, a), float(fx["trained_cbr_snr_db"])
    check(abs(snr_t - snr_j) <= 0.1, f"pactpu's trained-table stream "
          f"decodes at {snr_t:.3f} dB, pactpu's at {snr_j:.3f}")
    # a table set outside the walk LUT: host parse only
    unfit = unfit_tables()
    stream_u = make_engine(rate_mode="cbr", tables=unfit).encode(pcm)
    _, out_u = make_engine(rate_mode="cbr", tables=unfit).decode(stream_u)
    check(np.array_equal(out_u, out_shipped),
          "the unfit tables' cbr stream decodes to other samples")
    try:
        make_engine(rate_mode="cbr", tables=unfit,
                    decode_parse="device").decode(stream_u)
    except ValueError as e:
        unfit_msg = str(e)
        check("decode_parse='host'" in unfit_msg,
              f"the unfit tables' refusal names no host route: {unfit_msg}")
    else:
        raise SmokeError("decode_parse='device' decoded a table set "
                         "outside the walk LUT")
    # device_pack=False and debug_checks=True: the same bytes
    main = make_engine().encode(pcm)
    host_packed = counted("host-pack", make_engine(device_pack=False).encode,
                          pcm)
    check(host_packed == main, "device_pack=False gave other bytes")
    check(counts["host-pack"]["pack_payload"] == 0
          and counts["host-pack"]["pack_words"] == 0,
          "device_pack=False launched K3")
    check(make_engine(debug_checks=True).encode(pcm) == main,
          "debug_checks=True gave other bytes")
    say("9-surface", trained_bytes=len(stream), shipped_bytes=len(shipped),
        fixture_trained_snr_port_db=round(snr_t, 4),
        fixture_trained_snr_jax_db=round(snr_j, 4), unfit_refusal=unfit_msg,
        host_pack_launches=counts["host-pack"])
    return launches


def stream_fields(stream: bytes, cfg) -> dict:
    """A .wak stream's fields by channel-block, as the native parser reads
    them (overall, table id, ba, sf, mantissas; LRMS flags by block)."""
    from pactpu_torch import native
    from pactpu_torch.codec.header import read_header
    return native.unpack_file(
        stream[read_header(stream)[2]:],
        np.asarray(cfg.band_layout.n_lines, np.int32), cfg.n_scale_bits,
        cfg.n_mant_size_bits, cfg.n_table_id_bits, read_lrms=True,
        n_channels=cfg.n_channels)


def first_difference(mine: bytes, ref: bytes, cfg) -> dict:
    """Where two streams part: the channel-blocks whose bytes differ and,
    at the first of them, the first field that differs, in the order the
    encoder decides them (the LRMS flags and overall scale of the
    analysis, the allocation ba, the scale factors, the table id, the
    mantissas)."""
    rows_m, rows_r = rows_of(mine), rows_of(ref)
    differ = [i for i, (x, y) in enumerate(zip(rows_m, rows_r)) if x != y]
    differ += list(range(min(len(rows_m), len(rows_r)),
                         max(len(rows_m), len(rows_r))))
    out = dict(channel_blocks=len(rows_r), differing=len(differ))
    if differ and len(rows_m) == len(rows_r):
        i = differ[0]
        fm, fr = stream_fields(mine, cfg), stream_fields(ref, cfg)
        for key in ("lrms", "overall", "ba", "sf", "table_id", "mant"):
            at = i // cfg.n_channels if key == "lrms" else i
            if not np.array_equal(fm[key][at], fr[key][at]):
                out.update(first=i, stage=key)
                break
    return out


def file_analysis(torch, eng, pcm: np.ndarray):
    """The engine's analysis of a whole file, its chunks' dicts joined.
    Returns (the file's block count, the dict)."""
    b, _, parts = eng._analyze(pcm)
    return b, {k: torch.cat([a[k] for a in parts]) for k in parts[0]}


def exact_trajectory(torch, eng, whole: dict, size: int, b: int):
    """K7's trajectory over one analysis cut into chunks of `size` blocks:
    (the extras of the file's b blocks, the final carry)."""
    from pactpu_torch.codec import exact
    cut = [{k: v[i:i + size] for k, v in whole.items()}
           for i in range(0, whole["smr"].shape[0], size)]
    extras, carry = exact.exact_extras_chunked(eng.cfg, cut, eng.consts(), b)
    return torch.cat(extras)[:b], carry


def analysis_difference(torch, a: dict, b_: dict, b: int) -> dict:
    """How two analyses of the same file differ over its b blocks."""
    out = {f"{k}_equal": bool(torch.equal(a[k][:b], b_[k][:b]))
           for k in ("overall", "lrms")}
    for k in ("mixed", "smr"):
        out[f"{k}_max_diff"] = float((a[k][:b] - b_[k][:b]).abs().max())
    return out


def phase8(torch, make_engine, pcm: np.ndarray, chunks=(128, 512),
           slice_blocks: int = 40, reps: int = 3) -> dict:
    """Engine(rate_mode="exact"): in float32 on pcm, encode -> decode, the
    stream parses back, SNR above the floor, K7, K2, K3 and K4 launched, and
    the encode time beside the reservoir mode's (printed, not gated).  The
    chunk size: the trajectory (K7's extras and carry) of the file's
    analyses cut into chunks of each size of `chunks` is the same bit for
    bit, and the streams of engines with those chunk sizes are byte-equal
    (where they are not, the analyses' largest differences, the differing
    channel-blocks and the first differing stage are printed before the
    phase fails).  In float64 on a
    `slice_blocks`-block stereo slice and its first channel, against the
    float64 oracle (pactpu_torch.compat.refcodec): byte-equal, or else the
    differing channel-blocks and the first differing stage are printed and
    SNR must stay within EXACT_F64_SNR_DB and the size within
    EXACT_F64_SIZE.  Returns the float32 run's launches."""
    from pactpu_torch import CodecConfig
    from pactpu_torch.compat import refcodec
    from pactpu_torch.ops import kernels as K
    engines = {c: make_engine(rate_mode="exact", chunk_blocks=c)
               for c in chunks}
    eng = engines[chunks[-1]]
    eng.encode(pcm[:FS])                                  # warm
    sync(torch)
    K.reset_launches()
    stream = eng.encode(pcm)
    fs, out = eng.decode(stream)
    sync(torch)
    launches = dict(K.LAUNCHES)
    check_launched(launches, ["exact_scan", "cost_table", "water_fill",
                              "pack_payload", "spread_maskers_up",
                              "extract_codes"], "the exact path")
    parses_back(stream, eng.cfg, pcm)
    snr = snr_db(pcm, out)
    check(fs == FS and np.isfinite(snr) and snr > SNR_FLOOR_DB,
          f"exact: SNR {snr:.2f} dB not above the {SNR_FLOOR_DB} dB floor")
    b, whole = file_analysis(torch, eng, pcm)
    gold = None
    chunking = {}
    for c in chunks:
        ex, carry = exact_trajectory(torch, eng, whole, c, b)
        gold = gold or (ex, carry)
        check(torch.equal(ex, gold[0]) and torch.equal(carry, gold[1]),
              f"the exact trajectory depends on the chunk size ({c} "
              f"against {chunks[0]} blocks)")
        other = engines[c].encode(pcm)
        line = dict(identical=other == stream)
        if other != stream:
            _, mine = file_analysis(torch, engines[c], pcm)
            line.update(analysis_difference(torch, mine, whole, b),
                        **first_difference(other, stream, eng.cfg))
            check(False, f"the exact stream with {c}-block chunks differs "
                  f"from the {chunks[-1]}-block one: {line}")
        chunking[c] = line
    reservoir = make_engine(rate_mode="reservoir", chunk_blocks=chunks[-1])
    timing = {"exact": [], "reservoir": []}
    for _ in range(reps):
        for mode, e in (("exact", eng), ("reservoir", reservoir),
                        ("reservoir", reservoir), ("exact", eng)):
            sync(torch)
            t0 = time.perf_counter()
            e.encode(pcm)
            sync(torch)
            timing[mode].append(round(time.perf_counter() - t0, 4))
    say("8-exact-f32", blocks=n_blocks(pcm), chunks=list(chunks),
        bytes=len(stream), snr_db=round(snr, 3), launches=launches,
        chunking=chunking,
        encode_s_exact=timing["exact"],
        encode_s_reservoir=timing["reservoir"])

    for name, cfg in (("stereo", CodecConfig()),
                      ("mono", CodecConfig(n_channels=1))):
        x = np.ascontiguousarray(
            pcm[:(slice_blocks - 1) * 1024, :cfg.n_channels])
        t0 = time.perf_counter()
        ref = refcodec.encode_file(x, FS, cfg)
        t_ref = time.perf_counter() - t0
        e64 = make_engine(cfg=cfg, rate_mode="exact", precision="f64")
        e64.encode(x[:FS // 4])                           # warm
        sync(torch)
        K.reset_launches()
        t0 = time.perf_counter()
        mine = e64.encode(x)
        sync(torch)
        t_mine = time.perf_counter() - t0
        f64_launches = dict(K.LAUNCHES)
        check_launched(f64_launches, ["exact_scan", "cost_table",
                                      "water_fill",
                                      "spread_maskers_up", "pack_payload"],
                       f"the float64 exact path ({name})")
        diff = first_difference(mine, ref, cfg)
        line = dict(slice=name, blocks=n_blocks(x), bytes=len(mine),
                    bytes_oracle=len(ref), identical=mine == ref, **diff,
                    encode_s=round(t_mine, 4), oracle_s=round(t_ref, 4),
                    launches=f64_launches)
        if mine != ref:
            _, out_m = refcodec.decode_file(mine)
            _, out_r = refcodec.decode_file(ref)
            d_snr = snr_db(x, out_m) - snr_db(x, out_r)
            line.update(snr_diff_db=round(d_snr, 5))
            check(abs(d_snr) <= EXACT_F64_SNR_DB
                  and abs(len(mine) - len(ref)) <= EXACT_F64_SIZE * len(ref),
                  f"exact f64 ({name}) differs from the oracle beyond "
                  f"{EXACT_F64_SNR_DB} dB or {EXACT_F64_SIZE:.1%}: {diff}")
        say("8-exact-f64", **line)
    return launches


def stream_splits(pcm: np.ndarray, half: int = 1024) -> dict:
    """Phase 10's cuts of a file into pushes, as sample offsets: "700-1s"
    (700-sample pieces for the first 40 blocks, then 1 s pieces), "1s"
    (1 s pieces), "10s" (10 s pieces) and "mid-batch" (a boundary, 300
    samples into a block, halfway through the real blocks of each batch of
    the Engine's default chunking, its tail batch included)."""
    from pactpu_torch.codec.engine import _default_batches, _offsets
    n = pcm.shape[0]
    b = n_blocks(pcm)
    head = list(range(0, min(40 * half, n), 700))
    offs = _offsets(_default_batches(b))
    mids = [(lo + (min(hi, b) - lo) // 2) * half + 300
            for lo, hi in zip(offs[:-1], offs[1:])]
    cuts = {"700-1s": head + list(range(head[-1] + 700, n, FS)),
            "1s": list(range(0, n, FS)),
            "10s": list(range(0, n, 10 * FS)),
            "mid-batch": [0] + [m for m in mids if m < n]}
    return {k: sorted(set(v) | {n}) for k, v in cuts.items()}


def stream_encode(pcm: np.ndarray, cuts, rate_mode: str = "reservoir",
                  resume_at: int = None, chunk_blocks: int = None,
                  engines: list = None) -> bytes:
    """StreamingEncoder over the pushes between `cuts`; with resume_at, the
    state after the push that ends there restores into a fresh encoder.
    engines: a list that takes each encoder's Engine."""
    from pactpu_torch import StreamingEncoder
    engines = [] if engines is None else engines
    enc = StreamingEncoder(rate_mode=rate_mode, chunk_blocks=chunk_blocks,
                           device=DEV)
    engines.append(enc._eng)
    parts = [enc.header(pcm.shape[0])]
    for a, b in zip(cuts[:-1], cuts[1:]):
        parts.append(enc.push(pcm[a:b]))
        if b == resume_at:
            enc = StreamingEncoder.restore(enc.state_bytes(),
                                           rate_mode=rate_mode,
                                           chunk_blocks=chunk_blocks,
                                           device=DEV)
            engines.append(enc._eng)
    parts.append(enc.flush())
    return b"".join(parts)


def stream_decode(stream: bytes, chunk_blocks: int, step: int = 4099,
                  resume_at: int = None, engines: list = None) -> np.ndarray:
    """StreamingDecoder over `step`-byte pushes; with resume_at, restored
    from its state after the push that starts there.  engines: a list that
    takes each decoder's Engine."""
    from pactpu_torch.codec.stream import StreamingDecoder
    engines = [] if engines is None else engines
    dec = StreamingDecoder(chunk_blocks=chunk_blocks, device=DEV)
    outs = []
    for i in range(0, len(stream), step):
        outs.append(dec.push(stream[i:i + step]))
        if i == resume_at:
            engines.append(dec._eng)
            dec = StreamingDecoder.restore(dec.state_bytes(),
                                           chunk_blocks=chunk_blocks,
                                           device=DEV)
    outs.append(dec.flush())
    engines.append(dec._eng)
    return np.concatenate([o for o in outs if o.size])


def timed(torch, fn):
    sync(torch)
    t0 = time.perf_counter()
    out = fn()
    sync(torch)
    return out, round(time.perf_counter() - t0, 4)


def phase10(torch, make_engine, pcm: np.ndarray, files, ckpt_block=700,
            segment_blocks: int = 64, reps: int = 3) -> dict:
    """Streams, jobs, the fleet and the CLI.  pcm (the 60 s file) through
    StreamingEncoder in each of stream_splits' cuts and from a checkpoint
    taken after block ckpt_block, each byte-equal to Engine().encode and
    timed beside it; StreamingDecoder with 16- and 512-block chunks in
    4,099-byte pushes (and across a restored state) sample-equal to
    Engine().decode; the float32 exact stream of files[0] equal to
    Engine(rate_mode="exact"); run_encode_jobs on files with segments 1
    and 3 failing once, equal to the Engine; every CLI command on WAVs in
    a temporary directory.  Returns the launches of the "stream" path: the
    first split's encode and the 16-block decode of pcm."""
    import tempfile

    from pactpu_torch.ops import kernels as K
    from pactpu_torch.parallel import jobs
    eng = make_engine()
    gold = eng.encode(pcm)
    _, want = eng.decode(gold)
    stream_encode(pcm[:FS], [0, 5000, FS])                    # warm
    engine_s = [timed(torch, lambda: eng.encode(pcm))[1] for _ in range(reps)]
    engine_dec_s = [timed(torch, lambda: eng.decode(gold))[1]
                    for _ in range(reps)]

    cuts = stream_splits(pcm)
    splits = {}
    for k, (name, cut) in enumerate(cuts.items()):
        if k == 0:
            sync(torch)
            K.reset_launches()
        got, secs = timed(torch, lambda: stream_encode(pcm, cut))
        check(got == gold, f"the {name} stream differs from Engine.encode")
        if k == 0:
            out16, dec16_s = timed(torch, lambda: stream_decode(gold, 16))
            launches = dict(K.LAUNCHES)
        splits[name] = dict(pushes=len(cut) - 1, encode_s=secs)
    check_launched(launches, ["extract_codes", "water_fill", "pack_payload",
                              "spread_maskers_up"], "the stream path")
    mid = ckpt_block * 1024 + 123
    cut = [0, mid] + [c for c in cuts["700-1s"] if c > mid]
    check(stream_encode(pcm, cut, resume_at=mid) == gold,
          f"the stream restored after block {ckpt_block} differs")
    check(np.array_equal(out16, want),
          "the 16-block streamed decode differs from Engine.decode")
    out512, dec512_s = timed(torch, lambda: stream_decode(gold, 512))
    check(np.array_equal(out512, want),
          "the 512-block streamed decode differs from Engine.decode")
    half_way = len(gold) // 2 // 4099 * 4099
    check(np.array_equal(stream_decode(gold, 512, resume_at=half_way), want),
          "the restored streamed decode differs from Engine.decode")

    x = files[0]
    K.reset_launches()
    exact = stream_encode(x, list(range(0, x.shape[0], FS)) + [x.shape[0]],
                          rate_mode="exact")
    exact_launches = dict(K.LAUNCHES)
    check(exact == make_engine(rate_mode="exact").encode(x),
          "the exact stream differs from Engine(rate_mode='exact')")
    check_launched(exact_launches, ["exact_scan", "cost_table"],
                   "the exact stream")

    hits = []

    def fault(name, seg, attempt):
        if attempt == 0 and seg in (1, 3):
            hits.append((name, seg))
            raise RuntimeError("injected fault")

    res = jobs.run_encode_jobs(
        [(f"f{k}", p) for k, p in enumerate(files)],
        segment_blocks=segment_blocks, fault_hook=fault, device=DEV)
    for r, p in zip(res, files):
        check(r.ok and r.stream == eng.encode(p),
              f"job {r.name} differs from the Engine ({r.error})")

    say("10-stream", blocks=n_blocks(pcm), bytes=len(gold),
        engine_encode_s=engine_s, engine_decode_s=engine_dec_s,
        splits=splits,
        checkpoint_block=ckpt_block, decode_s={16: dec16_s, 512: dec512_s},
        exact_blocks=n_blocks(x), exact_launches=exact_launches,
        jobs=len(res), faults_absorbed=sum(r.retries for r in res),
        faults_injected=len(hits), launches=launches)
    with tempfile.TemporaryDirectory() as tmp:
        phase10_cli(torch, make_engine, files, tmp)
    return launches


def phase10_cli(torch, make_engine, files, tmp: str) -> None:
    """Every command of `python -m pactpu_torch` on WAVs of files in tmp,
    through cli.main (and encode once in its own process on the card)."""
    import contextlib
    import io

    from pactpu_torch.codec import cli
    from pactpu_torch.codec.wav import read_wav, write_wav
    cli.DEV = DEV
    wavs = []
    for k, p in enumerate(files[:2]):
        wavs.append(os.path.join(tmp, f"in{k}.wav"))
        write_wav(wavs[-1], FS, p)
    path = lambda name: os.path.join(tmp, name)  # noqa: E731
    eng = make_engine()
    gold = eng.encode(files[0])
    times, outs = {}, {}

    def run(name, *argv):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc, times[name] = timed(torch, lambda: cli.main(list(argv)))
        check(rc == 0, f"`{name}` exited {rc}: {buf.getvalue()[-500:]}")
        outs[name] = buf.getvalue()

    run("encode", "encode", wavs[0], path("a.wak"))
    check(open(path("a.wak"), "rb").read() == gold,
          "`encode` differs from Engine.encode")
    run("decode", "decode", path("a.wak"), path("a.wav"))
    check(np.array_equal(read_wav(path("a.wav")).samples,
                         eng.decode(gold)[1]),
          "`decode` differs from Engine.decode")
    run("decode-range-device", "decode", path("a.wak"), path("r.wav"),
        "--range", "10000:50000", "--decode-parse", "device")
    check(np.array_equal(read_wav(path("r.wav")).samples,
                         eng.decode_range(gold, 10000, 50000)[1]),
          "`decode --range --decode-parse device` differs")
    run("roundtrip-fleet", "roundtrip", *wavs, "--outdir", path("rt"),
        "--fleet")
    check("fleet: 1 device(s)" in outs["roundtrip-fleet"],
          "`roundtrip --fleet` did not report one device")
    check(open(path("rt/in1.wak"), "rb").read() == eng.encode(files[1]),
          "`roundtrip --fleet` differs from Engine.encode")
    run("stats", "stats", wavs[0])
    stats = json.loads(outs["stats"])
    out, b = eng.encode_arrays(files[0])
    check(stats["total_payload_bits"] == int(out["nbits"][:2 * b].sum()),
          "`stats` payload bits differ from the stream's")
    run("debug", "debug", wavs[0], "--block", "1", "--out", path("d.npz"))
    with np.load(path("d.npz")) as d:
        check(d["bthr"].shape == (6, 1024) and d["bits"].shape == (2, 25),
              "`debug --out` wrote no block dump")
    run("bench", "bench", wavs[1], "--reps", "1")
    run("batch", "batch", *wavs, "--outdir", path("batch"))
    check(open(path("batch/in0.wak"), "rb").read() == gold,
          "`batch` differs from Engine.encode")
    run("train", "train", path("t.npz"), wavs[0], wavs[1] + ":3")
    run("encode-tables", "encode", wavs[1], path("t.wak"), "--tables",
        path("t.npz"))
    run("decode-tables", "decode", path("t.wak"), path("t.wav"), "--tables",
        path("t.npz"))
    teng = make_engine(tables=path("t.npz"))
    ts = teng.encode(files[1])
    check(open(path("t.wak"), "rb").read() == ts
          and np.array_equal(read_wav(path("t.wav")).samples,
                             teng.decode(ts)[1]),
          "the trained table set does not round-trip a file")
    line = dict(commands=sorted(times), seconds=times,
                bench=outs["bench"].strip(),
                stats_payload_bits=stats["total_payload_bits"])
    if DEV != "cpu":
        t0 = time.perf_counter()
        res = subprocess.run([sys.executable, "-m", "pactpu_torch", "encode",
                              wavs[0], path("p.wak")], cwd=ROOT,
                             capture_output=True, text=True, timeout=300)
        check(res.returncode == 0 and open(path("p.wak"), "rb").read()
              == gold, f"python -m pactpu_torch encode: {res.stderr[-500:]}")
        line["process_encode_s"] = round(time.perf_counter() - t0, 3)
    say("10-cli", **line)


def split_payload(stream: bytes, c: int, block: int):
    """(header, payload of blocks [0, block), payload of the rest)."""
    from pactpu_torch.codec.header import read_header
    _, _, off = read_header(stream)
    pos = off
    for _ in range(c * block):
        pos += 4 + int.from_bytes(stream[pos:pos + 4], "little")
    return stream[:off], stream[off:pos], stream[pos:]


def corrupt_table_id(stream: bytes, cblock: int) -> bytes:
    """The stream with channel-block cblock's table id set to 15, past the
    shipped set's ten tables: the device parse flags that row."""
    from pactpu_torch.codec.header import read_header
    out = bytearray(stream)
    pos = read_header(stream)[2]
    for _ in range(cblock):
        pos += 4 + int.from_bytes(out[pos:pos + 4], "little")
    out[pos + 4] |= 0x0F                  # overall (4 bits), table id (4)
    return bytes(out)


def max_lsb(a: np.ndarray, b: np.ndarray) -> tuple:
    """(largest |a - b| in LSB, samples that differ); shapes must agree."""
    check(a.shape == b.shape, f"PCM shapes differ: {a.shape} {b.shape}")
    d = np.abs(a.astype(np.int32) - b.astype(np.int32))
    return int(d.max(initial=0)), int((d != 0).sum())


def free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def phase11_worker(rank: int, world: int, port: int, tmp: str,
                   device: str) -> None:
    """One gloo rank of phase 11 (two local shards on `device`): the
    distributed cbr and reservoir encodes of tmp/pcm.npy and the decode of
    tmp/stream.wak, saved to tmp/part_<rank>.npz (a traceback to
    tmp/error_<rank>.txt)."""
    import traceback
    try:
        import torch
        from pactpu_torch.parallel import cluster, shard
        torch.set_num_threads(2)
        check(cluster.initialize(f"localhost:{port}", num_processes=world,
                                 process_id=rank, backend="gloo"),
              "the gloo group did not form")
        try:
            mesh = shard.make_mesh([device, device])
            pcm = np.load(os.path.join(tmp, "pcm.npy"))
            with open(os.path.join(tmp, "stream.wak"), "rb") as f:
                stream = f.read()
            t0 = time.perf_counter()
            cbr = cluster.encode_distributed(pcm, mesh=mesh,
                                             rate_mode="cbr")
            cbr_s = time.perf_counter() - t0
            res = cluster.encode_distributed(pcm, mesh=mesh,
                                             rate_mode="reservoir")
            dec = cluster.decode_distributed(stream, mesh=mesh)
        finally:
            cluster.shutdown()
        np.savez(os.path.join(tmp, f"part_{rank}.npz"),
                 header=np.frombuffer(cbr.header, np.uint8),
                 payload=np.frombuffer(cbr.payload, np.uint8),
                 block_start=cbr.block_start, histogram=cbr.histogram,
                 cbr_s=cbr_s, res_payload=np.frombuffer(res.payload,
                                                        np.uint8),
                 res_start=res.block_start, dec_pcm=dec.pcm,
                 dec_start=dec.sample_start, dec_total=dec.num_samples)
    except BaseException:
        with open(os.path.join(tmp, f"error_{rank}.txt"), "w") as f:
            f.write(traceback.format_exc())
        raise


def phase11_gloo(torch, make_engine, pcm: np.ndarray, shard_dev: str,
                 timeout_s: float) -> dict:
    """Two gloo processes of two shards each on shard_dev, spawned here
    and joined within timeout_s: cbr byte-equal to the Engine, histograms
    identical, rank 1's reservoir part lost and recovered, the decode of
    the Engine's reservoir stream assembled within 1 LSB; and the
    two-process reservoir stream's bytes and SNR beside the Engine's."""
    import multiprocessing
    import tempfile

    from pactpu_torch.parallel import cluster
    eng = make_engine()
    gold = eng.encode(pcm)
    _, gold_pcm = eng.decode(gold)
    cbr_gold = make_engine(rate_mode="cbr").encode(pcm)
    with tempfile.TemporaryDirectory() as tmp:
        np.save(os.path.join(tmp, "pcm.npy"), pcm)
        with open(os.path.join(tmp, "stream.wak"), "wb") as f:
            f.write(gold)
        ctx = multiprocessing.get_context("spawn")
        port = free_port()
        procs = [ctx.Process(target=phase11_worker,
                             args=(rank, 2, port, tmp, shard_dev))
                 for rank in range(2)]
        t0 = time.perf_counter()
        for p in procs:
            p.start()
        for p in procs:
            p.join(max(1.0, timeout_s - (time.perf_counter() - t0)))
        hung = [p for p in procs if p.is_alive()]
        for p in hung:
            p.kill()
            p.join()
        errors = [open(os.path.join(tmp, f)).read()[-1500:]
                  for f in sorted(os.listdir(tmp)) if f.startswith("error")]
        check(not hung, f"a gloo worker did not end in {timeout_s} s")
        check(all(p.exitcode == 0 for p in procs),
              f"a gloo worker failed: {errors}")
        workers_s = round(time.perf_counter() - t0, 3)
        parts = []
        for rank in range(2):
            with np.load(os.path.join(tmp, f"part_{rank}.npz")) as z:
                parts.append({k: z[k] for k in z.files})
    header = parts[0]["header"].tobytes()
    stream = cluster.assemble_stream(header, [
        (int(p["block_start"]), p["payload"].tobytes()) for p in parts])
    check(stream == cbr_gold, "the two-process cbr stream differs from "
          "the Engine's")
    check(np.array_equal(parts[0]["histogram"], parts[1]["histogram"]),
          "the two ranks' histograms differ")
    survivor = (int(parts[0]["res_start"]), parts[0]["res_payload"].tobytes())
    lost = (int(parts[1]["res_start"]), parts[1]["res_payload"].tobytes())
    no_fault = cluster.assemble_stream(header, [survivor, lost])
    recovered = cluster.recover_stream(header, [survivor], pcm, 4, 2,
                                       rate_mode="reservoir",
                                       device=shard_dev)
    check(recovered == no_fault, "the recovered reservoir stream differs "
          "from the two-process stream")
    got = cluster.assemble_pcm(
        [(int(p["dec_start"]), p["dec_pcm"]) for p in parts],
        int(parts[0]["dec_total"]))
    lsb, differ = max_lsb(got, gold_pcm)
    check(lsb <= 1, f"the two-process decode is {lsb} LSB off")
    _, two_pcm = eng.decode(no_fault)
    return dict(workers_s=workers_s,
                cbr_s=[float(p["cbr_s"]) for p in parts],
                block_starts=[lo for lo, _ in (survivor, lost)],
                decode_samples_differing=differ,
                restart_cost=dict(
                    engine_bytes=len(gold), two_process_bytes=len(no_fault),
                    engine_snr_db=snr_db(pcm, gold_pcm),
                    two_process_snr_db=snr_db(pcm, two_pcm)))


def in_turns(torch, fns: dict) -> dict:
    """Each fn timed twice (host clock, synchronized), in turns a, b, ...,
    then back: {name: [s, s]}."""
    order = list(fns) + list(fns)[::-1]
    out = {k: [] for k in fns}
    for k in order:
        out[k].append(timed(torch, fns[k])[1])
    return out


def phase11(torch, make_engine, pcm: np.ndarray, long_pcm: np.ndarray,
            shards=(1, 2, 4), bench_blocks: int = 512, bench_iters: int = 20,
            timeout_s: float = 300.0) -> dict:
    """Distribution.  In a process group of one (NCCL on the card, gloo in
    the CPU rehearsal) with meshes of `shards` local shards: pcm's
    encode_distributed equal to the Engine's (cbr at DIST_BPS, reservoir),
    one histogram, decode_distributed within 1 LSB of Engine.decode (the
    "distributed" path, whose launches are returned: K1-K5); both packing
    fallbacks, a corrupted copy, a 6-size-bit stream, a lost range; the
    cbr encode times in turns beside Engine.encode, of pcm and long_pcm.
    Then phase11_gloo, and devbench on pcm's first bench_blocks blocks."""
    import dataclasses

    from pactpu_torch import CodecConfig
    from pactpu_torch.codec import engine as E
    from pactpu_torch.ops import kernels as K
    from pactpu_torch.parallel import cluster, shard
    from pactpu_torch.utils import devbench
    shard_dev = "cpu" if DEV == "cpu" else "cuda:0"
    backend = "gloo" if DEV == "cpu" else "nccl"
    cfgs = {bps: dataclasses.replace(CodecConfig(),
                                     target_bits_per_sample=bps)
            for bps in DIST_BPS}
    gold = {("cbr", bps): make_engine(cfg=cfg, rate_mode="cbr").encode(pcm)
            for bps, cfg in cfgs.items()}
    eng = make_engine()
    gold[("reservoir", DIST_BPS[0])] = eng.encode(pcm)
    _, gold_pcm = eng.decode(gold[("reservoir", DIST_BPS[0])])
    # the 968-word packer re-run fires where a row needs more than the
    # configuration's packer width
    wide = {bps: max(len(r) for r in rows_of(gold[("cbr", bps)])) * 8
            > 32 * E.pack_widths(cfgs[bps])[0] for bps in DIST_BPS}
    check(not cluster.initialize(f"localhost:{free_port()}",
                                 num_processes=1, process_id=0,
                                 backend=backend),
          "a group of one process reports several")
    try:
        meshes = {n: shard.make_mesh([shard_dev] * n) for n in shards}
        sync(torch)
        K.reset_launches()
        runs, hists, decoded = {}, [], {}
        for n, mesh in meshes.items():
            for (mode, bps), want in gold.items():
                res, secs = timed(torch, lambda: cluster.encode_distributed(
                    pcm, cfg=cfgs[bps], mesh=mesh, rate_mode=mode))
                got = cluster.assemble_stream(
                    res.header, [(res.block_start, res.payload)])
                check(got == want, f"{mode} at {bps} on {n} shards differs "
                      "from the Engine's stream")
                runs[f"{mode}-{bps}-{n}"] = secs
                if (mode, bps) == ("cbr", DIST_BPS[0]):
                    hists.append(res.histogram)
            res, secs = timed(torch, lambda: cluster.decode_distributed(
                gold[("reservoir", DIST_BPS[0])], mesh=mesh))
            lsb, differ = max_lsb(cluster.assemble_pcm(
                [(res.sample_start, res.pcm)], res.num_samples), gold_pcm)
            check(lsb <= 1, f"decode_distributed on {n} shards is {lsb} "
                  "LSB off Engine.decode")
            decoded[n] = dict(decode_s=secs, samples_differing=differ)
        sync(torch)
        launches = dict(K.LAUNCHES)
        check_launched(launches, ["extract_codes", "water_fill",
                                  "pack_payload", "spread_maskers_up",
                                  "huffman_walk"], "the distributed path")
        check(all(np.array_equal(h, hists[0]) for h in hists),
              "the histogram depends on the mesh")
        # the shard devices' owners hold their programs across calls
        owners = list({id(o): o for m in meshes.values()
                       for c in cfgs.values()
                       for o in shard.mesh_owners(c, m)}.values())
        captured = sum(o.programs.captures for o in owners)
        cluster.encode_distributed(pcm, cfg=cfgs[DIST_BPS[0]],
                                   mesh=meshes[max(shards)], rate_mode="cbr")
        check(sum(o.programs.captures for o in owners) == captured,
              "a second distributed call captured programs again")

        # both fallbacks forced once: rows past a 32-word packer (the
        # 968-word re-run) and a dense cap of one word a row
        n_max = meshes[max(shards)]
        for knob in ("PACK_WORDS", "PACK_DENSE_WORDS"):
            saved = getattr(E, knob)
            setattr(E, knob, 32 if knob == "PACK_WORDS" else 1)
            try:
                res = cluster.encode_distributed(
                    pcm, cfg=cfgs[DIST_BPS[0]], mesh=n_max, rate_mode="cbr")
            finally:
                setattr(E, knob, saved)
            check(cluster.assemble_stream(res.header, [(0, res.payload)])
                  == gold[("cbr", DIST_BPS[0])],
                  f"the {knob} fallback changed the bytes")

        bad = corrupt_table_id(gold[("reservoir", DIST_BPS[0])], 9)
        try:
            cluster.decode_distributed(bad, mesh=n_max)
            refused = None
        except ValueError as e:
            refused = str(e)
        check(refused is not None and refused.startswith("corrupt"),
              f"a corrupted stream was not refused ({refused})")

        cfg6 = CodecConfig(n_mant_size_bits=6)
        eng6 = make_engine(cfg=cfg6, rate_mode="cbr")
        s6 = eng6.encode(pcm[:10 * FS])
        res = cluster.decode_distributed(s6, mesh=n_max)
        lsb6, _ = max_lsb(cluster.assemble_pcm(
            [(res.sample_start, res.pcm)], res.num_samples),
            eng6.decode(s6)[1])
        check(lsb6 <= 1, f"the 6-size-bit stream is {lsb6} LSB off")

        cbr = gold[("cbr", DIST_BPS[0])]
        (lo, _), (lo1, _) = cluster.process_block_ranges(pcm.shape[0], 4, 2)
        header, part0, _ = split_payload(cbr, 2, lo1)
        check(cluster.recover_stream(header, [(lo, part0)], pcm, 4, 2,
                                     cfgs[DIST_BPS[0]], "cbr",
                                     device=shard_dev) == cbr,
              "recover_stream of a lost range differs from the stream")

        # cbr encode times in turns (Engine, each mesh, then back), of the
        # 60 s file and of long_pcm (whose bytes are printed, not gated)
        eng_cbr = make_engine(rate_mode="cbr")

        def dist_cbr(x, n):
            res = cluster.encode_distributed(x, mesh=meshes[n],
                                             rate_mode="cbr")
            return cluster.assemble_stream(res.header, [(0, res.payload)])

        turn_s = in_turns(torch, {"engine": lambda: eng_cbr.encode(pcm),
                                  **{f"shards_{n}": (lambda n=n: dist_cbr(
                                      pcm, n)) for n in shards}})
        long_gold = eng_cbr.encode(long_pcm)
        long_runs = {f"shards_{n}_equal": dist_cbr(long_pcm, n) == long_gold
                     for n in (1, max(shards))}
        long_runs.update(in_turns(torch, {
            "engine": lambda: eng_cbr.encode(long_pcm),
            **{f"shards_{n}": (lambda n=n: dist_cbr(long_pcm, n))
               for n in (1, max(shards))}}))
    finally:
        cluster.shutdown()

    gloo = phase11_gloo(torch, make_engine, pcm, shard_dev, timeout_s)
    bench = devbench.measure_device_compute(
        pcm, blocks=bench_blocks, iters=bench_iters, eng=make_engine())
    check(all(np.isfinite(v) and v > 0 for v in bench["stage_ms"].values()),
          f"a devbench stage time is not finite and positive: "
          f"{bench['stage_ms']}")
    say("11-distributed", blocks=n_blocks(pcm), shards=list(shards),
        backend=backend, encode_s=runs, decode=decoded,
        owners=len(owners), owner_captures=captured,
        owner_replays=program_stats(owners)["replays"],
        owner_pools_mb=program_stats(owners)["pools_mb"],
        memory_mb=({k: getattr(torch.cuda, f"memory_{k}")() / 2 ** 20
                    for k in ("reserved", "allocated")}
                   if DEV != "cpu" else None),
        wide_rerun=wide, launches=launches, cbr_turns_s=turn_s,
        long_blocks=n_blocks(long_pcm), long_cbr=long_runs, gloo=gloo)
    say("11-devbench", **bench)
    return launches


def max_ulp(a: np.ndarray, b: np.ndarray) -> int:
    """The largest distance in float32 units in the last place."""
    return int(np.abs(a.view(np.int32).astype(np.int64)
                      - b.view(np.int32)).max())


def on_both(torch, fn, *arrays):
    """fn on the arrays as tensors on DEV and on the CPU: (DEV's result,
    the CPU's) as numpy."""
    mine = fn(*[torch.from_numpy(a).to(DEV) for a in arrays]).cpu().numpy()
    return mine, fn(*[torch.from_numpy(a) for a in arrays]).numpy()


def phase12_quantizers(torch, n_values: int) -> dict:
    """dequantize_uniform, fp_mantissa and fp_dequantize on n_values seeded
    inputs on DEV against the CPU: integers bit-equal, floats within
    QUANT_ULP_BOUND.  Returns the ulp counts."""
    from pactpu_torch.ops import quantize as q
    rng = np.random.default_rng(12)
    code = rng.integers(-2 ** 31, 2 ** 31, n_values, dtype=np.int64).astype(
        np.int32)
    nbits = rng.integers(-2, 32, n_values).astype(np.int32)
    x = rng.uniform(-1, 1, n_values).astype(np.float32)
    x[:4] = [-0.0, 0.0, 1.0, -1.0]
    mine, cpu = on_both(torch, q.dequantize_uniform, code, nbits)
    ulps = {"dequantize_uniform": max_ulp(mine, cpu)}
    for nsb, nm in FP_FORMATS:
        scale = q.scale_factor(torch.abs(torch.from_numpy(x)), nsb,
                               nm).numpy()
        mine, cpu = on_both(
            torch, lambda a, s: q.fp_mantissa(a, s, nsb, nm), x, scale)
        check(np.array_equal(mine, cpu),
              f"fp_mantissa ({nsb}, {nm}) differs from the CPU's")
        mine, cpu = on_both(
            torch, lambda s, m: q.fp_dequantize(s, m, nsb, nm), scale, cpu)
        ulps[f"fp_dequantize_{nsb}_{nm}"] = max_ulp(mine, cpu)
    check(max(ulps.values()) <= QUANT_ULP_BOUND,
          f"the quantizers' floats differ from the CPU's: {ulps} ulp")
    return ulps


def phase12_trainer(torch, pcm: np.ndarray) -> dict:
    """HuffmanTrainer.count of the encoder's own symbols of pcm on DEV:
    np.bincount's histogram, and the CPU trainer's table; an
    Engine(tables=...) of the trained set round-trips pcm in cbr to the
    shipped set's samples (the same mantissas, another stream)."""
    from pactpu_torch import CodecConfig, Engine
    from pactpu_torch.codec import engine as E
    from pactpu_torch.ops import huffman_train as ht
    cfg = CodecConfig()
    dev = E.device_tables(cfg, DEV)
    b = -(-pcm.shape[0] // cfg.n_mdct_lines)
    frames = E.frame_blocks(torch.from_numpy(np.ascontiguousarray(pcm.T))
                            .to(DEV), cfg.n_mdct_lines, b - 1)
    syms = E.finalize(cfg, E.analyze(cfg, frames, dev),
                      torch.zeros(b, device=DEV), dev, pack_words=0,
                      return_syms=True)["syms"]
    on_dev, on_cpu = ht.HuffmanTrainer(1), ht.HuffmanTrainer(1)
    on_dev.count(syms, device=DEV)
    host = syms.cpu().numpy().ravel()
    on_cpu.count(host, device="cpu")
    want = np.bincount(host[host >= 0], minlength=ht.NUM_SYMBOLS)
    check(np.array_equal(on_dev.freqs, want),
          "HuffmanTrainer.count differs from np.bincount")
    check(all(np.array_equal(a, b_) for a, b_ in zip(on_dev.build(),
                                                      on_cpu.build())),
          "the trained table differs from the CPU trainer's")
    tabs = ht.train_tables({1: on_dev.freqs})
    custom = Engine(cfg, "cbr", tables=tabs, device=DEV)
    shipped = Engine(cfg, "cbr", device=DEV)
    stream = custom.encode(pcm)
    check(stream != shipped.encode(pcm), "the trained tables were not used")
    _, got = custom.decode(stream)
    _, want_pcm = shipped.decode(shipped.encode(pcm))
    check(np.array_equal(got, want_pcm),
          "the trained-table stream decodes to other samples")
    return dict(symbols=int(want.sum()), bytes=len(stream),
                snr_db=round(snr_db(pcm, got), 3))


def phase12(torch, pcm: np.ndarray, long_pcm: np.ndarray,
            n_values: int = 1 << 20, stream_chunk: int = 64,
            reps: int = 5) -> dict:
    """The public surface ported last.  Engine(CodecConfig(), "cbr") and
    Engine(cfg=..., rate_mode="cbr") give the same bytes on pcm;
    pactpu_torch.StreamingEncoder(chunk_blocks=stream_chunk) in 1 s pieces,
    and its restore(..., chunk_blocks=) from a mid-file checkpoint, give
    Engine().encode's bytes; the four top-level names resolve; the
    quantizers (phase12_quantizers) and HuffmanTrainer (phase12_trainer)
    on DEV agree with the CPU; frame_blocks on DEV equals frame_blocks_np;
    stereo_smrs on the first batch of long_pcm gives the Engine's own SMRs
    and mixed lines.  Returns the launches of the "surface" path: that
    stereo_smrs call (K4)."""
    import pactpu_torch
    from pactpu_torch import CodecConfig, Engine
    from pactpu_torch.codec import engine as E
    from pactpu_torch.codec import stream as S
    from pactpu_torch.ops import kernels as K
    from pactpu_torch.ops import psycho
    from pactpu_torch.parallel import serve
    from pactpu_torch.utils import config
    cfg = CodecConfig()
    half = cfg.n_mdct_lines
    by_position, pos_s = timed(
        torch, lambda: Engine(CodecConfig(), "cbr", device=DEV).encode(pcm))
    check(by_position == Engine(cfg=CodecConfig(), rate_mode="cbr",
                                device=DEV).encode(pcm),
          "Engine(cfg, 'cbr') and Engine(cfg=cfg, rate_mode='cbr') differ")

    gold, engine_s = timed(torch, lambda: Engine(device=DEV).encode(pcm))
    n = pcm.shape[0]
    cuts = list(range(0, n, FS)) + [n]
    got, stream_s = timed(torch, lambda: stream_encode(
        pcm, cuts, chunk_blocks=stream_chunk))
    check(got == gold, f"StreamingEncoder(chunk_blocks={stream_chunk}) "
          "differs from Engine().encode")
    mid = cuts[len(cuts) // 2]
    check(stream_encode(pcm, cuts, resume_at=mid,
                        chunk_blocks=stream_chunk) == gold,
          f"the stream restored at sample {mid} with chunk_blocks="
          f"{stream_chunk} differs from Engine().encode")

    check(pactpu_torch.StreamingEncoder is S.StreamingEncoder
          and pactpu_torch.StreamingDecoder is S.StreamingDecoder
          and pactpu_torch.DeviceFleet is serve.DeviceFleet
          and pactpu_torch.default_config is config.default_config,
          "a top-level name resolves to the wrong object")

    ulps = phase12_quantizers(torch, n_values)
    trained = phase12_trainer(torch, pcm)

    b = n_blocks(pcm)
    framed = E.frame_blocks(torch.from_numpy(np.ascontiguousarray(pcm.T))
                            .to(DEV), half, b - 1)
    check(np.array_equal(framed.cpu().numpy(),
                         E.frame_blocks_np(pcm, half, b)),
          "frame_blocks differs from frame_blocks_np")

    eng = Engine(device=DEV)
    whole = n_blocks(long_pcm)
    chunk = E._default_batches(whole)[0]
    first = eng._analyze(long_pcm)[2][0]
    dev = eng.consts()
    frames = E.frame_blocks(torch.from_numpy(np.ascontiguousarray(
        long_pcm[:chunk * half].T)).to(DEV), half, chunk - 1)
    _, sw, overall, scaled = E._transform(cfg, frames, dev)

    def smrs():
        return psycho.stereo_smrs(sw, scaled, overall, first["lrms"],
                                  dev["psy"], dev["lay"], cfg.sample_rate)

    sync(torch)
    K.reset_launches()
    smr, mixed = smrs()
    sync(torch)
    launches = dict(K.LAUNCHES)
    check(torch.equal(smr, first["smr"]) and torch.equal(mixed,
                                                         first["mixed"]),
          "stereo_smrs differs from the Engine's analysis")
    check_launched(launches, ["spread_maskers_up"], "the surface path")
    say("12-surface", blocks=b, engine_positional_encode_s=pos_s,
        engine_encode_s=engine_s, stream_chunk_blocks=stream_chunk,
        stream_pushes=len(cuts) - 1, stream_encode_s=stream_s,
        quantizer_values=n_values, quantizer_ulp=ulps, trained=trained,
        stereo_smrs_blocks=chunk,
        stereo_smrs_ms=(round(median_ms(torch, smrs, reps), 4)
                        if DEV != "cpu" else None),
        launches=launches)
    return launches


def eager_encode(eng, pcm: np.ndarray) -> bytes:
    """The eager stage chain of a .wak encode (the Engine before its
    program layer): the analysis and both reservoir passes by the stage
    functions chunk by chunk, launch by launch; the reservoir policy
    replayed on the host (engine.reservoir_extras) over the downloaded
    measurement; the final pass with the pack; the padded rows framed on
    the host.  In cbr the measurement and the replay are skipped."""
    import torch
    from pactpu_torch.codec import engine as E
    from pactpu_torch.codec.header import write_header
    cfg = eng.cfg
    b, sizes, frames = eng._frames(pcm, eng._analysis_batches)
    dev = eng.consts()
    offs = E._offsets(sizes)
    analyses = E._recut([E.analyze(cfg, f, dev) for f in frames],
                        [f.shape[0] for f in frames], offs)
    extras = np.zeros(offs[-1], np.float32)
    if eng.rate_mode == "reservoir":
        meas = [E.finalize(cfg, a, torch.zeros(n, device=eng.device), dev,
                           measure_only=True)
                for a, n in zip(analyses, sizes)]
        sav = torch.cat([m["savings"] for m in meas]).cpu().numpy()
        left = torch.cat([m["leftover"] for m in meas]).cpu().numpy()
        extras[:b] = E.reservoir_extras(sav[:b], left[:b],
                                        cfg.reservoir_withdraw_divisor)[0]
    ex = torch.from_numpy(extras).to(eng.device)
    outs = [E.finalize(cfg, a, ex[lo:hi], dev, pack_words=E.PACK_WORDS)
            for a, lo, hi in zip(analyses, offs, offs[1:])]
    host = {k: torch.cat([o[k] for o in outs]).cpu().numpy()
            for k in ("words", "nbits")}
    host["words"] = host["words"].view(np.uint32)
    return write_header(cfg, pcm.shape[0])[0] + eng.pack_payload(host, b)


def eager_decode(eng, stream: bytes):
    """The eager stage chain of a decode on eng's parse route: each
    chunk's stage function launch by launch (Engine.decode with
    eng.use_programs False).  Returns (sample_rate, pcm) as
    Engine.decode."""
    programmed, eng.use_programs = eng.use_programs, False
    try:
        return eng.decode(stream)
    finally:
        eng.use_programs = programmed


def phase13(torch, make_engine, files, reps: int = 3,
            buckets=None) -> dict:
    """The program layer against the eager stage chain, in one run: for
    the reservoir and the cbr mode, the files' serial encodes and decodes
    by both parse routes and roundtrip_many (each stage a program replay:
    the programs are built by a first pass, timed as capture) equal
    eager_encode's bytes and eager_decode's samples; the reservoir
    encode's dispatch half runs under set_sync_debug_mode("error");
    serial and batch blocks/s of the programs and of the eager chain in
    turns (reservoir); then a file of each of `buckets` blocks (None = every
    tail bucket, phase13_buckets).  Returns the launches of the "programs"
    path: the reservoir mode's serial encodes and decodes by both
    routes."""
    import hashlib
    from pactpu_torch.codec import programs
    from pactpu_torch.ops import kernels as K
    cuda = DEV != "cpu"
    blocks = sum(n_blocks(p) for p in files)
    launches = None
    for rate in ("reservoir", "cbr"):
        gc.collect()        # the memory read below: this phase's own
        if cuda:
            torch.cuda.empty_cache()
        eng = make_engine(rate_mode=rate)
        eng_dev = make_engine(rate_mode=rate, decode_parse="device")
        check(not cuda or (programs.encode_programs(eng)
                           and programs.decode_programs(eng_dev)),
              f"the {rate} Engine does not run its stages as programs")
        t0 = time.perf_counter()
        for pcm in files:                   # builds every program
            s = eng.encode(pcm)
            eng.decode(s)
            eng_dev.decode(s)
        eng.roundtrip_many(files)
        sync(torch)
        build_s = time.perf_counter() - t0
        ref = [eager_encode(eng, pcm) for pcm in files]
        ref_pcm = [eager_decode(eng, s)[1] for s in ref]
        for s, want in zip(ref, ref_pcm):
            check(np.array_equal(eager_decode(eng_dev, s)[1], want),
                  "the eager chain's parse routes disagree")
        sync(torch)
        K.reset_launches()
        streams = [eng.encode(pcm) for pcm in files]
        outs = [eng.decode(s)[1] for s in streams]
        outs_dev = [eng_dev.decode(s)[1] for s in streams]
        sync(torch)
        if rate == "reservoir":
            launches = dict(K.LAUNCHES)
        memory = ({k: getattr(torch.cuda, f"memory_{k}")() / 2 ** 20
                   for k in ("reserved", "allocated")} if cuda else None)
        batch, batch_streams = eng.roundtrip_many(files, return_streams=True)
        for k, pcm in enumerate(files):
            check(streams[k] == ref[k] == batch_streams[k],
                  f"{rate}: the programmed stream of file {k} differs from "
                  "the eager stage chain's")
            check(np.array_equal(outs[k], ref_pcm[k])
                  and np.array_equal(outs_dev[k], ref_pcm[k])
                  and np.array_equal(batch[k][1], ref_pcm[k]),
                  f"{rate}: the programmed decode of file {k} differs from "
                  "the eager stage chain's")
        replays = {stage: sum(p.replays for _, p in e.programs.items(stage))
                   for e, stage in ((eng, "analyze"), (eng, "measure"),
                                    (eng, "final"), (eng, "decode"),
                                    (eng_dev, "decode_device_parse"))}
        check(not cuda or all(n > 0 for stage, n in replays.items()
                              if rate == "reservoir" or stage != "measure"),
              f"{rate}: a stage never replayed its program: {replays}")
        line = dict(rate=rate, blocks=blocks, files=len(files),
                    build_s=build_s,
                    capture_s=eng.programs.capture_s
                    + eng_dev.programs.capture_s,
                    captures=eng.programs.captures
                    + eng_dev.programs.captures,
                    programs={st: len(e.programs.items(st))
                              for e, st in ((eng, "analyze"),
                                            (eng, "measure"), (eng, "final"),
                                            (eng, "decode"),
                                            (eng_dev,
                                             "decode_device_parse"))},
                    replays=replays, memory_mb=memory,
                    sha256=[hashlib.sha256(s).hexdigest() for s in streams])
        if rate == "reservoir":
            line.update(phase13_timing(torch, eng, files, ref, reps))
            line.update(phase13_buckets(torch, eng, eng_dev, buckets))
        say("13-programs", **line)
        del eng, eng_dev                   # and their graphs' memory
    check_launched(launches, ["extract_codes", "water_fill", "pack_payload",
                              "spread_maskers_up", "huffman_walk",
                              "reservoir_scan"], "the programs path")
    return launches


def phase13_buckets(torch, eng, eng_dev, buckets=None) -> dict:
    """A file of each tail bucket's size (one chunk of that many blocks;
    buckets: the sizes, None = every one of engine._TAIL_BUCKETS) encoded
    and decoded by both parse routes, its bytes and samples held to the
    eager chain's: every bucket's programs captured.  Returns the memory
    reserved then and the programs built."""
    from pactpu_torch.codec import engine as E
    for blocks in buckets or E._TAIL_BUCKETS:
        pcm = synth((blocks - 1) * 1024 / FS, 100 + blocks)
        want = eager_encode(eng, pcm)
        check(eng.encode(pcm) == want,
              f"the {blocks}-block programmed stream differs from the "
              "eager stage chain's")
        want_pcm = eager_decode(eng, want)[1]
        check(np.array_equal(eng.decode(want)[1], want_pcm)
              and np.array_equal(eng_dev.decode(want)[1], want_pcm),
              f"the {blocks}-block programmed decode differs from the "
              "eager stage chain's")
    sync(torch)
    return dict(
        buckets_memory_mb=({k: getattr(torch.cuda, f"memory_{k}")() / 2 ** 20
                            for k in ("reserved", "allocated")}
                           if DEV != "cpu" else None),
        buckets_programs=sum(len(e.programs.items(st)) for e, st in (
            (eng, "analyze"), (eng, "measure"), (eng, "final"),
            (eng, "decode"), (eng_dev, "decode_device_parse"))))


def phase13_timing(torch, eng, files, ref, reps: int) -> dict:
    """The reservoir encode's dispatch half (Engine._encode_dispatch) under
    torch.cuda.set_sync_debug_mode("error") on every file, the payload
    then downloaded and checked against ref; and serial and batch
    blocks/s of the programmed Engine and of the eager chain, in turns
    (programs, eager, eager, programs) a rep."""
    from pactpu_torch.codec.header import write_header
    blocks = sum(n_blocks(p) for p in files)
    for k, pcm in enumerate(files):
        up = eng._upload_pcm(pcm, eng._analysis_batches)
        sync(torch)
        if DEV != "cpu":
            torch.cuda.set_sync_debug_mode("error")
        try:
            st = eng._encode_dispatch(up)
        finally:
            if DEV != "cpu":
                torch.cuda.set_sync_debug_mode(0)
        header = write_header(eng.cfg, pcm.shape[0])[0]
        check(header + eng._finish_encode(st) == ref[k],
              f"the dispatch under sync debug gave other bytes (file {k})")

    def serial_programs():
        for pcm in files:
            eng.decode(eng.encode(pcm))

    def serial_eager():
        for pcm in files:
            eager_decode(eng, eager_encode(eng, pcm))

    def batch_eager():
        streams = [eager_encode(eng, pcm) for pcm in files]
        [eager_decode(eng, s) for s in streams]

    times = {k: [] for k in ("serial_programs", "serial_eager",
                             "batch_programs", "batch_eager")}
    fns = {"serial_programs": serial_programs, "serial_eager": serial_eager,
           "batch_programs": lambda: eng.roundtrip_many(files),
           "batch_eager": batch_eager}
    for _ in range(reps):
        for kind in ("serial", "batch"):
            for who in ("programs", "eager", "eager", "programs"):
                key = f"{kind}_{who}"
                t0 = time.perf_counter()
                fns[key]()
                sync(torch)
                times[key].append(time.perf_counter() - t0)
    return {f"{k}_blocks_per_s": [blocks / t for t in v]
            for k, v in times.items()}


# phase 13b: (name, Engine keywords, the file: "10s" or "60s"); the
# configurations that run their stages as programs since the exact mode,
# the other allocators and host packing took them
PROGRAM_MODES = (
    ("exact-f32-128", dict(rate_mode="exact", chunk_blocks=128)),
    ("exact-f32-512", dict(rate_mode="exact", chunk_blocks=512)),
    ("exact-f64", dict(rate_mode="exact", precision="f64")),
    *((mode, dict(alloc_mode=mode)) for mode in ALLOC_MODES),
    ("host-pack", dict(device_pack=False)),
)
# the kernels each of them launches beyond the analysis's K4
PROGRAM_MODE_KERNELS = {
    "exact": ("cost_table", "exact_scan", "water_fill", "pack_payload"),
    **{m: ("pack_payload", "reservoir_scan",
           *(k for k in (ALLOC_KERNEL[m],) if k)) for m in ALLOC_MODES},
    "host-pack": ("water_fill", "reservoir_scan")}


def program_stages(kw: dict) -> set:
    """The encode stages that run as programs on the card for Engine
    keywords kw (programs.encode_programs)."""
    if kw.get("rate_mode") == "exact":
        return {"analyze", "cost", "exact_scan", "final"}
    return {"analyze", "measure", "final"}


def phase13_modes(torch, make_engine, pcm: np.ndarray, long_pcm: np.ndarray,
                  reps: int = 2) -> dict:
    """The configurations of PROGRAM_MODES through programs against the
    same Engine launch by launch (use_programs False), each on pcm (a
    10 s file): programs.encode_programs' answer stage by stage; a first
    encode (the captures, timed) and a second (replays) byte-equal to the
    launch-by-launch encode; the decode by programs on both parse routes
    sample-equal to eager_decode's (host parse); the encode's dispatch half under
    torch.cuda.set_sync_debug_mode("error") (no host sync, no
    device-to-host copy), its payload the same bytes; the capture
    seconds, the memory reserved and the Engine's graph pools.  Then the
    exact mode in float32 and float64 on long_pcm (the 60 s file): serial
    encode blocks/s by programs and launch by launch, in turns (programs,
    launches, launches, programs) `reps` times, and the phase's seconds so
    far.  Returns the launches of
    the second encodes summed (the "programs-modes" path: K7, K8, K9 and
    K10 through programs)."""
    from pactpu_torch import CodecConfig
    from pactpu_torch.codec import programs
    from pactpu_torch.codec.header import write_header
    from pactpu_torch.ops import kernels as K
    cuda = DEV != "cpu"
    total = {k: 0 for k in K.LAUNCHES}
    start = time.perf_counter()
    for name, kw in PROGRAM_MODES:
        gc.collect()             # the memory read below: this mode's own
        if cuda:
            torch.cuda.empty_cache()
        kw = dict(kw)
        if "alloc_mode" in kw:
            kw["cfg"] = CodecConfig(alloc_mode=kw.pop("alloc_mode"))
        eng = make_engine(**kw)
        eng_dev = make_engine(decode_parse="device", **kw)
        want = program_stages(kw)
        routes = programs.encode_programs(eng)
        check(routes == {s: s in want and programs._card(eng)
                         for s in routes}
              and programs.decode_programs(eng_dev) == programs._card(eng),
              f"13b {name}: the stages' routes are {routes}")
        t0 = time.perf_counter()
        first = eng.encode(pcm)
        sync(torch)
        first_s = time.perf_counter() - t0
        K.reset_launches()
        streams = eng.encode(pcm)
        sync(torch)
        launches = dict(K.LAUNCHES)
        for k, n in launches.items():
            total[k] += n
        eng.use_programs = False
        ref = eng.encode(pcm)
        eng.use_programs = True
        check(first == streams == ref,
              f"13b {name}: the programmed stream differs from the same "
              "Engine's launch by launch")
        ref_pcm = eager_decode(eng, ref)[1]
        check(np.array_equal(eng.decode(ref)[1], ref_pcm)
              and np.array_equal(eng_dev.decode(ref)[1], ref_pcm),
              f"13b {name}: a programmed decode (host or device parse) "
              "differs from the eager chain's")
        kind = ("exact" if kw.get("rate_mode") == "exact" else
                kw["cfg"].alloc_mode if "cfg" in kw else "host-pack")
        check_launched(launches, ("spread_maskers_up",
                                  *PROGRAM_MODE_KERNELS[kind]),
                       f"13b {name}")
        check(kind != "host-pack" or launches["pack_payload"] == 0,
              f"13b {name}: the host-packed encode launched K3")
        up = eng._upload_pcm(pcm, eng._analysis_batches)
        sync(torch)
        if cuda:
            torch.cuda.set_sync_debug_mode("error")
        try:
            st = eng._encode_dispatch(up)
        finally:
            if cuda:
                torch.cuda.set_sync_debug_mode(0)
        check(write_header(eng.cfg, pcm.shape[0])[0]
              + eng._finish_encode(st) == ref,
              f"13b {name}: the dispatch under sync debug gave other bytes")
        sync(torch)
        replays = {st_: sum(p.replays for _, p in eng.programs.items(st_))
                   for st_ in sorted(want)}
        check(not cuda or all(n > 0 for n in replays.values()),
              f"13b {name}: a stage never replayed its program: {replays}")
        say("13b-program-modes", mode=name, blocks=n_blocks(pcm),
            routes=routes, first_encode_s=first_s,
            capture_s=eng.programs.capture_s,
            captures=eng.programs.captures, replays=replays,
            memory_mb=({k: getattr(torch.cuda, f"memory_{k}")() / 2 ** 20
                        for k in ("reserved", "allocated")}
                       if cuda else None),
            pools_mb={k: v / 2 ** 20
                      for k, v in eng.programs.reserved().items()}
            if cuda else None,
            launches={k: v for k, v in launches.items() if v},
            bytes=len(ref))
        del eng, eng_dev
    blocks = n_blocks(long_pcm)
    for precision in ("f32", "f64"):
        eng = make_engine(rate_mode="exact", precision=precision)
        eng.encode(long_pcm)                   # captures
        times = {"programs": [], "launches": []}
        for _ in range(reps):
            for who in ("programs", "launches", "launches", "programs"):
                eng.use_programs = who == "programs"
                sync(torch)
                t0 = time.perf_counter()
                eng.encode(long_pcm)
                sync(torch)
                times[who].append(time.perf_counter() - t0)
        eng.use_programs = True
        say("13b-exact-timing", precision=precision, blocks=blocks,
            **{f"serial_encode_{k}_blocks_per_s": [blocks / t for t in v]
               for k, v in times.items()},
            phase_s=time.perf_counter() - start)
        del eng
    return total


def no_sync(torch, fn):
    """fn run under torch.cuda.set_sync_debug_mode("error") on the card: a
    host sync or a copy from the host inside it raises (on the CPU, fn)."""
    def guarded(*args, **kw):
        if DEV == "cpu":
            return fn(*args, **kw)
        torch.cuda.set_sync_debug_mode("error")
        try:
            return fn(*args, **kw)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    return guarded


def by_route(fn) -> dict:
    """fn by programs and launch by launch (programs.launch_by_launch), as
    in_turns takes them: {"programs": fn, "launches": ...}."""
    from pactpu_torch.codec import programs

    def launches():
        with programs.launch_by_launch():
            return fn()
    return {"programs": fn, "launches": launches}


def program_stats(engines) -> dict:
    """The program layer of some Engines (each once): captures, capture
    seconds, replays by stage and the graph pools' MB by pool (None on the
    CPU)."""
    seen = list({id(e): e for e in engines}.values())
    replays, pools = {}, {}
    for e in seen:
        for stage, n in e.programs.replays().items():
            replays[stage] = replays.get(stage, 0) + n
        if DEV != "cpu":
            for name, n in e.programs.reserved().items():
                pools[name] = pools.get(name, 0) + n / 2 ** 20
    return dict(engines=len(seen),
                captures=sum(e.programs.captures for e in seen),
                capture_s=sum(e.programs.capture_s for e in seen),
                replays=replays,
                pools_mb=pools if DEV != "cpu" else None)


# phase 13c: the stages each path must have replayed
PATH_STAGES = {
    "stream": ("analyze", "measure", "final", "cost", "exact_scan",
               "synthesize"),
    "shard": ("analyze", "shard_measure", "shard_final", "shard_decode"),
    "pac": ("baseline", "decode", "decode_device_parse")}


def phase13_paths(torch, make_engine, pcm: np.ndarray, short: np.ndarray,
                  long_pcm: np.ndarray, shards=(1, 2, 4),
                  ckpt_block: int = 700) -> dict:
    """The paths that run as programs since the streams, the shard paths
    and the .pac coder took them, each against the same path launch by
    launch (programs.launch_by_launch):

    - streams: pcm (the 60 s file) in 1 s pushes, restored after block
      ckpt_block, and `short` (10 s) as an exact stream, the same bytes by
      both routes and the Engine's; the streamed decode of pcm's stream at
      16 and 512 blocks, the same samples as each other and
      Engine.decode; a push's dispatch (StreamingEncoder._dispatch) with
      no host sync;
    - shards (meshes of `shards` local shards, no process group): pcm's
      encode_distributed in cbr and reservoir, the same bytes by both
      routes and the Engine's, decode_distributed the same samples by both
      routes; a second call captures nothing; a cbr encode's
      sharded_encode with no host sync;
    - .pac stereo and mono (pcm's channels): the encode and the decode by
      host and device parse, the same bytes and samples by both routes;
      the encode's dispatch (Engine._baseline_dispatch) and the
      device-parse decode's (Engine._decode_queue) with no host sync.

    Then, in turns (programs, launches, launches, programs): pcm in 1 s
    pushes, its 16-block streamed decode, the cbr encode of long_pcm on 1
    and 4 shards, the .pac encode and device-parse decode of pcm.  Prints
    the captures, replays by stage, capture seconds and graph pools of
    each path's Engines, the memory reserved and allocated and the
    phase's seconds.  Returns the launches of the programmed runs that
    the gates compare (the "programs-paths" path)."""
    from pactpu_torch import CodecConfig, StreamingEncoder
    from pactpu_torch.codec import programs
    from pactpu_torch.ops import kernels as K
    from pactpu_torch.parallel import cluster, shard
    eager = programs.launch_by_launch
    start = time.perf_counter()
    shard_dev = "cpu" if DEV == "cpu" else "cuda:0"
    launches = {k: 0 for k in K.LAUNCHES}

    def counted(fn):
        sync(torch)
        K.reset_launches()
        out = fn()
        sync(torch)
        for k, n in K.LAUNCHES.items():
            launches[k] += n
        return out

    def both(fn):
        """fn by programs (its launches counted), then launch by launch."""
        got = counted(fn)
        with eager():
            return got, fn()

    eng = make_engine()
    gold = eng.encode(pcm)
    _, want = eng.decode(gold)

    # streams
    cuts = stream_splits(pcm)["1s"]
    mid = ckpt_block * 1024 + 123
    enc_engines, dec_engines = [], []
    got, ref = both(lambda: stream_encode(pcm, cuts, engines=enc_engines))
    check(got == ref == gold, "13c: the 1 s stream by programs, launch by "
          "launch and Engine.encode differ")
    got, ref = both(lambda: stream_encode(
        pcm, [0, mid] + [c for c in cuts if c > mid], resume_at=mid,
        engines=enc_engines))
    check(got == ref == gold, f"13c: the stream restored after block "
          f"{ckpt_block} differs by programs or launch by launch")
    xc = list(range(0, short.shape[0], FS)) + [short.shape[0]]
    got, ref = both(lambda: stream_encode(short, xc, rate_mode="exact",
                                          engines=enc_engines))
    check(got == ref == make_engine(rate_mode="exact").encode(short),
          "13c: the exact stream by programs, launch by launch and the "
          "exact Engine differ")
    for chunk in (16, 512):
        got, ref = both(lambda: stream_decode(gold, chunk,
                                              engines=dec_engines))
        check(np.array_equal(got, ref) and np.array_equal(got, want),
              f"13c: the {chunk}-block streamed decode differs by programs "
              "or launch by launch")
    enc = StreamingEncoder(device=DEV)
    enc_engines.append(enc._eng)
    parts = [enc.header(pcm.shape[0]), enc.push(pcm[:FS])]
    enc._dispatch = no_sync(torch, enc._dispatch)
    parts.append(enc.push(pcm[FS:2 * FS]))
    del enc._dispatch
    parts += [enc.push(pcm[2 * FS:]), enc.flush()]
    check(b"".join(parts) == gold, "13c: the stream whose push ran with no "
          "sync differs")

    # shards
    golds = {"cbr": make_engine(rate_mode="cbr").encode(pcm),
             "reservoir": gold}
    meshes = {n: shard.make_mesh([shard_dev] * n) for n in shards}
    owners = shard.mesh_owners(CodecConfig(), meshes[shards[0]])

    def dist(x, n, mode="cbr"):
        res = cluster.encode_distributed(x, mesh=meshes[n], rate_mode=mode)
        return cluster.assemble_stream(res.header,
                                       [(res.block_start, res.payload)])

    def dist_dec(n):
        res = cluster.decode_distributed(gold, mesh=meshes[n])
        return cluster.assemble_pcm([(res.sample_start, res.pcm)],
                                    res.num_samples)

    for n in shards:
        for mode, want_s in golds.items():
            got, ref = both(lambda: dist(pcm, n, mode))
            check(got == ref == want_s, f"13c: {mode} on {n} shards differs "
                  "by programs, launch by launch or from the Engine")
        got, ref = both(lambda: dist_dec(n))
        check(np.array_equal(got, ref) and max_lsb(got, want)[0] <= 1,
              f"13c: decode_distributed on {n} shards differs by programs "
              "or launch by launch")
    captured = owners[0].programs.captures
    check(dist(pcm, shards[-1]) == golds["cbr"]
          and owners[0].programs.captures == captured,
          "13c: a second distributed call captured again")
    sharded = shard.sharded_encode
    shard.sharded_encode = no_sync(torch, sharded)
    try:
        got = dist(pcm, shards[-1])
    finally:
        shard.sharded_encode = sharded
    check(got == golds["cbr"], "13c: the shard encode with no sync differs")

    # .pac
    pac = {}
    for name, fields in (("stereo-pac", {}),
                         ("mono-pac", dict(n_channels=1))):
        cfg = CodecConfig(**fields)
        e = make_engine(cfg=cfg, fmt="pac")
        ed = make_engine(cfg=cfg, fmt="pac", decode_parse="device")
        x = np.ascontiguousarray(pcm[:, :cfg.n_channels])
        s_, ref = both(lambda: e.encode(x))
        check(s_ == ref, f"13c: the {name} encode differs by programs and "
              "launch by launch")
        for route, d in (("host", e), ("device", ed)):
            got, ref = both(lambda: d.decode(s_)[1])
            check(np.array_equal(got, ref),
                  f"13c: the {name} {route}-parse decode differs by programs "
                  "and launch by launch")
        e._baseline_dispatch = no_sync(torch, e._baseline_dispatch)
        ed._decode_queue = no_sync(torch, ed._decode_queue)
        check(e.encode(x) == s_ and np.array_equal(ed.decode(s_)[1], got)
              and np.array_equal(e.decode(s_)[1], got),
              f"13c: the {name} encode or decode with no sync differs")
        del e._baseline_dispatch, ed._decode_queue
        pac[name] = (e, ed, x, s_)
    correct_s = time.perf_counter() - start

    e, ed, x, s_ = pac["stereo-pac"]
    for n in (1, shards[-1]):
        dist(long_pcm, n)                      # the long file's captures
    timing = {
        "stream_1s_encode_s": in_turns(torch, by_route(
            lambda: stream_encode(pcm, cuts))),
        "stream_16_decode_s": in_turns(torch, by_route(
            lambda: stream_decode(gold, 16))),
        **{f"shards_{n}_cbr_long_s": in_turns(torch, by_route(
            lambda n=n: dist(long_pcm, n))) for n in (1, shards[-1])},
        "pac_encode_s": in_turns(torch, by_route(lambda: e.encode(x))),
        "pac_device_decode_s": in_turns(torch, by_route(
            lambda: ed.decode(s_)))}
    sync(torch)
    stats = dict(stream=program_stats(enc_engines + dec_engines),
                 shard=program_stats(owners),
                 pac=program_stats([v for p in pac.values() for v in p[:2]]))
    for path, stages in PATH_STAGES.items():
        check(not programs._card(eng) or all(
            stats[path]["replays"].get(st, 0) > 0 for st in stages),
            f"13c: a {path} stage never replayed its program: "
            f"{stats[path]['replays']}")
    say("13c-program-paths", blocks=n_blocks(pcm),
        long_blocks=n_blocks(long_pcm), shards=list(shards), **stats,
        second_call_captures=0, **timing,
        memory_mb=({k: getattr(torch.cuda, f"memory_{k}")() / 2 ** 20
                    for k in ("reserved", "allocated")}
                   if DEV != "cpu" else None),
        correctness_s=correct_s, phase_s=time.perf_counter() - start,
        launches={k: v for k, v in launches.items() if v})
    return launches


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke test runs only on a "
              "GPU", file=sys.stderr)
        return 2
    try:
        from pactpu_torch import Engine
        from pactpu_torch.codec.engine import device_tables
    except ImportError as e:
        print(f"chip_smoke: run from the repository root ({e})",
              file=sys.stderr)
        return 2
    smi = phase0(torch)
    files = [synth(10.0, seed) for seed in (1, 2, 3)] + [synth(60.0, 4)]
    long_pcm = synth(600.0, 5)
    eng = Engine(device="cuda", rate_mode="reservoir")
    eng_dev = Engine(device="cuda", decode_parse="device")
    res = phase1(torch, device_tables(eng.cfg, "cuda"), files[-1],
                 eng.encode(files[-1]))
    launches, streams, host_pcm = phase2(torch, eng, files)
    phase3(eng)
    phase4(torch, eng, eng_dev, files, streams)
    make = lambda **kw: Engine(device="cuda", **kw)  # noqa: E731
    on_path = {"main": launches,
               "device-parse": phase5(torch, eng_dev, streams, host_pcm),
               "aidan": phase6(torch, make, files[-1]),
               **phase7(torch, make, files[:2]),
               "exact": phase8(torch, make, files[-1]),
               **phase9(torch, make, files[:2]),
               "stream": phase10(torch, make, files[-1], files[:3]),
               "distributed": phase11(torch, make, files[-1], long_pcm),
               "surface": phase12(torch, files[0], files[-1]),
               "programs": phase13(torch, make, files),
               "programs-modes": phase13_modes(torch, make, files[0],
                                               files[-1]),
               "programs-paths": phase13_paths(torch, make, files[-1],
                                               files[0], long_pcm)}
    print(json.dumps({"kernels": [
        dict(name=name, route="cuda",
             source=f"pactpu_torch/csrc/{REPLACES[name][0]}",
             replaces=REPLACES[name][1], path=PATH_OF[name],
             launches=on_path[PATH_OF[name]][name],
             launches_by_path={p: n[name] for p, n in on_path.items()},
             **res[name])
        for name in REPLACES]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
