#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (pactpu_torch) on one NVIDIA GPU.

Run from the root of a checkout:  python3 chip_smoke.py

Phases (each prints one line; any failure raises and exits non-zero):

0. environment: the card's name and power limit, torch and CUDA versions,
   the build times of the six CUDA kernels (nvcc, sm_90a) and of the
   native bitstream runtime (g++);
1. kernel parity at their paths' shapes: K1-K3 and K5 bit for bit against
   their plain PyTorch versions, K4 and K6 within a stated tolerance, each
   timed (median of 20 runs, CUDA events; "ms" around one call of the
   wrapper, "device_ms" the kernel alone) beside its plain version, its
   bound on this card (bytes over the memory rate or operations over the
   float32 rate, whichever is larger) and, where one exists, the PyTorch
   call that computes the same function; K4 and K2 also on the edge inputs
   of k4_edge and k2_edge;
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
   and "weighted", encode -> decode of the 60 s file; streams parse back,
   SNR above the floor, K6, K2 and K3 launched; for "weighted" a second
   JAX fixture is decoded within 1 LSB and re-encoded at the same SNR.

Then a JSON line with each kernel's launches, error and times, the
nvidia-smi line, and last {"ok": true, "device": {...}}.  With no CUDA
device the script exits non-zero before printing any result.
"""

from __future__ import annotations

import json
import os
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
FS = 44100
# The reference decoder's M/S aliasing (L' = M - S, R' = M; Q1) caps the
# SNR of material whose channels differ: these files decode at 5.4 to 9.8 dB
# (the port on the CPU), as the fixture does in the JAX package (9.7 dB).
# A broken decode scores 0 dB or less.
SNR_FLOOR_DB = 3.0
# K4: every term has the plain version's bits (the same unfused float32
# operations, exp2f or its bare instruction where the two agree); the sum
# runs in masker order with a fused multiply-add, the plain version's as a
# tree: a few float32 ulp
K4_RTOL = 1e-5
K4_SPL_ATOL_DB = 1e-3
K6_RTOL = 1e-5               # as K4: the terms are equal, the sum's order not
K6_SPL_ATOL_DB = 1e-3
REPLACES = {                 # the TPU kernel body each CUDA kernel replaces
    "extract_codes": ("extract_codes.cu", "pactpu/ops/pallas_ops.py:240"),
    "water_fill": ("water_fill.cu", "pactpu/ops/pallas_ops.py:339"),
    "pack_words": ("pack_words.cu", "pactpu/ops/pallas_ops.py:176"),
    "spread_maskers_up": ("spread_up.cu", "pactpu/ops/pallas_ops.py:85"),
    "huffman_walk": ("huffman_walk.cu", "pactpu/ops/huffman_walk.py:230"),
    "spread_maskers": ("spread.cu", "pactpu/ops/pallas_ops.py:50"),
}
# the path whose launches each kernel's "launches" reports
PATH_OF = {"extract_codes": "main", "water_fill": "main",
           "pack_words": "main", "spread_maskers_up": "main",
           "huffman_walk": "device-parse", "spread_maskers": "aidan"}
# NVIDIA H100 SXM data sheet: HBM3 bytes/s, and float32 operations/s outside
# the tensor cores (also taken as the rate of the 32-bit integer operations)
PEAK_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = 67e12


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
            "zero-budget", "to-the-cap", "max-mant-1", "nan", "dead-key")


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
    of one bit, NaN SMRs, SMRs at and below the dead bands' key -1e30."""
    rng = np.random.default_rng(K2_EDGES.index(name))
    n_bands = {"one-band": 1, "32-bands": 32}.get(name, 25)
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
    return total, max_mant, n_lines, smr, lrms


def main_path_inputs(torch, dev_tables, pcm: np.ndarray, blocks: int = 512):
    """What one chunk of the main path hands to K4 and to K2: K4's
    arguments from the chunk's masker levels (6 * blocks rows), and K2's
    from its SMRs plus edge rows (zero budgets, budgets that drive bands to
    the 16-bit cap, ties in SMR).  Also the chunk's stereo variants and
    tonal drops, which K6's input is made from."""
    from pactpu_torch.codec import engine as E
    from pactpu_torch.ops import psycho
    from pactpu_torch.ops import quantize as q
    dev = dev_tables["win"].device
    psy = dev_tables["psy"]
    glob = np.zeros((2, (blocks + 1) * 1024), np.int16)
    glob[:, 1024:] = pcm[:blocks * 1024].T
    frames = E._overlap_frames(torch.from_numpy(glob).to(dev), 1024)
    sw = q.pcm16_to_float(frames) * dev_tables["win"]
    variants, drops = psycho.six_variants(sw, psy["hann"])
    mspl, peak = psycho.masker_levels(variants, psy["hann"])
    iprime = psycho.masker_intensity(mspl, peak, drops)
    k4 = (iprime, mspl, psy["bin_bark"], psy["zvec"])
    analysis = E.analyze(E.CodecConfig(), frames, dev_tables)
    smr = analysis["smr"][:, 0].contiguous().clone()
    lrms = analysis["lrms"].contiguous().clone()
    total = torch.full((blocks,), 2116, dtype=torch.int32, device=dev)
    total[:16] = 0
    total[16:32] = 30000
    total[32:48] = int(1e6)
    smr[48:64] = 20.0                               # all bands tied
    smr[64:80, ::2] = smr[64:80, 1::2].mean()       # pairwise ties
    total[64:80] = torch.arange(16, device=dev, dtype=torch.int32) * 300
    k2 = (total, 16, dev_tables["lay"]["n_lines"], smr, lrms)
    return dict(k4=k4, k2=k2, variants=variants, drops=drops)


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
    from pactpu_torch.codec import engine as E
    from pactpu_torch.ops import kernels as K
    from pactpu_torch.ops import psycho
    dev = torch.device("cuda")
    blocks = 512
    rng = np.random.default_rng(1)
    res, extra = {}, {}      # extra: beside the times, on the 1-kernel line

    def record(name, err, fast, plain, moved, ops, library=None,
               plain_runs=20):
        """moved: bytes of every input and output once; ops: operations
        these inputs need; the bound is the larger of their times."""
        t_bytes = moved / PEAK_BYTES_PER_S * 1e3
        t_ops = ops / PEAK_OPS_PER_S * 1e3
        extra[name] = dict(device_ms=device_ms(torch, fast))
        res[name] = dict(
            max_abs_err=err, ms=median_ms(torch, fast),
            plain_ms=median_ms(torch, plain, plain_runs),
            bound_ms=max(t_bytes, t_ops),
            bound_by="bytes" if t_bytes >= t_ops else "operations",
            library_ms=median_ms(torch, library) if library else None)

    # K1: 1024 rows x 1024 lines at a 256-word bucket, realistic widths
    lay = dev_tables["lay"]
    seg = lay["seg"].cpu().numpy()
    ba = rng.integers(0, 17, (1024, 25)).astype(np.int32)
    ba[ba == 1] = 0
    ba[:, 12:] = np.minimum(ba[:, 12:], 4)          # rows fit 256 words
    width = ba[:, seg]
    mant = np.where(width > 0, rng.integers(0, 2 ** 16, width.shape)
                    & ((1 << width) - 1), 0).astype(np.int32)
    n_lines = lay["n_lines"].cpu().numpy()
    words = native.repack_codes(mant, ba, n_lines, 256).view(np.int32)
    ba_t = torch.from_numpy(ba).to(dev)
    off, wid, _ = E._line_bit_offsets(ba_t, lay)
    check(bool(((off & 31) + wid > 32).any()), "K1 input has no field "
          "that spans two words")
    words_t = torch.from_numpy(words).to(dev)
    out = K.extract_codes(words_t, off, wid)
    plain = K.extract_codes_plain(words_t, off, wid)
    check(torch.equal(out, plain), "K1 differs from its plain version")
    check(np.array_equal(out.cpu().numpy(), mant), "K1 does not "
          "reproduce the repacked codes")
    # per field: two shifts, a funnel shift, a compare, address arithmetic
    record("extract_codes", 0.0, lambda: K.extract_codes(words_t, off, wid),
           lambda: K.extract_codes_plain(words_t, off, wid),
           nbytes(words_t, off, wid, out), 8 * out.numel())

    # K4 on the masker levels of one chunk (3072 rows)
    psy = dev_tables["psy"]
    chunk = main_path_inputs(torch, dev_tables, pcm, blocks)
    variants, drops = chunk["variants"], chunk["drops"]
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
    items = 1148
    err3 = 0.0
    for n_words in (968, 256):
        p0 = torch.from_numpy(rng.integers(-2 ** 31, 2 ** 31, (1024, items),
                                           dtype=np.int64).astype(np.int32))
        p1 = torch.from_numpy(rng.integers(-2 ** 31, 2 ** 31, (1024, items),
                                           dtype=np.int64).astype(np.int32))
        w0 = torch.from_numpy(np.sort(rng.integers(
            -2, n_words + 2, (1024, items)), axis=1).astype(np.int32))
        p0, p1, w0 = p0.to(dev), p1.to(dev), w0.to(dev)
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

    # K5: the first 1,024 channel-block rows of the 60 s stream at their
    # word bucket, plus 64 copies with one word XORed with random bits
    from pactpu_torch.codec.header import read_header
    from pactpu_torch.ops import huffman_decode as hd
    from pactpu_torch.ops import huffman_walk as hw
    cfg, _, hoff = read_header(stream)
    rows_w, rows_n = hd.frame_rows(stream[hoff:])
    bucket = next(w for w in E._PAYLOAD_WORD_BUCKETS if w >= rows_w.shape[1])
    wk = np.zeros((1088, bucket), np.uint32)
    wk[:1024, :rows_w.shape[1]] = rows_w[:1024]
    wk[1024:] = wk[:64]
    nk = np.concatenate([rows_n[:1024], rows_n[:64]])
    for r in range(1024, 1088):
        wk[r, rng.integers(0, max(1, nk[r] // 32))] ^= np.uint32(
            rng.integers(1, 1 << 32))
    lut = hw.device_walk_lut(None, dev)
    wk_t = torch.from_numpy(wk.view(np.int32)).to(dev)
    nk_t = torch.from_numpy(nk).to(dev)
    walk_args = (wk_t, lut, cfg.band_layout.n_lines, cfg.n_scale_bits,
                 cfg.n_mant_size_bits, cfg.n_table_id_bits)
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
                       ("LRMS", lrms_pos, torch.ones_like(lrms_pos))):
        check(torch.equal(K.extract_codes(wk_t, o, w),
                          K.extract_codes_plain(wk_t, o, w)),
              f"K1 differs from its plain version at the {what} shape")
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
    # operations: ~20 integer operations per decoded line, ~10 per band
    active = (rec[1] & 0xFF) > 0
    lines_walked = int((active.long() * lay["n_lines"][None, :]).sum())
    record("huffman_walk", 0.0, lambda: K.huffman_walk(*walk_args),
           lambda: K.huffman_walk_plain(*walk_args),
           nbytes(wk_t, *lut.values(), *rec),
           20 * lines_walked + 10 * active.numel(), plain_runs=3)

    # K6 on the compacted weighted-mode maskers of the same chunk
    height, bark, keep = psycho.aidan_peaks(variants, FS, "weighted",
                                            psy["hann"])
    slots = psycho.compact_slots(height, keep, bark, psy, 0.37)
    check(slots[0].shape == (3072, 513), f"K6 slots {tuple(slots[0].shape)}")
    check(int(keep.sum(1).max()) <= 513, "more peaks than slots")
    args6 = (*slots, drops, psy["zvec"])
    out = K.spread_maskers(*args6)
    plain = K.spread_maskers_plain(*args6)
    err = (out - plain).abs()
    check(bool((err <= K6_RTOL * plain.abs() + 1e-30).all()),
          f"K6 beyond rtol {K6_RTOL}: max rel "
          f"{float((err / plain.abs().clamp(min=1e-30)).max())}")
    d_spl = (psycho.spl(psy["quiet_i"][None] + out)
             - psycho.spl(psy["quiet_i"][None] + plain)).abs().max()
    check(float(d_spl) <= K6_SPL_ATOL_DB, f"K6 threshold off by {d_spl} dB")
    # operations: 11 per (row, valid slot, line) triple
    record("spread_maskers", float(err.max()),
           lambda: K.spread_maskers(*args6),
           lambda: K.spread_maskers_plain(*args6),
           nbytes(*args6, out), 11 * int(slots[3].sum()) * out.shape[1])
    torch.cuda.synchronize()
    for name, r in res.items():
        say("1-kernel", name=name, **r, **extra[name])
    return res


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
    say("2-main-path", files=len(files),
        blocks=[n_blocks(p) for p in files], snr_db=snrs,
        bytes=[len(s) for s, _ in serial], launches=launches)
    return launches, [s for s, _ in serial], [out for _, (_, out) in serial]


def fixture_decode(eng, path: str = FIXTURE):
    """Decode the stream of a JAX-made fixture: within 1 LSB of the JAX
    PCM.  Returns (input pcm, stream, JAX pcm, |difference|)."""
    z = np.load(path)
    pcm, stream, ref = z["pcm"], z["stream"].tobytes(), z["decoded"]
    fs, out = eng.decode(stream)
    check(out.shape == ref.shape, "fixture decode has the wrong shape")
    d = np.abs(out.astype(np.int32) - ref.astype(np.int32))
    check(int(d.max()) <= 1, f"fixture decode off by {int(d.max())} LSB")
    return pcm, stream, ref, d


def phase3(eng, path: str = FIXTURE, phase: str = "3-fixture") -> None:
    pcm, stream, ref, d = fixture_decode(eng, path)
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


def phase4(torch, eng, eng_dev, files, streams) -> None:
    """eng decodes by host parse, eng_dev by device parse."""
    blocks = sum(n_blocks(p) for p in files)
    serial, batch = [], []
    decode = {"host": [], "device": []}
    for _ in range(3):
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
    """The aidan peak modes: encode -> decode of one file per mode."""
    from pactpu_torch import CodecConfig
    from pactpu_torch.ops import kernels as K
    launches = {}
    for mode in ("para", "weighted"):
        eng = make_engine(cfg=CodecConfig(peak_mode=mode))
        sync(torch)
        K.reset_launches()
        stream = eng.encode(pcm)
        fs, out = eng.decode(stream)
        sync(torch)
        launches[mode] = dict(K.LAUNCHES)
        check_launched(launches[mode],
                       ["spread_maskers", "water_fill", "pack_words"],
                       f"the {mode} path")
        check(launches[mode]["spread_maskers_up"] == 0,
              f"the {mode} path ran the dense upslope kernel")
        parses_back(stream, eng.cfg, pcm)
        snr = snr_db(pcm, out)
        check(fs == FS and np.isfinite(snr) and snr > SNR_FLOOR_DB,
              f"{mode}: SNR {snr:.2f} dB not above the {SNR_FLOOR_DB} dB "
              "floor")
        say("6-aidan", mode=mode, blocks=n_blocks(pcm), bytes=len(stream),
            snr_db=round(snr, 3), launches=launches[mode])
        if mode == "weighted":
            phase3(eng, FIXTURE_WEIGHTED, "6-aidan-fixture")
    return launches["weighted"]


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
    eng = Engine(device="cuda", rate_mode="reservoir")
    eng_dev = Engine(device="cuda", decode_parse="device")
    res = phase1(torch, device_tables(eng.cfg, "cuda"), files[-1],
                 eng.encode(files[-1]))
    launches, streams, host_pcm = phase2(torch, eng, files)
    phase3(eng)
    phase4(torch, eng, eng_dev, files, streams)
    on_path = {"main": launches,
               "device-parse": phase5(torch, eng_dev, streams, host_pcm),
               "aidan": phase6(torch, lambda **kw: Engine(device="cuda",
                                                          **kw), files[-1])}
    print(json.dumps({"kernels": [
        dict(name=name, route="cuda",
             source=f"pactpu_torch/csrc/{REPLACES[name][0]}",
             replaces=REPLACES[name][1], path=PATH_OF[name],
             launches=on_path[PATH_OF[name]][name], **res[name])
        for name in REPLACES]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
