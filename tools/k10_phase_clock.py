#!/usr/bin/env python3
"""Where K10 (cost_table) spends its clocks, on one CUDA GPU.

    python3 tools/k10_phase_clock.py [--csrc DIR] [--blocks 512] [--runs 5]
                                     [--sass OUT_DIR]

Copies DIR/cost_table.cu (this checkout's pactpu_torch/csrc by default),
inserts clock64() stamps between the phases of its warps' work, builds the
copy with the package's nvcc flags (ptxas's report of every form printed
by name) into pactpu_torch/_build/k10_clock/ and runs it through
kernels.cost_table (the wrapper, with the copy's library bound in place of
the package's) on chip_smoke.py's phase-1 chunk: the first `--blocks`
blocks of its 60 s file, in float32 and in float64, each held bit for bit
to kernels.cost_table_plain first.  The shipped kernel has no switch for
this: the stamps live only in the copy.  A copy of the earlier K10 (it
reads the table set unpacked) is launched through tools/kernel_ab.py's
cost_table_unpacked.

A stamp reads the clock on each warp as it passes; lane 0 of every warp
adds its clocks to one counter a phase (and a counter a phase and
allocation for the line loop), so a phase's clocks are summed over every
warp of the grid.  The phases, by the source they instrument:

- "one-warp-items" (the earlier kernel: a warp walks one (block, channel)
  item for every split-th allocation, 32 lines a lane in registers):
  "prologue", the CTA's staging of the hot symbols, 2^k and the band
  layout, up to its barrier, and the lane's band starts; "peaks", a
  unit's lines into registers, its band peaks and the zero allocations;
  "scale", an allocation's scale factors; "lines", an allocation's line
  loop (split by allocation); "scan", the warp scan and the band sums'
  stores.
- "cta-items" (a CTA walks one item at a time, a warp an allocation, the
  packed table set in shared memory): "prologue", the CTA's bulk copy of
  the table set and the band layout; "peaks", the barrier before an
  item's allocations (for the first item also its peaks and the table
  set's arrival); "scale", "lines" and "scan" as above, the band sums
  going to the item's block in shared memory; "store", the barrier after
  the allocations, the block's copy out and the next item's peaks.

Printed for each precision: clocks a phase summed over the grid and
divided by the items, each phase's share, the line loop's clocks by
allocation a warp-line (32 lines a lane: clocks of the loop over the
warps that ran it, over 32), the kernel's clocks from start to end against
the phases' sum, the SM clock, and the time alone of the copy and of the
shipped kernel (chip_smoke.device_ms, in turns).  Also, from the plain
version's symbols: for each allocation the share of lines whose symbol is
at or past 4,096 (the old kernel's staged prefix) and past the last
symbol any table codes, and the share of warp line steps (one-warp-items'
layout: lane l holds lines 32 l .. 32 l + 31) in which any lane's symbol
is at or past 4,096.  With --sass, the SASS of the shipped library's K10
and of the copy goes to OUT_DIR.

The anchors below name the statements between which the stamps go; a
source without them is refused.  Needs a CUDA device; imports nothing of
JAX.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tools"))

PHASES = ("prologue", "peaks", "scale", "scan", "store")
N_ALLOC_SLOTS = 17
# counters: the phases, the line loop by allocation, the warps' units,
# warp-allocations by allocation, and the warps' clocks start to end
SLOTS = len(PHASES) + 2 * N_ALLOC_SLOTS + 2

HEADER = r"""
// ---- k10_phase_clock: stamps (not part of the shipped kernel) ----
#define K10_PHASES 5
#define K10_ALLOCS 17
#define K10_SLOTS (K10_PHASES + 2 * K10_ALLOCS + 2)
#define K10_PROLOGUE 0
#define K10_PEAKS 1
#define K10_SCALE 2
#define K10_SCAN 3
#define K10_STORE 4
#define K10_LINES K10_PHASES
#define K10_RUNS (K10_PHASES + K10_ALLOCS)
#define K10_UNITS (K10_PHASES + 2 * K10_ALLOCS)
#define K10_TOTAL (K10_UNITS + 1)
__device__ unsigned long long k10_clock_out[K10_SLOTS];
#define K10_MARK(slot)                                   \
  {                                                      \
    const long long k10_now = clock64();                 \
    k10c[slot] += k10_now - k10_last;                    \
    k10_last = k10_now;                                  \
  }
#define K10_FLUSH                                                 \
  if ((threadIdx.x & 31) == 0) {                                  \
    k10c[K10_TOTAL] = clock64() - k10_start;                      \
    for (int k10i = 0; k10i < K10_SLOTS; ++k10i)                  \
      atomicAdd(k10_clock_out + k10i,                             \
                static_cast<unsigned long long>(k10c[k10i]));     \
  }
extern "C" int pactpu_k10_clock_read(unsigned long long* host, int reset) {
  cudaError_t e = cudaMemcpyFromSymbol(host, k10_clock_out,
                                       sizeof(k10_clock_out));
  if (e == cudaSuccess && reset) {
    unsigned long long zero[K10_SLOTS] = {};
    e = cudaMemcpyToSymbol(k10_clock_out, zero, sizeof(zero));
  }
  return static_cast<int>(e);
}
"""

START = r"""
  long long k10c[K10_SLOTS] = {};
  long long k10_last = clock64();
  const long long k10_start = k10_last;
"""

# (anchor, text, "before" | "after"), each anchor found exactly once, by
# the K10 source they instrument
ANCHORS = {
    "one-warp-items": [
        ("#include <math.h>\n", HEADER, "after"),
        ("  extern __shared__ __align__(16) unsigned char smem[];\n", START,
         "after"),
        ("  for (int gw = blockIdx.x * warps + warp; gw < items * split;\n",
         "  K10_MARK(K10_PROLOGUE)\n", "before"),
        ("    for (int a = 1 + part; a <= max_mant; a += split) {\n",
         "    K10_MARK(K10_PEAKS)\n    k10c[K10_UNITS] += 1;\n", "before"),
        ("      int clip = clip_full >> (L - scale);\n",
         "      K10_MARK(K10_SCALE)\n", "after"),
        ("      // the lanes' prefixes into the block's: one exclusive warp "
         "scan\n",
         "      K10_MARK(K10_LINES + a)\n      k10c[K10_RUNS + a] += 1;\n",
         "before"),
        ("      __syncwarp();\n    }\n  }\n}\n",
         "      __syncwarp();\n      K10_MARK(K10_SCAN)\n    }\n  }\n"
         "  K10_FLUSH\n}\n", "replace"),
    ],
    "cta-items": [
        ("#include <math.h>\n", HEADER, "after"),
        ("  extern __shared__ __align__(16) unsigned char smem[];\n", START,
         "after"),
        ("  const int peak_span = (lpl + warps - 1) / warps;", 
         "  K10_MARK(K10_PROLOGUE)\n", "before"),
        ("    int32_t* dst = staged ? block : cost + static_cast<int64_t>"
         "(item) * n_out;\n",
         "    K10_MARK(K10_PEAKS)\n    k10c[K10_UNITS] += 1;\n", "before"),
        ("      const int mask = (1 << (a - 1)) - 1;\n      __syncwarp();\n",
         "      K10_MARK(K10_SCALE)\n", "after"),
        ("      // each table's length + a x escapes in 16-bit halves, then "
         "the lanes'\n",
         "      K10_MARK(K10_LINES + a)\n      k10c[K10_RUNS + a] += 1;\n",
         "before"),
        ("      __syncwarp();\n    }\n    cp_async_wait_all();\n",
         "      __syncwarp();\n      K10_MARK(K10_SCAN)\n    }\n"
         "    cp_async_wait_all();\n", "replace"),
        ("    if (next < items) band_peaks(buf ^ 1, peak + (buf ^ 1) * "
         "n_bands);\n  }\n}\n",
         "    if (next < items) band_peaks(buf ^ 1, peak + (buf ^ 1) * "
         "n_bands);\n    K10_MARK(K10_STORE)\n  }\n  K10_FLUSH\n}\n",
         "replace"),
    ],
}


def instrument(src: str) -> tuple:
    """The source with the stamps of the first form whose anchors it all
    holds: (form, text)."""
    for form, anchors in ANCHORS.items():
        if all(src.count(a) == 1 for a, _, _ in anchors):
            for anchor, text, where in anchors:
                src = src.replace(anchor, {
                    "before": text + anchor, "after": anchor + text,
                    "replace": text}[where])
            return form, src
    raise SystemExit("k10_phase_clock: the K10 source holds none of the "
                     "known anchor sets (" + ", ".join(ANCHORS) + ")")


def ptxas_by_form(log: str) -> list:
    """ptxas's register and shared-memory lines, each under the demangled
    name of the form it reports (cost_table_kernel<float, 2, true> ...)."""
    out, name = [], None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            name = m.group(1)
            continue
        if name and ("registers" in line or "spill" in line):
            out.append({"kernel": demangle(name), "ptxas": line.strip()})
    return out


def demangle(name: str) -> str:
    try:
        res = subprocess.run(["c++filt", name], capture_output=True,
                             text=True, timeout=30)
        return res.stdout.strip() or name
    except OSError:
        return name


def build(K, csrc: str, out_dir: str):
    with open(os.path.join(csrc, "cost_table.cu")) as f:
        form, text = instrument(f.read())
    os.makedirs(out_dir, exist_ok=True)
    src = os.path.join(out_dir, "cost_table_clock.cu")
    with open(src, "w") as f:
        f.write(text)
    lib = os.path.join(out_dir, "libk10_clock.so")
    cmd = [K._nvcc(), *K.NVCC_FLAGS, "-I", csrc, "-shared", "-o", lib, src]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise SystemExit("k10_phase_clock: nvcc failed:\n" + res.stdout
                         + res.stderr)
    print(json.dumps({"build": lib, "form": form,
                      "ptxas": ptxas_by_form(res.stdout + res.stderr)}))
    return lib, form


def shipped_ptxas(K) -> list:
    """ptxas's lines for the shipped cost_table.cu, from the package's
    build log."""
    with open(K.BUILD_LOG) as f:
        log = f.read()
    # the compile command ends with the source's path; ptxas's lines follow
    # it up to the next command
    at = log.find(os.sep + "cost_table.cu\n")
    if at < 0:
        return []
    nxt = log.find(K._nvcc(), at + 1)
    return ptxas_by_form(log[at:nxt if nxt > 0 else len(log)])


def sass(K, lib: str, path: str) -> None:
    cuobjdump = os.path.join(os.path.dirname(K._nvcc()), "cuobjdump")
    res = subprocess.run([cuobjdump, "-sass", lib], capture_output=True,
                         text=True, check=True)
    with open(path, "w") as f:
        f.write(res.stdout)


def symbol_shares(torch, a10) -> dict:
    """For each allocation, from the plain version's quantizers: the share
    of lines whose symbol is >= 4,096 and past the last coded symbol, and
    the share of warp line steps with a lane at or past 4,096 (lane l
    holding lines 32 l .. 32 l + 31, as the one-warp-items kernel)."""
    from pactpu_torch.ops import huffman
    from pactpu_torch.ops import quantize as q
    mixed, lay, lens, _, n_scale_bits, max_mant = a10
    mixed = mixed.double().cpu() if mixed.dtype == torch.float64 \
        else mixed.cpu()
    lens = lens.cpu()
    coded = (lens > 0).any(0).nonzero()
    last = int(coded.max()) if coded.numel() else -1
    n_sym = lens.shape[1]
    peak = torch.where(lay["band_empty"].cpu(), 0.0, torch.abs(mixed)[
        ..., lay["band_lines"].cpu()].amax(-1))
    half = mixed.shape[-1]
    out = {}
    for a in range(1, max_mant + 1):
        a_t = torch.full((), a, dtype=torch.int32)
        sf = q.scale_factor(peak, n_scale_bits, a_t)
        mant = q.bfp_mantissa(mixed, sf[..., lay["seg"].cpu()], n_scale_bits,
                              a_t)
        _, sym = huffman.split_sign(mant, a_t)
        sym = torch.clamp(sym, max=n_sym - 1)
        cold = sym >= 4096
        pad = (-half) % 32
        steps = torch.nn.functional.pad(cold, (0, pad)).reshape(
            *cold.shape[:-1], 32, -1).any(-2)
        out[a] = dict(cold_lines=float(cold.float().mean()),
                      past_last_coded=float((sym > last).float().mean()),
                      cold_warp_steps=float(steps.float().mean()))
    return dict(last_coded_symbol=last, by_allocation=out)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--csrc", default=os.path.join(ROOT, "pactpu_torch",
                                                   "csrc"))
    ap.add_argument("--blocks", type=int, default=512)
    ap.add_argument("--runs", type=int, default=5)
    ap.add_argument("--sass", metavar="OUT_DIR")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("k10_phase_clock: needs a CUDA device", file=sys.stderr)
        return 2
    import chip_smoke
    from pactpu_torch import CodecConfig
    from pactpu_torch.codec import engine as E
    from pactpu_torch.ops import kernels as K

    K.build()
    shipped = K._load()
    print(json.dumps({"build": K.LIB_PATH, "ptxas": shipped_ptxas(K)}))
    lib_path, form = build(K, os.path.abspath(args.csrc),
                           os.path.join(K.BUILD_DIR, "k10_clock"))
    # the earlier K10 reads the table set unpacked: its copy is launched
    # through kernel_ab.cost_table_unpacked, the later ones by the wrapper
    from kernel_ab import cost_table_unpacked
    clocked = (ctypes.CDLL(lib_path) if form == "one-warp-items" else K.bind(
        lib_path, [K._C_FUNCS["cost_table"][0],
                   K._C_FUNCS_F64["cost_table"][0]]))
    clocked.pactpu_k10_clock_read.argtypes = [ctypes.c_void_p, ctypes.c_int]
    clocked.pactpu_k10_clock_read.restype = ctypes.c_int
    if args.sass:
        os.makedirs(args.sass, exist_ok=True)
        sass(K, K.LIB_PATH, os.path.join(args.sass, "shipped.sass"))
        sass(K, lib_path, os.path.join(args.sass, "clocked.sass"))

    def read(reset: bool) -> list:
        buf = (ctypes.c_ulonglong * SLOTS)()
        torch.cuda.synchronize()
        rc = clocked.pactpu_k10_clock_read(ctypes.addressof(buf), int(reset))
        if rc != 0:
            raise RuntimeError(f"k10_phase_clock: clock read failed ({rc})")
        return list(buf)

    cfg = CodecConfig()
    pcm = chip_smoke.synth(60.0, 4)
    n = len(PHASES)
    try:
        for prec in ("f32", "f64"):
            tables = E.device_tables(cfg, "cuda", prec)
            a10 = chip_smoke.k10_args(torch, cfg, tables, pcm, args.blocks)
            packed = K.pack_tables(a10[2], a10[3])   # once, as exact does
            want = K.cost_table_plain(*a10)

            def run_shipped():
                K._lib = shipped
                return K.cost_table(*a10, packed)

            def run_clocked():
                if form == "one-warp-items":
                    return cost_table_unpacked(torch, K, clocked, a10)
                K._lib = clocked
                return K.cost_table(*a10, packed)

            times = {}
            for name, run in (("shipped", run_shipped),
                              ("clocked", run_clocked),
                              ("clocked", run_clocked),
                              ("shipped", run_shipped)):
                got = run()
                torch.cuda.synchronize()
                if not torch.equal(got, want):
                    raise chip_smoke.SmokeError(
                        f"k10_phase_clock: the {name} K10 ({prec}) differs "
                        "from its plain version")
                times.setdefault(name, []).append(chip_smoke.device_ms(
                    torch, run))
            read(reset=True)
            for _ in range(args.runs):
                run_clocked()
            c = read(reset=False)
            K._lib = shipped
            items = a10[0].shape[0] * a10[0].shape[1] * args.runs
            phase = {p: c[i] / items for i, p in enumerate(PHASES)}
            lines = {a: c[n + a] / items for a in range(1, N_ALLOC_SLOTS)}
            per_warp_line = {
                a: c[n + a] / (c[n + N_ALLOC_SLOTS + a] * 32)
                for a in range(1, N_ALLOC_SLOTS) if c[n + N_ALLOC_SLOTS + a]}
            total = sum(phase.values()) + sum(lines.values())
            mhz = chip_smoke.sm_clock_mhz()
            print(json.dumps({
                "precision": prec, "form": form, "blocks": args.blocks,
                "runs": args.runs,
                "units_per_item": c[-2] / items,
                "clocks_per_item": {**phase, "lines": sum(lines.values())},
                "share": {**{p: v / total for p, v in phase.items()},
                          "lines": sum(lines.values()) / total},
                "lines_clocks_per_item_by_allocation": lines,
                "lines_clocks_per_warp_line_by_allocation": per_warp_line,
                "clocks_start_to_end_per_item": c[-1] / items,
                "clocks_phase_sum_per_item": total,
                "sm_clock_mhz": mhz, "device_ms": times}))
            print(json.dumps({"precision": prec,
                              "symbols": symbol_shares(torch, a10)}))
    finally:
        K._lib = shipped
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
