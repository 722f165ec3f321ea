#!/usr/bin/env python3
"""Where K7 (exact_scan) spends its clocks inside a fill, on one CUDA GPU.

    python3 tools/k7_phase_clock.py [--csrc DIR] [--blocks 512] [--runs 5]
                                    [--sass OUT_DIR]

Copies DIR/exact_scan.cu (this checkout's pactpu_torch/csrc by default),
inserts clock64() stamps between the phases of its chain, builds the copy
with the package's nvcc flags into pactpu_torch/_build/k7_clock/ and runs
it through kernels.exact_scan (the wrapper, with the copy's library bound
in place of the package's) on chip_smoke.py's phase-1 chunk: the first
`--blocks` blocks of its 60 s file, in float32 and in float64, each held
bit for bit to kernels.exact_scan_plain first.  The shipped kernel has no
switch for this: the stamps live only in the copy.

The phases (summed over the chain's fills on its one warp, then divided
by the fills):

- "fill": the greedy water-fill of one channel (water_fill_step.cuh's
  step; in the two-warp K7 also its jumps, whose clocks and count are
  printed apart as well), up to its leftover;
- one-warp K7 (the first design): "gather", the allocation's raw and
  sign bits and the loads of its cost rows up to the first use of every
  loaded value; "reduce", the tables' sums, their minimum and the
  savings;
- two-warp K7: "account", the last channel's gather, sums, minimum and
  savings; "wait", for warp 1's savings of channel 0;
- "other": the rest of the chain (the block's withdrawal, the total,
  the next block's loads, the hand-over to warp 1, the carry).

A stamp reads the clock after the phase's last result was used, so the
split is as good as the instruction order around the stamps (the stamps
add a few clocks each).  Also printed: the kernel's clocks from start to
end against the phases' sum, the greedy steps of the chain (the plain
version without the jumps) and the steps the kernel walks one at a time,
clocks and ns a walked step (the jumps' clocks taken out) and a greedy
step, the SM clock, and the time alone of the copy and of the shipped
kernel.
With --sass, the SASS of the shipped library's K7 and K2 and of the copy
goes to OUT_DIR.

The anchors below name the statements of a K7 source between which the
stamps go; a source without them is refused.  Needs a CUDA device;
imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

HEADER = r"""
// ---- k7_phase_clock: stamps (not part of the shipped kernel) ----
#define K7_PHASES 4
__device__ long long k7_clock_out[K7_PHASES + 3];
// the jumps inside the fills (two-warp K7): clocks and count, lane 0's;
// and the passes of the fills' step loop
__device__ unsigned long long k7_jump_out[3];
#define K7_PASS                                                  \
  if ((threadIdx.x & 31) == 0) atomicAdd(k7_jump_out + 2, 1ull);
#define K7_JUMP_START const long long k7j0 = clock64();
#define K7_JUMP_END                                              \
  if ((threadIdx.x & 31) == 0) {                                 \
    atomicAdd(k7_jump_out, (unsigned long long)(clock64() - k7j0)); \
    atomicAdd(k7_jump_out + 1, 1ull);                            \
  }
extern "C" int pactpu_k7_jump_read(unsigned long long* host, int reset) {
  cudaError_t e = cudaMemcpyFromSymbol(host, k7_jump_out, sizeof(k7_jump_out));
  if (e == cudaSuccess && reset) {
    unsigned long long zero[3] = {};
    e = cudaMemcpyToSymbol(k7_jump_out, zero, sizeof(zero));
  }
  return static_cast<int>(e);
}
#define K7_MARK(i)                                     \
  {                                                    \
    const long long k7_now = clock64();                \
    k7c[i] += k7_now - k7_last;                        \
    k7_last = k7_now;                                  \
  }
__device__ __forceinline__ void k7_store(const long long (&c)[K7_PHASES],
                                         long long total, int fills,
                                         unsigned sink) {
  for (int i = 0; i < K7_PHASES; ++i) k7_clock_out[i] += c[i];
  k7_clock_out[K7_PHASES] += total;
  k7_clock_out[K7_PHASES + 1] += fills;
  k7_clock_out[K7_PHASES + 2] ^= sink;
}
extern "C" int pactpu_k7_clock_read(long long* host, int reset) {
  cudaError_t e = cudaMemcpyFromSymbol(host, k7_clock_out,
                                       sizeof(long long) * (K7_PHASES + 3));
  if (e == cudaSuccess && reset) {
    long long zero[K7_PHASES + 3] = {};
    e = cudaMemcpyToSymbol(k7_clock_out, zero, sizeof(zero));
  }
  return static_cast<int>(e);
}
"""

START = r"""
  long long k7c[K7_PHASES] = {};
  long long k7_last = clock64();
  const long long k7_start = k7_last;
  unsigned k7sink = 0;
  int k7fills = 0;
"""

# (anchor, text, "before" | "after"), each anchor found exactly once, and
# the names of the four phases, by the K7 source they instrument
ANCHORS = {
    # one warp walks the chain, the gather and the sums after each fill
    "one-warp": [
        ('#include "water_fill_step.cuh"\n', HEADER, "after"),
        ("  const int lane = threadIdx.x;\n", START, "after"),
        ("      const int left = wf::fill_row<T, S, kWide>(",
         "      K7_MARK(3);\n", "before"),
        ("          s, ms, nl, n_bands, total, max_mant, ms_stop, lr_stop, "
         "bits);\n",
         "      k7sink ^= left;\n      ++k7fills;\n      K7_MARK(0);\n",
         "after"),
        ("      int best = 0x7fffffff;\n",
         "      for (int tb = 0; tb < kMaxTables; ++tb) k7sink ^= part[tb];\n"
         "      k7sink ^= raw ^ signs;\n      K7_MARK(1);\n", "before"),
        ("      savings += raw - (best + signs + tid_bits);\n",
         "      k7sink ^= savings;\n      K7_MARK(2);\n", "after"),
        ("  for (int t = max(n_valid, 0) + lane; t < blocks; t += 32) "
         "extras[t] = 0;\n",
         "  K7_MARK(3);\n  if (lane == 0)\n    k7_store(k7c, clock64() - "
         "k7_start, k7fills, k7sink);\n", "before"),
    ],
    # warp 0 walks the chain, warp 1 takes channel 0's accounting
    "two-warp": [
        ('#include "water_fill_step.cuh"\n', HEADER, "after"),
        ("  const T budget_t = static_cast<T>(budget);\n", START, "after"),
        ("    int chain = fill_row_jump<T, S, kWide>(s0,",
         "    K7_MARK(3);\n", "before"),
        ("    int savings;\n",
         "    k7sink ^= chain;\n    ++k7fills;\n    K7_MARK(0);\n", "before"),
        ("      total = static_cast<int>(wf::add_rn(budget_t, "
         "static_cast<T>(chain)));\n", "      K7_MARK(3);\n", "before"),
        ("      wait(t);\n      const int s1_sav",
         "      k7sink ^= chain;\n      ++k7fills;\n      K7_MARK(0);\n",
         "before"),
        ("                                              nl, n_bands, n_tab, "
         "tid_bits);\n",
         "      k7sink ^= s1_sav;\n      K7_MARK(1);\n", "after"),
        ("      savings = s1_sav + sav0_s;\n",
         "      K7_MARK(2);\n", "before"),
        ("      bar_sync(kBarSavings);           // warp 1 has staged block "
         "t + 2\n", "      k7sink ^= savings;\n      K7_MARK(1);\n",
         "before"),
        ("  for (int t = n_valid + lane; t < blocks; t += 32) "
         "extras[t] = 0;\n",
         "  K7_MARK(3);\n  if (lane == 0)\n    k7_store(k7c, clock64() - "
         "k7_start, k7fills, k7sink);\n", "before"),
        ("    jump<T, S, kWide>(s, real, nl, ms, n_bands, max_mant, ms_stop, "
         "lr_stop,\n                      ms_q0, lr_q0, bits, retired, "
         "total);\n", "    { K7_JUMP_START\n", "before"),
        ("    jump<T, S, kWide>(s, real, nl, ms, n_bands, max_mant, ms_stop, "
         "lr_stop,\n                      ms_q0, lr_q0, bits, retired, "
         "total);\n", "    K7_JUMP_END }\n", "after"),
        ("      jump<T, S, kWide>(s, real, nl, ms, n_bands, max_mant, "
         "ms_stop,\n                        lr_stop, ms_q0, lr_q0, bits, "
         "retired, total);\n", "      { K7_JUMP_START\n", "before"),
        ("      jump<T, S, kWide>(s, real, nl, ms, n_bands, max_mant, "
         "ms_stop,\n                        lr_stop, ms_q0, lr_q0, bits, "
         "retired, total);\n", "      K7_JUMP_END }\n", "after"),
        ("  for (int it = 0; it < max_iters; ++it) {\n    Key kb = key[0];\n",
         "    K7_PASS\n", "after"),
    ],
}
PHASES = {"one-warp": ("fill", "gather", "reduce", "other"),
          "two-warp": ("fill", "account", "wait", "other")}


def instrument(src: str) -> tuple:
    """The source with the stamps of the first form whose anchors it all
    holds: (form, text)."""
    for form, anchors in ANCHORS.items():
        if all(src.count(a) == 1 for a, _, _ in anchors):
            for anchor, text, where in anchors:
                src = src.replace(anchor, text + anchor if where == "before"
                                  else anchor + text)
            return form, src
    raise SystemExit("k7_phase_clock: the K7 source holds none of the known "
                     "anchor sets (" + ", ".join(ANCHORS) + ")")


def build(K, csrc: str, out_dir: str) -> str:
    with open(os.path.join(csrc, "exact_scan.cu")) as f:
        form, text = instrument(f.read())
    os.makedirs(out_dir, exist_ok=True)
    src = os.path.join(out_dir, "exact_scan_clock.cu")
    with open(src, "w") as f:
        f.write(text)
    lib = os.path.join(out_dir, "libk7_clock.so")
    cmd = [K._nvcc(), *K.NVCC_FLAGS, "-I", csrc, "-shared", "-o", lib, src]
    res = subprocess.run(cmd, capture_output=True, text=True)
    ptxas = [ln.strip() for ln in (res.stdout + res.stderr).splitlines()
             if "registers" in ln or "spill" in ln]
    if res.returncode != 0:
        raise SystemExit("k7_phase_clock: nvcc failed:\n" + res.stdout
                         + res.stderr)
    print(json.dumps({"build": lib, "form": form, "ptxas": ptxas}))
    return lib, form


def sass(lib: str, path: str) -> None:
    cuobjdump = os.path.join(os.path.dirname(
        __import__("pactpu_torch.ops.kernels", fromlist=["_nvcc"])._nvcc()),
        "cuobjdump")
    res = subprocess.run([cuobjdump, "-sass", lib], capture_output=True,
                         text=True, check=True)
    with open(path, "w") as f:
        f.write(res.stdout)


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
        print("k7_phase_clock: needs a CUDA device", file=sys.stderr)
        return 2
    import chip_smoke
    from pactpu_torch import CodecConfig
    from pactpu_torch.codec import engine as E
    from pactpu_torch.ops import kernels as K

    K.build()
    shipped = K._load()
    lib_path, form = build(K, os.path.abspath(args.csrc),
                           os.path.join(K.BUILD_DIR, "k7_clock"))
    names = PHASES[form]
    clocked = K.bind(lib_path, [K._C_FUNCS["exact_scan"][0],
                                K._C_FUNCS_F64["exact_scan"][0]])
    clocked.pactpu_k7_clock_read.argtypes = [ctypes.c_void_p, ctypes.c_int]
    clocked.pactpu_k7_clock_read.restype = ctypes.c_int
    jumps = hasattr(clocked, "pactpu_k7_jump_read")
    if jumps:
        clocked.pactpu_k7_jump_read.argtypes = [ctypes.c_void_p, ctypes.c_int]
        clocked.pactpu_k7_jump_read.restype = ctypes.c_int
    if args.sass:
        os.makedirs(args.sass, exist_ok=True)
        sass(K.LIB_PATH, os.path.join(args.sass, "shipped.sass"))
        sass(lib_path, os.path.join(args.sass, "clocked.sass"))

    def read(reset: bool):
        buf = (ctypes.c_longlong * (len(names) + 3))()
        jbuf = (ctypes.c_ulonglong * 3)()
        torch.cuda.synchronize()
        rc = clocked.pactpu_k7_clock_read(ctypes.addressof(buf), int(reset))
        if rc == 0 and jumps:
            rc = clocked.pactpu_k7_jump_read(ctypes.addressof(jbuf),
                                             int(reset))
        if rc != 0:
            raise RuntimeError(f"k7_phase_clock: clock read failed ({rc})")
        return list(buf) + list(jbuf)

    cfg = CodecConfig()
    pcm = chip_smoke.synth(60.0, 4)
    try:
        for prec in ("f32", "f64"):
            tables = E.device_tables(cfg, "cuda", prec)
            a7 = chip_smoke.k7_args(torch, cfg, tables, pcm, args.blocks)
            stats = dict(steps=0, fills=0)          # walked by the kernel
            greedy = dict(steps=0, fills=0)         # the steps alone
            want = K.exact_scan_plain(*a7, stats=stats)
            K.exact_scan_plain(*a7, stats=greedy, jump=False)
            times = {}
            for name, lib in (("shipped", shipped), ("clocked", clocked),
                              ("clocked", clocked), ("shipped", shipped)):
                K._lib = lib
                got = K.exact_scan(*a7)
                torch.cuda.synchronize()
                if not all(torch.equal(x, y) for x, y in zip(got, want)):
                    raise chip_smoke.SmokeError(
                        f"k7_phase_clock: the {name} K7 ({prec}) differs "
                        "from its plain version")
                times.setdefault(name, []).append(chip_smoke.device_ms(
                    torch, lambda: K.exact_scan(*a7)))
            K._lib = clocked
            read(reset=True)
            for _ in range(args.runs):
                K.exact_scan(*a7)
            c = read(reset=False)
            K._lib = shipped       # the next analysis runs the other kernels
            fills = c[len(names) + 1]
            total = c[len(names)]
            # the one-warp K7 walks every greedy step
            walked = (greedy["steps"] if form == "one-warp"
                      else stats["steps"])
            per_fill = {p: c[i] / fills for i, p in enumerate(names)}
            mhz = chip_smoke.sm_clock_mhz()
            print(json.dumps({
                "precision": prec, "blocks": args.blocks, "runs": args.runs,
                "fills": fills // args.runs, "walked_steps": walked,
                "clocks_per_fill": per_fill,
                "clocks_total_per_fill": total / fills,
                "clocks_phase_sum_per_fill": sum(per_fill.values()),
                "greedy_steps": greedy["steps"],
                "jumps_per_fill": c[-2] / fills,
                "clocks_of_jumps_per_fill": c[-3] / fills,
                "loop_passes_per_fill": c[-1] / fills,
                "clocks_per_walked_step": (c[0] - c[-3])
                / (walked * args.runs),
                "ns_per_walked_step": (c[0] - c[-3])
                / (walked * args.runs) / mhz * 1e3,
                "ns_per_greedy_step_in_fill": c[0]
                / (greedy["steps"] * args.runs) / mhz * 1e3,
                "sm_clock_mhz": mhz,
                "device_ms": times}))
    finally:
        K._lib = shipped
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
