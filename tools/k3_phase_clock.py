#!/usr/bin/env python3
"""Where K3's payload pack (pack_payload_kernel) spends its time, on one
CUDA GPU.

    python3 tools/k3_phase_clock.py [--csrc DIR] [--runs 5] [--words 256]
                                    [--rows N]

Copies DIR/pack_words.cu (this checkout's pactpu_torch/csrc by default)
with kernels.h, inserts stamps into pack_payload_kernel (thread 0 of each
CTA reads clock64() and %globaltimer at the kernel's start, after each
statement of the kernel's body that holds a barrier and after its last
store, and the CTA's SM), builds the
copy with the package's nvcc flags into pactpu_torch/_build/k3_clock/ and
runs it through kernels.pack_payload (the wrapper, with the copy's library
bound in place of the package's) on chip_smoke.py's phase-1 chunk: the
payload fields of the first 512 blocks of its 60 s file (1,024 rows, or
the first N: 132 puts one CTA on each SM), held bit for bit to
bitpack.pack_payload_bits_plain first.  The shipped
kernel has no switch for this: the stamps live only in the copy.

Printed, from the last of `--runs` launches: each phase's clocks a CTA
(the span between two stamps of thread 0; a phase ending at a barrier
holds the CTA's slowest warp), as the mean, median and largest over the
CTAs; the launch's span on %globaltimer (the first CTA's start to the last
CTA's end) and the CTAs' start and end offsets from the first start
(quantiles); the CTAs an SM; the copy's time alone beside the shipped
kernel's (chip_smoke.device_ms, in turns) and the SM clock.  The anchors
below name the statements the stamps follow; a source without them is
refused.  Needs a CUDA device; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

MAX_ROWS = 4096
HEADER = r"""
// ---- k3_phase_clock: stamps (not part of the shipped kernel) ----
#define K3_STAMPS 8
__device__ unsigned long long k3_clock_out[MAX_ROWS * K3_STAMPS * 2 + MAX_ROWS];
#define K3_STAMP(k)                                                        \
  if (threadIdx.x == 0 && blockIdx.x < MAX_ROWS) {                         \
    unsigned long long k3_g;                                               \
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(k3_g));               \
    const size_t k3_i = (static_cast<size_t>(blockIdx.x) * K3_STAMPS + (k)) \
                        * 2;                                               \
    k3_clock_out[k3_i] = clock64();                                        \
    k3_clock_out[k3_i + 1] = k3_g;                                         \
  }
extern "C" int pactpu_k3_clock_read(unsigned long long* host) {
  return static_cast<int>(cudaMemcpyFromSymbol(host, k3_clock_out,
                                               sizeof(k3_clock_out)));
}
""".replace("MAX_ROWS", str(MAX_ROWS))
START_ANCHOR = "  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;\n"
END_ANCHOR = "  if (t == 0) nbits[row] = total;\n"
SM = r"""
  if (threadIdx.x == 0 && blockIdx.x < MAX_ROWS) {
    unsigned k3_sm;
    asm volatile("mov.u32 %0, %%smid;" : "=r"(k3_sm));
    k3_clock_out[MAX_ROWS * K3_STAMPS * 2 + blockIdx.x] = k3_sm;
  }
""".replace("MAX_ROWS", str(MAX_ROWS))


def instrument(src: str) -> tuple:
    """The source with stamps in pack_payload_kernel, and the phases' names
    (the spans between consecutive stamps)."""
    head = src.index("pack_payload_kernel(")
    body = src.index(START_ANCHOR, head)
    end = src.index(END_ANCHOR, body) + len(END_ANCHOR)
    if "__global__" in src[body:end]:
        raise SystemExit("k3_phase_clock: anchors outside one kernel")
    seg = src[body + len(START_ANCHOR):end]
    out, k = [], 1
    for line in seg.splitlines(keepends=True):
        out.append(line)
        if line.startswith("  ") and not line.startswith("   ") \
                and "__syncthreads" in line:
            out.append(f"  K3_STAMP({k})\n")
            k += 1
    stamped = (src[:body] + START_ANCHOR + "  K3_STAMP(0)\n" + SM
               + "".join(out) + f"  K3_STAMP({k})\n" + src[end:])
    if k + 1 > 8:
        raise SystemExit("k3_phase_clock: more stamps than slots")
    include = stamped.index('#include "kernels.h"\n') + len(
        '#include "kernels.h"\n')
    stamped = stamped[:include] + HEADER + stamped[include:]
    names = [f"to-barrier-{i}" for i in range(1, k)] + ["after-last-barrier"]
    return stamped, names, k + 1


def quantiles(values, qs=(0.0, 0.1, 0.5, 0.9, 1.0)) -> dict:
    import numpy as np
    v = np.asarray(values, np.float64)
    return {f"q{int(q * 100)}": float(np.quantile(v, q)) for q in qs}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--csrc", default=os.path.join(ROOT, "pactpu_torch",
                                                   "csrc"))
    ap.add_argument("--runs", type=int, default=5)
    ap.add_argument("--words", type=int, default=256)
    ap.add_argument("--rows", type=int, default=None)
    args = ap.parse_args()
    import ctypes

    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("k3_phase_clock: needs a CUDA device", file=sys.stderr)
        return 2
    import chip_smoke
    from pactpu_torch import Engine
    from pactpu_torch.codec.engine import device_tables
    from pactpu_torch.ops import bitpack
    from pactpu_torch.ops import kernels as K

    out_dir = os.path.join(K.BUILD_DIR, "k3_clock")
    src_dir = os.path.join(out_dir, "src")
    os.makedirs(src_dir, exist_ok=True)
    with open(os.path.join(args.csrc, "pack_words.cu")) as f:
        stamped, names, n_stamps = instrument(f.read())
    with open(os.path.join(src_dir, "pack_words.cu"), "w") as f:
        f.write(stamped)
    shutil.copy(os.path.join(args.csrc, "kernels.h"), src_dir)
    lib_path = os.path.join(out_dir, "libk3_clock.so")
    log_path = os.path.join(out_dir, "build.log")
    K.build(src_dir, lib_path, log_path, ("pack_words.cu",))
    with open(log_path) as f:
        log = f.read().splitlines()
    ptxas = [log[i + j] .strip() for i, ln in enumerate(log)
             if "Compiling entry" in ln and "pack_payload" in ln
             for j in (2, 3) if i + j < len(log)]
    K.build()
    shipped = K._load()
    copy = K.bind(lib_path, [K._C_FUNCS["pack_payload"][0]])
    read = getattr(copy, "pactpu_k3_clock_read")
    read.argtypes = [ctypes.c_void_p]
    read.restype = ctypes.c_int

    eng = Engine(device="cuda")
    cfg = eng.cfg
    pcm = chip_smoke.synth(60.0, 4)
    fields = chip_smoke.main_path_inputs(
        torch, device_tables(cfg, "cuda"), pcm, parts=("k3",))["k3"]
    if args.rows:
        fields = tuple(f[:args.rows].contiguous() for f in fields)
    lay = (cfg.band_layout.n_lines, cfg.n_scale_bits, cfg.n_mant_size_bits,
           cfg.n_table_id_bits)
    rows = fields[0].shape[0]
    if rows > MAX_ROWS:
        raise SystemExit(f"k3_phase_clock: at most {MAX_ROWS} rows")
    want = bitpack.pack_payload_bits_plain(*fields, *lay, args.words)
    buf = np.zeros(MAX_ROWS * 8 * 2 + MAX_ROWS, np.uint64)
    try:
        K._lib = copy
        for _ in range(args.runs):
            got = bitpack.pack_payload_bits(*fields, *lay, args.words)
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in zip(got, want)):
            raise chip_smoke.SmokeError("the stamped copy differs from the "
                                        "plain version")
        rc = read(buf.ctypes.data)
        if rc:
            raise RuntimeError(f"reading the stamps: CUDA error {rc}")
        times = {}
        for name, lib in (("shipped", shipped), ("stamped", copy),
                          ("stamped", copy), ("shipped", shipped)):
            K._lib = lib
            times.setdefault(name, []).append(chip_smoke.device_ms(
                torch, lambda: bitpack.pack_payload_bits(*fields, *lay,
                                                         args.words)))
    finally:
        K._lib = shipped
    st = buf[:MAX_ROWS * 16].reshape(MAX_ROWS, 8, 2)[:rows, :n_stamps]
    clk = st[:, :, 0].astype(np.int64)
    ns = st[:, :, 1].astype(np.int64)
    sm = buf[MAX_ROWS * 16:MAX_ROWS * 16 + rows].astype(np.int64)
    d = np.diff(clk, axis=1)
    phases = {name: dict(mean=float(d[:, i].mean()),
                         median=float(np.median(d[:, i])),
                         max=int(d[:, i].max()))
              for i, name in enumerate(names)}
    t0 = int(ns[:, 0].min())
    per_sm = np.bincount(sm, minlength=int(sm.max()) + 1)
    print(json.dumps({"kernel": "pack_payload", "rows": rows,
                      "words": args.words, "ptxas": ptxas,
                      "clocks_per_cta": phases,
                      "cta_clocks": quantiles(clk[:, -1] - clk[:, 0]),
                      "span_ns": int(ns[:, -1].max()) - t0,
                      "start_offset_ns": quantiles(ns[:, 0] - t0),
                      "end_offset_ns": quantiles(ns[:, -1] - t0),
                      "ctas_per_sm": quantiles(per_sm[per_sm > 0]),
                      "sms": int((per_sm > 0).sum()),
                      "device_ms": times,
                      "sm_clock_mhz": chip_smoke.sm_clock_mhz()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
