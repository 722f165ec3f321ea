#!/usr/bin/env python3
"""Host time of the decode's native parse and repack, the word-wide loops
of pactpu_torch/csrc/wakbits_ranges.cc beside csrc/wakbits.cc's serial
loop, in microseconds a channel-block, on this machine's CPU.

    python3 tools/parse_bench.py [--seconds 20] [--seed 1] [--reps 7]
                                 [--bps 2.27,4.93] [--ranges 1,N]

For each bit rate it encodes --seconds of seeded synthetic stereo music
(chip_smoke.synth) on the CPU with the port's Engine (reservoir, float32)
and times, best of --reps calls on output arrays made once:

- "serial": wakbits.cc's wak_unpack_file and wak_repack_codes (one
  thread), as the library exports them;
- "words": wak_unpack_file_ranges and wak_repack_codes_ranges at each
  --ranges count (N: the CPUs this process may use);
- "binding": pactpu_torch.native.unpack_file and repack_codes as the
  decode calls them (fresh output arrays, the binding's own range count).

It prints one JSON line a bit rate and loop: parse_us and repack_us a
channel-block, their sum, and, for the word loops, the speed-up of the
sum over the serial loop and whether every output equals the serial
loop's.  A first line names the host: the CPU model, the CPUs by
affinity, and the payload's bytes and coded lines a channel-block and
deep-code and escape shares at each rate.  Needs no card.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

I32 = ctypes.POINTER(ctypes.c_int32)
I64 = ctypes.POINTER(ctypes.c_int64)
U8 = ctypes.POINTER(ctypes.c_uint8)
U32 = ctypes.POINTER(ctypes.c_uint32)


def _cpu_model() -> str:
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith("model name"):
                    return line.split(":", 1)[1].strip()
    except OSError:
        pass
    return "unknown"


def _lib():
    """The port's library, with the serial entries' prototypes on a
    handle of its own."""
    from pactpu_torch import native
    h = ctypes.CDLL(native._load()._name)
    parse = ([U8, ctypes.c_int64] + [ctypes.c_int] * 2 + [I32]
             + [ctypes.c_int] * 6 + [I32] * 6)
    repack = [ctypes.c_int] * 2 + [I32, ctypes.c_int] + [I32] * 2 + [
        U32, ctypes.c_int]
    for name, args in (("wak_unpack_file", parse),
                       ("wak_unpack_file_ranges", parse + [ctypes.c_int,
                                                            I64]),
                       ("wak_repack_codes", repack),
                       ("wak_repack_codes_ranges", repack + [ctypes.c_int])):
        fn = getattr(h, name)
        fn.restype = ctypes.c_int64
        fn.argtypes = args
    return h


def _best(fn, reps: int, before=None) -> float:
    best = float("inf")
    for _ in range(reps):
        if before is not None:
            before()
        t0 = time.perf_counter()
        fn()
        best = min(best, time.perf_counter() - t0)
    return best


def bench(bps: float, args, lib, out: list) -> dict:
    """Time one bit rate's stream; appends its JSON lines to out and
    returns its line of the host record."""
    from chip_smoke import synth
    from pactpu_torch import native
    from pactpu_torch.codec import engine as te
    from pactpu_torch.codec.header import read_header
    from pactpu_torch.utils.config import CodecConfig

    eng = te.Engine(CodecConfig(target_bits_per_sample=bps), "reservoir",
                    device="cpu")
    stream = eng.encode(synth(args.seconds, args.seed))
    cfg, _, off = read_header(stream)
    payload = stream[off:]
    native.init_tables()
    n_lines = np.asarray(cfg.band_layout.n_lines, np.int32)
    nb, total, c = len(n_lines), int(n_lines.sum()), cfg.n_channels
    fields = (n_lines, cfg.n_scale_bits, cfg.n_mant_size_bits,
              cfg.n_table_id_bits)
    data = np.frombuffer(payload, np.uint8)
    r = int(native._load().wak_count_blocks(data.ctypes.data_as(U8),
                                            len(data)))

    def outputs():
        return [np.zeros(r, np.int32), np.zeros(r, np.int32),
                np.zeros((r, nb), np.int32), np.zeros((r, nb), np.int32),
                np.zeros((r, total), np.int32),
                np.zeros((-(-r // c), nb), np.int32)]

    def parse_args(outs):
        return (data.ctypes.data_as(U8), len(data), r, nb,
                n_lines.ctypes.data_as(I32), total, cfg.n_scale_bits,
                cfg.n_mant_size_bits, cfg.n_table_id_bits, 1, c,
                *(a.ctypes.data_as(I32) for a in outs))

    gold = outputs()
    assert lib.wak_unpack_file(*parse_args(gold)) == len(data)
    ba, mant = gold[2], gold[4]
    rowbits = ba.astype(np.int64) @ n_lines.astype(np.int64)
    n_words = -(-int(rowbits.max()) // 32)
    gold_words = np.zeros((r, n_words), np.uint32)
    words = np.zeros_like(gold_words)

    def repack_args(w):
        return (r, nb, n_lines.ctypes.data_as(I32), total,
                ba.ctypes.data_as(I32), mant.ctypes.data_as(I32),
                w.ctypes.data_as(U32), n_words)

    lib.wak_repack_codes(*repack_args(gold_words))

    def line(loop, ranges, parse_s, repack_s, equal=None):
        us = [parse_s / r * 1e6, repack_s / r * 1e6]
        rec = {"bps": bps, "loop": loop, "ranges": ranges,
               "parse_us": round(us[0], 3), "repack_us": round(us[1], 3),
               "sum_us": round(sum(us), 3)}
        if equal is not None:
            rec["equal"] = equal
        out.append(rec)
        return rec

    outs = outputs()
    serial = line(
        "serial", 1, _best(lambda: lib.wak_unpack_file(*parse_args(outs)),
                           args.reps),
        _best(lambda: lib.wak_repack_codes(*repack_args(words)), args.reps,
              lambda: words.fill(0)))
    counts = np.zeros(3, np.int64)
    for k in args.ranges:
        outs = outputs()
        t_parse = _best(lambda: lib.wak_unpack_file_ranges(
            *parse_args(outs), k, counts.ctypes.data_as(I64)), args.reps)
        t_repack = _best(lambda: lib.wak_repack_codes_ranges(
            *repack_args(words), k), args.reps, lambda: words.fill(0))
        equal = (all(np.array_equal(a, b) for a, b in zip(outs, gold))
                 and np.array_equal(words, gold_words)
                 and counts[0] == 1)
        rec = line("words", k, t_parse, t_repack, bool(equal))
        rec["speedup"] = round(serial["sum_us"] / rec["sum_us"], 3)

    def binding():
        p = native.unpack_file(payload, *fields, n_channels=c)
        native.repack_codes(p["mant"], p["ba"], n_lines, n_words)

    t_parse = _best(lambda: native.unpack_file(payload, *fields,
                                               n_channels=c), args.reps)
    t_all = _best(binding, args.reps)
    line("binding", native._n_ranges(r, -(-r // c), None), t_parse,
         t_all - t_parse)
    coded = int(((ba > 0).astype(np.int64) @ n_lines.astype(np.int64)).sum())
    return {"bps": bps, "cblocks": r,
            "bytes_per_cblock": round((len(data) - 4 * r) / r, 1),
            "coded_lines_per_cblock": round(coded / r, 1),
            "deep_pct": round(100 * counts[1] / max(coded, 1), 3),
            "escape_pct": round(100 * counts[2] / max(coded, 1), 3)}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seconds", type=float, default=20.0)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--reps", type=int, default=7)
    ap.add_argument("--bps", default="2.27,4.93")
    ap.add_argument("--ranges", default=None,
                    help="range counts of the word loops (default 1,N)")
    args = ap.parse_args()
    cpus = len(os.sched_getaffinity(0))
    args.ranges = ([int(k) for k in args.ranges.split(",")] if args.ranges
                   else sorted({1, cpus}))

    import torch
    torch.set_num_threads(min(4, cpus))
    lib = _lib()
    lines, streams = [], []
    for bps in (float(b) for b in args.bps.split(",")):
        streams.append(bench(bps, args, lib, lines))
    print(json.dumps({"host": {"cpu": _cpu_model(), "cpus_affinity": cpus,
                               "cpu_count": os.cpu_count(),
                               "seconds": args.seconds, "seed": args.seed,
                               "streams": streams}}))
    for rec in lines:
        print(json.dumps(rec))
    return 0


if __name__ == "__main__":
    sys.exit(main())
