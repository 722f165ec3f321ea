#!/usr/bin/env python3
"""Host time of the native Huffman parse and code repack by the number of
ranges (host threads) they run, on this machine's CPUs.

    python3 tools/native_ranges.py [--sizes 32,256,1024,2048,4096,36000]
                                   [--reps 7]

The payload is the committed 1 s stereo stream of tests/data
(torch_port_fixture.npz, the default configuration) repeated, cut to each
size in channel-blocks.  For each size and each range count (1, 2, 4, ...
up to the CPUs this process may use, and that count itself) it times
pactpu_torch.native.unpack_file and repack_codes (the median of --reps
calls, each on fresh output arrays as the decode allocates them) and
prints one JSON line: microseconds a channel-block of each, their sum,
and the speed-up of the sum over one range.  A first line names the host:
the CPUs by affinity and in all, the cgroup's CPU quota where it can be
read, and the range count the binding's rule (MIN_RANGE) picks at each
size.  Needs no card.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--sizes", default="32,256,1024,2048,4096,36000")
    ap.add_argument("--reps", type=int, default=7)
    args = ap.parse_args()

    from pactpu_torch import native
    from pactpu_torch.codec.header import read_header

    stream = np.load(os.path.join(ROOT, "tests", "data",
                                  "torch_port_fixture.npz"))["stream"]
    cfg, _, off = read_header(stream.tobytes())
    one = stream.tobytes()[off:]
    n_lines = np.asarray(cfg.band_layout.n_lines, np.int32)
    fields = (n_lines, cfg.n_scale_bits, cfg.n_mant_size_bits,
              cfg.n_table_id_bits)
    sizes = [int(s) for s in args.sizes.split(",")]
    per = native.unpack_file(one, *fields)["n_cblocks"]
    payload = one * -(-max(sizes) // per)
    starts, pos = [], 0
    while pos < len(payload):
        starts.append(pos)
        pos += 4 + int.from_bytes(payload[pos:pos + 4], "little")
    starts.append(pos)

    cpus = len(os.sched_getaffinity(0))
    quota = None
    try:
        with open("/sys/fs/cgroup/cpu.max") as f:
            quota = f.read().strip()
    except OSError:
        pass
    print(json.dumps({"host": {
        "cpus_affinity": cpus, "cpu_count": os.cpu_count(),
        "cgroup_cpu_max": quota, "min_range": native.MIN_RANGE,
        "rule": {n: native._n_ranges(n, n, None) for n in sizes}}}))
    counts = sorted({1 << k for k in range(cpus.bit_length())} | {cpus})
    for n in sizes:
        data = payload[:starts[n]]
        base = None
        for k in counts:
            parse, repack = [], []
            for _ in range(args.reps):
                t0 = time.perf_counter()
                p = native.unpack_file(data, *fields, _ranges=k)
                t1 = time.perf_counter()
                native.repack_codes(p["mant"], p["ba"], n_lines, 128,
                                    _ranges=k)
                t2 = time.perf_counter()
                parse.append(t1 - t0)
                repack.append(t2 - t1)
            us = [statistics.median(x) / n * 1e6 for x in (parse, repack)]
            base = base or sum(us)
            print(json.dumps({"cblocks": n, "ranges": k,
                              "parse_us": round(us[0], 3),
                              "repack_us": round(us[1], 3),
                              "sum_us": round(sum(us), 3),
                              "speedup": round(base / sum(us), 3)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
