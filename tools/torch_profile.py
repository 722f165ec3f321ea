#!/usr/bin/env python3
"""Where the time goes on the PyTorch port's main path, on one CUDA GPU.

    python3 tools/torch_profile.py [--seconds 60] [--out DIR]
                                   [--decode-parse host|device]
                                   [--peak-mode ref|para|weighted]

Encodes and decodes one synthetic stereo file (chip_smoke.synth) with
Engine(device="cuda", rate_mode="reservoir") on the chosen decode parse
route and peak-picker mode, and reports, as JSON lines:

- "stages": host-clock seconds of each stage of one serial encode +
  decode, with a device synchronize after each stage (so a stage's own
  device work lands in it);
- "device": a torch.profiler trace of one encode + decode with no added
  synchronization: wall seconds, summed kernel (device) seconds, the
  device's busy and idle shares, the device time of each of the port's own
  kernels, and the device time by kernel name (top 15).  With --out, the
  chrome trace is written there.

Needs a CUDA device; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seconds", type=float, default=60.0)
    ap.add_argument("--out", help="directory for trace.json")
    ap.add_argument("--decode-parse", default="host",
                    choices=("host", "device"))
    ap.add_argument("--peak-mode", default="ref",
                    choices=("ref", "para", "weighted"))
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("torch_profile: needs a CUDA device", file=sys.stderr)
        return 2
    from torch.profiler import ProfilerActivity, profile

    from chip_smoke import n_blocks, synth
    from pactpu_torch import CodecConfig, Engine

    pcm = synth(args.seconds, 4)
    eng = Engine(device="cuda", cfg=CodecConfig(peak_mode=args.peak_mode),
                 rate_mode="reservoir", decode_parse=args.decode_parse)
    eng.decode(eng.encode(pcm))                       # warm
    torch.cuda.synchronize()

    stages = {}

    def stage(name, fn, *a):
        t0 = time.perf_counter()
        out = fn(*a)
        torch.cuda.synchronize()
        stages[name] = round(time.perf_counter() - t0, 6)
        return out

    st = stage("encode/analyze+reservoir+finalize", eng._encode_chunks, pcm)
    payload = stage("encode/download+assemble", eng._finish_encode, st)
    from pactpu_torch.codec.header import write_header
    stream = write_header(eng.cfg, pcm.shape[0])[0] + payload
    staging = ("decode/native-parse+repack" if args.decode_parse == "host"
               else "decode/frame-rows")
    launch = ("decode/upload+synthesis" if args.decode_parse == "host"
              else "decode/upload+walk+synthesis")
    staged = stage(staging, eng._decode_staging, stream)
    d = stage(launch, eng._decode_launch, staged)
    stage("decode/download", eng._decode_finish, *d)
    blocks = n_blocks(pcm)
    print(json.dumps({"decode_parse": args.decode_parse,
                      "peak_mode": args.peak_mode,
                      "stages": stages, "blocks": blocks,
                      "total_s": round(sum(stages.values()), 6)}))

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        eng.decode(eng.encode(pcm))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        prof.export_chrome_trace(os.path.join(args.out, "trace.json"))
    kernels = {}
    for ev in prof.events():
        if ev.device_type.name == "CUDA":           # a kernel or a copy
            kernels[ev.name] = (kernels.get(ev.name, 0.0)
                                + ev.time_range.elapsed_us())
    busy = sum(kernels.values()) / 1e6
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:15]
    # the port's own kernels (pactpu_torch/csrc), whatever their rank
    own = {m.group(1): round(v / 1e3, 3) for k, v in kernels.items()
           if (m := re.match(r"\(anonymous namespace\)::(\w+_kernel)\(", k))}
    print(json.dumps({"decode_parse": args.decode_parse, "device": {
        "wall_s": round(wall, 6), "kernel_s": round(busy, 6),
        "busy_share": round(busy / wall, 4),
        "idle_share": round(1 - busy / wall, 4), "blocks": blocks,
        "own_kernels_ms": own,
        "top_ms": {k[:120]: round(v / 1e3, 3) for k, v in top}}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
