#!/usr/bin/env python3
"""Where the time goes on the PyTorch port's main path, on one CUDA GPU.

    python3 tools/torch_profile.py [--seconds 60] [--out DIR]
                                   [--decode-parse host|device]
                                   [--peak-mode ref|para|weighted]
                                   [--fmt wak|pac] [--channels 1|2]
                                   [--window sine|kbd]
                                   [--rate reservoir|cbr|exact]
                                   [--precision f32|f64]
                                   [--route programs|launches]

Encodes and decodes one synthetic file (chip_smoke.synth; its first
channel for --channels 1) with Engine(device="cuda") in the chosen rate
mode (reservoir by default), precision and stream format, on the chosen
decode parse route, peak-picker mode and window, once to warm up and once
under torch.profiler with no added synchronization, and reports, from
that trace and the program's own spans (pactpu_torch.utils.metrics.span,
recorded while the profiler records), as JSON lines:

- "device": wall seconds, summed kernel (device) seconds, the device's
  busy and idle shares, the device time of each of the port's own
  kernels, the device time by kernel name (top 15), the kernels'
  launches by kernels.LAUNCHES (a program replay adds the launches its
  capture made), the memory reserved, the Engine's graph pools' share of
  it by pool, and the capture seconds.  With --out, the chrome trace is
  written there;
- "spans": host seconds and calls of each program span (the encode's
  upload, analyze, rate, final, download and frame; the decode's parse,
  repack, compact, upload, queue, download and assemble; each stage's
  replay:, capture: or direct: runs), and the sum of each of its counts
  over its calls (blocks, bytes, rows and real rows, chunks, the
  framing's bytes out and its wide and padded fallbacks, the decode's
  dense overflows, samples and the bytes the host copied to lay them
  out (`copied`); a pinned count sums the page-locked copies),
  and the most host threads (ranges) one native parse or repack ran
  (`threads`: 1 means the calling thread alone), and of the parse
  whether it ran the word-wide loop (`lut`, 1, or 0 where it walked the
  trees), its codes that took the LUT's second level (`deep`) and its
  escapes;
- "idle": the device's idle seconds by the innermost program span the
  host was in (a gap split where the host changed span), and "outside"
  for the idle time outside every span;
- "programs": each stage's replays (replay:<stage>) or direct runs
  (direct:<stage>, launch by launch): calls, runtime calls, device
  kernels and copies a call and their device time, and of them K3's
  (the payload pack) kernels and device time.

--route launches runs every stage launch by launch (the Engine's stages
called directly), to set the two routes side by side in one call.

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

# K3's kernel (csrc/pack_words.cu) as the trace names it
PACK_KERNEL = "pack_payload_kernel"
STAGE_SPANS = ("replay:", "direct:", "capture:")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seconds", type=float, default=60.0)
    ap.add_argument("--out", help="directory for trace.json")
    ap.add_argument("--decode-parse", default="host",
                    choices=("host", "device"))
    ap.add_argument("--peak-mode", default="ref",
                    choices=("ref", "para", "weighted"))
    ap.add_argument("--fmt", default="wak", choices=("wak", "pac"))
    ap.add_argument("--channels", type=int, default=2, choices=(1, 2))
    ap.add_argument("--window", default="sine", choices=("sine", "kbd"))
    ap.add_argument("--rate", default="reservoir",
                    choices=("reservoir", "cbr", "exact"))
    ap.add_argument("--precision", default="f32", choices=("f32", "f64"))
    ap.add_argument("--route", default="programs",
                    choices=("programs", "launches"))
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("torch_profile: needs a CUDA device", file=sys.stderr)
        return 2
    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    from chip_smoke import n_blocks, synth
    from pactpu_torch import CodecConfig, Engine
    from pactpu_torch.codec import programs
    from pactpu_torch.ops import kernels as K
    from pactpu_torch.utils import metrics as M

    pcm = np.ascontiguousarray(synth(args.seconds, 4)[:, :args.channels])
    cfg = CodecConfig(peak_mode=args.peak_mode, n_channels=args.channels,
                      window=args.window)
    eng = Engine(device="cuda", cfg=cfg, rate_mode=args.rate,
                 fmt=args.fmt, decode_parse=args.decode_parse,
                 precision=args.precision)
    eng.use_programs = args.route == "programs"
    eng.decode(eng.encode(pcm))                       # warm
    torch.cuda.synchronize()
    blocks = n_blocks(pcm)
    mode = dict(decode_parse=args.decode_parse, peak_mode=args.peak_mode,
                fmt=args.fmt, channels=args.channels, window=args.window,
                rate=args.rate, precision=args.precision,
                route=args.route,
                encode_programs=programs.encode_programs(eng),
                decode_programs=programs.decode_programs(eng))

    K.reset_launches()
    M.reset()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        eng.decode(eng.encode(pcm))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    spans = M.spans()
    launches = {k: v for k, v in K.LAUNCHES.items() if v}
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        prof.export_chrome_trace(os.path.join(args.out, "trace.json"))
    events = list(prof.events())
    kernels = {}
    for ev in events:
        if M.is_device_op(ev):
            kernels[ev.name] = (kernels.get(ev.name, 0.0)
                                + ev.time_range.elapsed_us())
    busy = sum(kernels.values()) / 1e6
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:15]
    # the port's own kernels (pactpu_torch/csrc), whatever their rank, a
    # templated kernel's instances summed
    own = {}
    for k, v in kernels.items():
        if m := re.search(r"\(anonymous namespace\)::(\w+_kernel)[<(]", k):
            own[m.group(1)] = own.get(m.group(1), 0.0) + v
    own = {k: round(v / 1e3, 3) for k, v in own.items()}
    print(json.dumps({**mode, "device": {
        "wall_s": round(wall, 6), "kernel_s": round(busy, 6),
        "busy_share": round(busy / wall, 4),
        "idle_share": round(1 - busy / wall, 4), "blocks": blocks,
        "own_kernels_ms": own, "launches": launches,
        "top_ms": {k[:120]: round(v / 1e3, 3) for k, v in top},
        # every program captured by the warm-up; the Engine's graph
        # pools by name
        "memory_reserved_mb": torch.cuda.memory_reserved() / 2 ** 20,
        "pools_mb": {k: v / 2 ** 20
                     for k, v in eng.programs.reserved().items()},
        "capture_s": eng.programs.capture_s}}))
    print(json.dumps({**mode, "spans": M.totals(spans)}))
    idle = M.idle_by_range(M.idle_gaps(events),
                           M.innermost(M.host_ranges(events)))
    print(json.dumps({**mode, "idle": {
        k: round(v, 6) for k, v in sorted(idle.items(),
                                          key=lambda kv: -kv[1])}}))
    print(json.dumps({**mode, "programs": stage_runs(events, M.PREFIX)}))
    return 0


def stage_runs(events, prefix: str) -> dict:
    """Each program span of a chunk stage (replay:, direct: or capture:
    <stage>) in a trace: calls, and a call's runtime calls, device events
    and their device time (means), and of them K3's pack kernels and
    their device time: the runtime calls the host made inside the span,
    matched to the device's events by the profiler's correlation id (a
    replay's kernels by its cudaGraphLaunch)."""
    from pactpu_torch.utils.metrics import device_by_correlation
    device = device_by_correlation(events)
    spans = [(ev.name[len(prefix):], ev.time_range.start, ev.time_range.end)
             for ev in events if ev.device_type.name == "CPU"
             and ev.name.startswith(prefix)
             and ev.name[len(prefix):].startswith(STAGE_SPANS)]
    out = {}
    for name, _, _ in spans:
        st = out.setdefault(name, dict(
            calls=0, runtime_calls=0, device_events=0, device_us=0.0,
            pack_kernels=0, pack_us=0.0))
        st["calls"] += 1
    for ev in events:
        if ev.device_type.name != "CPU" or not ev.name.startswith("cu"):
            continue
        for name, t0, t1 in spans:
            if t0 <= ev.time_range.start <= t1:
                st = out[name]
                st["runtime_calls"] += 1
                for k in device.get(ev.id, ()):
                    st["device_events"] += 1
                    st["device_us"] += k.time_range.elapsed_us()
                    if PACK_KERNEL in k.name:
                        st["pack_kernels"] += 1
                        st["pack_us"] += k.time_range.elapsed_us()
    for st in out.values():
        n = st["calls"]
        st.update(runtime_calls_mean=round(st["runtime_calls"] / n, 3),
                  device_events_mean=round(st["device_events"] / n, 3),
                  device_ms_mean=round(st["device_us"] / n / 1e3, 6),
                  pack_kernels_mean=round(st["pack_kernels"] / n, 3),
                  pack_ms_mean=round(st["pack_us"] / n / 1e3, 6))
        st["device_us"] = round(st["device_us"], 3)
        st["pack_us"] = round(st["pack_us"], 3)
    return out


if __name__ == "__main__":
    sys.exit(main())
