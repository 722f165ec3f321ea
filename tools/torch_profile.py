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
decode parse route, peak-picker mode and window, and reports, as JSON
lines:

- "stages": host-clock seconds of each stage of one serial encode +
  decode, with a device synchronize after each stage (so a stage's own
  device work lands in it); the exact mode's encode in three stages (the
  analysis, the cost tables and kernel K7, the final pass); then the
  memory reserved, the Engine's graph pools' share of it by pool, and the
  capture seconds;
- "device": a torch.profiler trace of one encode + decode with no added
  synchronization: wall seconds, summed kernel (device) seconds, the
  device's busy and idle shares, the device time of each of the port's own
  kernels, the device time by kernel name (top 15), and the kernels'
  launches by kernels.LAUNCHES (a program replay adds the launches its
  capture made).  With --out, the chrome trace is written there;
- "pack_step": each finalize's pack (bitpack.pack_payload_bits) in that
  trace: launched one by one, its device launches, runtime calls and
  torch operators; inside a program replay, where nothing of the host
  runs, the K3 kernels the replay ran and their device time;
- "programs": each stage's program replays in that trace (the Engine's
  route on the card, pactpu_torch.codec.programs): replays, runtime
  calls, device kernels and copies a replay and their device time.

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
    from pactpu_torch.codec import exact, programs
    from pactpu_torch.ops import bitpack
    from pactpu_torch.ops import kernels as K

    pack = bitpack.pack_payload_bits

    def pack_step(*a, **kw):          # the engine calls it through bitpack
        with torch.profiler.record_function(PACK_STEP):
            return pack(*a, **kw)

    bitpack.pack_payload_bits = pack_step
    replay = programs.Program.replay

    def program_replay(self):         # a span around each replay
        with torch.profiler.record_function(PROGRAM + self.stage):
            replay(self)

    programs.Program.replay = program_replay

    pcm = np.ascontiguousarray(synth(args.seconds, 4)[:, :args.channels])
    cfg = CodecConfig(peak_mode=args.peak_mode, n_channels=args.channels,
                      window=args.window)
    eng = Engine(device="cuda", cfg=cfg, rate_mode=args.rate,
                 fmt=args.fmt, decode_parse=args.decode_parse,
                 precision=args.precision)
    eng.use_programs = args.route == "programs"
    eng.decode(eng.encode(pcm))                       # warm
    torch.cuda.synchronize()

    stages = {}

    def stage(name, fn, *a):
        t0 = time.perf_counter()
        out = fn(*a)
        torch.cuda.synchronize()
        stages[name] = round(time.perf_counter() - t0, 6)
        return out

    if args.fmt == "pac":
        payload = stage("encode/analyze+finalize+download+pack",
                        eng._encode_baseline, pcm)
    elif args.rate == "exact":
        b, sizes, analyses = stage("encode/upload+analyze", eng._analyze,
                                   pcm)
        extras, _ = stage("encode/cost-tables+exact-scan",
                          exact.exact_extras_chunked, cfg, analyses,
                          eng.consts(), b, None, eng._exact_run())
        st = stage("encode/finalize", eng._stage_payload, analyses, extras,
                   b, sizes)
        payload = stage("encode/download+assemble", eng._finish_encode, st)
    else:
        up = stage("encode/upload", eng._upload_pcm, pcm,
                   eng._analysis_batches)
        st = stage("encode/analyze+reservoir+finalize", eng._encode_dispatch,
                   up)
        payload = stage("encode/download+assemble", eng._finish_encode, st)
    from pactpu_torch.codec.header import write_header
    stream = write_header(eng.cfg, pcm.shape[0])[0] + payload
    staging = ("decode/native-parse+repack" if args.decode_parse == "host"
               else "decode/frame-rows")
    launch = ("decode/upload+synthesis" if args.decode_parse == "host"
              else "decode/upload+walk+synthesis" if args.fmt == "wak"
              else "decode/upload+K1-parse+synthesis")
    staged = stage(staging, eng._decode_staging, stream)
    d = stage(launch, eng._decode_launch, staged)
    stage("decode/download", eng._decode_finish, *d)
    blocks = n_blocks(pcm)
    mode = dict(decode_parse=args.decode_parse, peak_mode=args.peak_mode,
                fmt=args.fmt, channels=args.channels, window=args.window,
                rate=args.rate, precision=args.precision,
                route=args.route,
                encode_programs=programs.encode_programs(eng),
                decode_programs=programs.decode_programs(eng))
    print(json.dumps({**mode,
                      "stages": stages, "blocks": blocks,
                      "total_s": round(sum(stages.values()), 6),
                      # after the warm and the split run: every program
                      # captured; the Engine's graph pools by name
                      "memory_reserved_mb": torch.cuda.memory_reserved()
                      / 2 ** 20,
                      "pools_mb": {k: v / 2 ** 20 for k, v in
                                   eng.programs.reserved().items()},
                      "capture_s": eng.programs.capture_s}))

    K.reset_launches()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        eng.decode(eng.encode(pcm))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches = {k: v for k, v in K.LAUNCHES.items() if v}
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        prof.export_chrome_trace(os.path.join(args.out, "trace.json"))
    kernels = {}
    for ev in prof.events():
        # a kernel or a copy (not the device side of a span)
        if (ev.device_type.name == "CUDA" and ev.name != PACK_STEP
                and not ev.name.startswith(PROGRAM)):
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
        "top_ms": {k[:120]: round(v / 1e3, 3) for k, v in top}}}))
    events = list(prof.events())
    print(json.dumps({**mode, "pack_step": pack_steps(events)}))
    print(json.dumps({**mode, "programs": program_spans(events)}))
    return 0


PACK_STEP = "pack_step"
PROGRAM = "program/"
# K3's kernel (csrc/pack_words.cu) as the trace names it
PACK_KERNEL = "pack_payload_kernel"


def _device_by_correlation(events) -> dict:
    """The device's events (kernels, copies, fills; not the device side of
    a span) by the correlation id of the runtime call that launched
    them: for a graph replay, its cudaGraphLaunch."""
    device = {}
    for ev in events:
        if (ev.device_type.name == "CUDA" and ev.name != PACK_STEP
                and not ev.name.startswith(PROGRAM)):
            device.setdefault(ev.id, []).append(ev)
    return device


def program_spans(events) -> dict:
    """Each stage's program replays (the PROGRAM spans): replays, and a
    replay's runtime calls, device events and their device time (means),
    and the K3 kernels the "final" replays ran (the pack step inside a
    program) with their device time."""
    device = _device_by_correlation(events)
    spans = [(ev.name[len(PROGRAM):], ev.time_range.start, ev.time_range.end)
             for ev in events
             if ev.name.startswith(PROGRAM) and ev.device_type.name == "CPU"]
    out = {}
    for ev in events:
        if ev.device_type.name != "CPU" or not ev.name.startswith("cu"):
            continue
        for stage, t0, t1 in spans:
            if t0 <= ev.time_range.start <= t1:
                st = out.setdefault(stage, dict(
                    replays=0, runtime_calls=0, device_events=0,
                    device_us=0.0, pack_kernels=0, pack_us=0.0))
                st["runtime_calls"] += 1
                for k in device.get(ev.id, ()):
                    st["device_events"] += 1
                    st["device_us"] += k.time_range.elapsed_us()
                    if PACK_KERNEL in k.name:
                        st["pack_kernels"] += 1
                        st["pack_us"] += k.time_range.elapsed_us()
    for stage, _, _ in spans:
        out.setdefault(stage, dict(replays=0, runtime_calls=0,
                                   device_events=0, device_us=0.0,
                                   pack_kernels=0, pack_us=0.0))
        out[stage]["replays"] += 1
    for st in out.values():
        n = max(st["replays"], 1)
        st.update(runtime_calls_mean=round(st["runtime_calls"] / n, 3),
                  device_events_mean=round(st["device_events"] / n, 3),
                  device_ms_mean=round(st["device_us"] / n / 1e3, 6),
                  pack_kernels_mean=round(st["pack_kernels"] / n, 3),
                  pack_ms_mean=round(st["pack_us"] / n / 1e3, 6))
        st["device_us"] = round(st["device_us"], 3)
        st["pack_us"] = round(st["pack_us"], 3)
    return out


def pack_steps(events) -> dict:
    """Each PACK_STEP span of a trace: the device launches (kernels, copies,
    fills) whose runtime call (cudaLaunchKernel and the like, on the host)
    starts inside it, matched to the device's events by correlation id
    (ctypes launches included, which no torch operator encloses), their
    summed device time, the runtime calls themselves, and the torch
    operators called in it."""
    device = _device_by_correlation(events)
    spans = [(ev.time_range.start, ev.time_range.end) for ev in events
             if ev.name == PACK_STEP and ev.device_type.name == "CPU"]
    launches = [0] * len(spans)
    device_us = [0.0] * len(spans)
    calls = [0] * len(spans)
    ops = [0] * len(spans)
    for ev in events:
        if ev.device_type.name != "CPU" or ev.name == PACK_STEP:
            continue
        runtime = ev.name.startswith("cu")
        for i, (t0, t1) in enumerate(spans):
            if not t0 <= ev.time_range.start <= t1:
                continue
            ops[i] += ev.name.startswith("aten::")
            if runtime:
                calls[i] += 1
                for k in device.get(ev.id, ()):
                    launches[i] += 1
                    device_us[i] += k.time_range.elapsed_us()
    mean = lambda v: round(sum(v) / max(len(v), 1), 3)  # noqa: E731
    return dict(steps=len(spans), launches_mean=mean(launches),
                device_ms_mean=round(mean(device_us) / 1e3, 6),
                runtime_calls_mean=mean(calls), aten_ops_mean=mean(ops),
                launches=launches, device_us=[round(u, 3) for u in device_us],
                runtime_calls=calls, aten_ops=ops)


if __name__ == "__main__":
    sys.exit(main())
