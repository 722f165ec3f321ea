#!/usr/bin/env python3
"""Time this checkout's CUDA kernels against another checkout's, in turns,
in one process on one card.

    python3 tools/kernel_ab.py --other NAME=DIR [--other NAME=DIR ...]
                               [--kernels spread_maskers_up water_fill]
                               [--rounds 2]

DIR is a directory of kernel sources with this checkout's C interface
(pactpu_torch/csrc/kernels.h), for example the csrc of an earlier commit
unpacked with `git archive`.  Each is built with the package's own nvcc
flags into pactpu_torch/_build/ab_NAME/.  The kernels run through the
package's wrappers on chip_smoke.py's phase-1 inputs (one 512-block chunk
of its 60 s file), each version checked against the plain version first,
then timed in the order other, this, this, other (each turn the median of
20 calls with CUDA events, once around the wrapper's call and once of the
kernel alone: chip_smoke.median_ms and device_ms; `--rounds` times over).
Prints one JSON line per kernel and version with every turn's medians and
whether its result equals this checkout's bit for bit, the ptxas lines of
each build, and the card's name, power limit and SM clock.  For water_fill
it also prints each version's time a greedy step (per_step).

Needs a CUDA device; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

CHOICES = ("spread_maskers_up", "water_fill")


def per_step(torch, K, chip_smoke, libs, use) -> None:
    """K2's time a greedy step: 512 rows of 25 bands that all take exactly
    25 steps (a zero budget retires one band a step) and exactly 400 (SMRs
    near 200 dB and a budget that never ends: 16 grants a band, the last
    of which retires it, and the stop rule never fires), the kernel alone;
    the difference over 375 steps is free of the launch's fixed cost."""
    import numpy as np
    rng = np.random.default_rng(0)
    dev = torch.device("cuda")
    nl = torch.from_numpy(rng.integers(4, 60, 25).astype(np.int32)).to(dev)
    lrms = torch.zeros((512, 25), dtype=torch.bool, device=dev)
    smr = torch.from_numpy(200 + rng.random((512, 25)).astype(np.float32))
    smr = smr.to(dev)
    for name in libs:
        use(name)
        ms = {}
        for steps, budget in ((25, 0), (400, 10 ** 7)):
            total = torch.full((512,), budget, dtype=torch.int32, device=dev)
            bits, _ = K.water_fill(total, 16, nl, smr, lrms)
            if int(bits.sum()) != (0 if budget == 0 else 512 * 25 * 16):
                raise chip_smoke.SmokeError("per_step: unexpected grants")
            ms[steps] = chip_smoke.device_ms(
                torch, lambda: K.water_fill(total, 16, nl, smr, lrms))
        print(json.dumps({"kernel": "water_fill", "version": name,
                          "device_ms_25_steps": ms[25],
                          "device_ms_400_steps": ms[400],
                          "ns_per_step": (ms[400] - ms[25]) / 375 * 1e6}))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--other", action="append", default=[],
                    metavar="NAME=DIR", help="another csrc directory")
    ap.add_argument("--kernels", nargs="+", default=list(CHOICES),
                    choices=CHOICES)
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("kernel_ab: needs a CUDA device", file=sys.stderr)
        return 2

    import chip_smoke
    from pactpu_torch import Engine
    from pactpu_torch.codec.engine import device_tables
    from pactpu_torch.ops import kernels as K

    def ptxas(log_path):
        with open(log_path) as f:
            return [ln.strip() for ln in f
                    if "registers" in ln or "Compiling entry" in ln]

    K.build()
    libs = {"this": K._load()}
    print(json.dumps({"build": "this", "ptxas": ptxas(K.BUILD_LOG)}))
    for spec in args.other:
        name, _, src = spec.partition("=")
        out_dir = os.path.join(K.BUILD_DIR, f"ab_{name}")
        lib_path = os.path.join(out_dir, "libpactpu_kernels.so")
        log_path = os.path.join(out_dir, "kernels_build.log")
        K.build(os.path.abspath(src), lib_path, log_path)
        libs[name] = K.bind(lib_path)
        print(json.dumps({"build": name, "csrc": src,
                          "ptxas": ptxas(log_path)}))

    eng = Engine(device="cuda", rate_mode="reservoir")
    chunk = chip_smoke.main_path_inputs(
        torch, device_tables(eng.cfg, "cuda"), chip_smoke.synth(60.0, 4))
    calls = {
        "spread_maskers_up": (lambda: K.spread_maskers_up(*chunk["k4"]),
                              K.spread_maskers_up_plain(*chunk["k4"])),
        "water_fill": (lambda: K.water_fill(*chunk["k2"]),
                       K.water_fill_plain(*chunk["k2"])),
    }

    def use(name):               # the wrappers launch from this library
        K._lib = libs[name]

    try:
        for kernel in args.kernels:
            fn, plain = calls[kernel]
            times = {name: [] for name in libs}
            device = {name: [] for name in libs}
            same, mine = {}, None    # bit for bit this checkout's result?
            for name in libs:
                use(name)
                got = fn()
                torch.cuda.synchronize()
                flat = torch.cat([g.flatten().view(torch.int32) for g in (
                    got if isinstance(got, tuple) else (got,))])
                mine = flat if mine is None else mine
                same[name] = torch.equal(flat, mine)
                if kernel == "water_fill":
                    ok = all(torch.equal(a, b) for a, b in zip(got, plain))
                else:
                    ok = bool(((got - plain).abs() <= chip_smoke.K4_RTOL
                               * plain.abs() + 1e-30).all())
                if not ok:
                    raise chip_smoke.SmokeError(
                        f"{kernel} of {name} differs from the plain version")
            if kernel == "water_fill":   # the longest row's dependent steps
                print(json.dumps({"kernel": kernel, "chain_steps_max": int(
                    plain[0].sum(1).max()) + plain[0].shape[1]}))
            others = [n for n in libs if n != "this"]
            for _ in range(args.rounds):
                for name in others + ["this", "this"] + others[::-1]:
                    use(name)
                    times[name].append(chip_smoke.median_ms(torch, fn))
                    device[name].append(chip_smoke.device_ms(torch, fn))
            for name, ms in times.items():
                print(json.dumps({"kernel": kernel, "version": name,
                                  "median_ms_by_turn": ms,
                                  "device_ms_by_turn": device[name],
                                  "equals_this": same[name]}))
        if "water_fill" in args.kernels:
            per_step(torch, K, chip_smoke, libs, use)
    finally:
        use("this")
    print(json.dumps({"sm_clock_mhz": chip_smoke.sm_clock_mhz()}))
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
