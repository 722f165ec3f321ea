#!/usr/bin/env python3
"""Time this checkout's CUDA kernels against another checkout's, in turns,
in one process on one card.

    python3 tools/kernel_ab.py --other NAME=DIR [--other NAME=DIR ...]
                               [--kernels spread_maskers huffman_walk ...]
                               [--rounds 2] [--prefill NAME ...]

DIR is a directory of kernel sources with this checkout's C interface
(pactpu_torch/csrc/kernels.h), for example the csrc of an earlier commit
unpacked with `git archive`.  Each is built with the package's own nvcc
flags into pactpu_torch/_build/ab_NAME/.  The kernels (extract_codes,
spread_maskers_up, water_fill, spread_maskers, huffman_walk, exact_scan,
cost_table, grant_fill, closed_form, pack_words) run through the
package's wrappers on chip_smoke.py's phase-1 inputs (one 512-block chunk
of its 60 s file; K7 in float32, K10 and K8 in float32 and, as
cost_table_f64 and closed_form_f64, in float64),
each version that has the kernel checked against the plain version first,
then timed in the order other, this, this, other (each turn the median of 20
calls with CUDA events, once around the wrapper's call and once of the
kernel alone: chip_smoke.median_ms and device_ms; `--rounds` times over).
Prints one JSON line per kernel and version with every turn's medians and
whether its result equals this checkout's bit for bit, the ptxas lines of
each build, and the card's name, power limit and SM clock.  For water_fill
it also prints each version's time a greedy step (per_step), for
huffman_walk each version's time a decoded line (per_line), for exact_scan
each version's time alone a greedy step of the chunk's chain, for
grant_fill (on the chunk's SMR rows, as const_mnr takes them) the walk's
grants and, as K9's plain mirror kernels.grant_fill_jump_plain counts them
(the kernel reports none), the grants the jump takes, the steps walked
(all rows and the most in a row) and the probes, each version's time alone on the peak-SPL
rows (const_snr) and its ns a grant on rows that only walk and on rows
the jump takes (per_grant), and for closed_form (K8, on the chunk's
rows: both channels at the flat budget; closed_form_f64 on its float64
analysis) the chunk's trips and each version's ns a trip and time on rows
that take no trip, in both types, beside the launch floor (per_trip);
pack_words (K3) runs on phase 1's 1,024 rows of 1,148 parts and prints
its byte bound; pack_payload (K3 as the engine launches it,
bitpack.pack_payload_bits) runs on the chunk's payload fields (1,024
rows, 256 words) in every version whose library has it, and as the parent
commit's pack step (chip_smoke.pack_prologue_and_k3: the int64 torch
prologue, then pack_words on its parts) with each version's pack_words,
as version "NAME:parts"; each version's line adds its device launches a
call (torch.profiler's device events), and the kernel's line its byte
bound and the launch floor.  The cost tables' plain version (the tensor
operations kernel K10 replaced) takes its turns as version "plain"; a
version whose K10 reads the table set unpacked (the earlier K10) is
launched through cost_table_unpacked, and one whose K7 takes the count of
valid blocks as a launch argument (the earlier K7) through
exact_scan_count; this checkout's K7 reads a valid mask made once, as
the engine's programs hand it over.

`--prefill NAME`: version NAME's huffman_walk writes only the lines of
active bands (the kernel before the one that writes every line), so its
code tensor is zero-filled first, as its wrapper did; the fill is part of
its time.  Such a version takes the band layout as a host array, as
huffman_walk did before it took a device array: time huffman_walk only
against versions of the same convention.

water_fill's time a greedy step is also given for this checkout at 40
bands (two a lane), in float64 (the forms an older K2 lacks) and on one
row (one warp on the card, as K7's chain runs).

Needs a CUDA device; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import ctypes
import functools
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

CHOICES = ("extract_codes", "spread_maskers_up", "water_fill",
           "spread_maskers", "huffman_walk", "exact_scan", "cost_table",
           "cost_table_f64", "grant_fill", "closed_form", "closed_form_f64",
           "pack_words", "pack_payload")


def device_launches(torch, fn) -> int:
    """The device events (kernels, copies, fills) of one call of fn, as
    torch.profiler traces them."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(ev.device_type.name == "CUDA" for ev in prof.events())


def cost_table_unpacked(torch, K, lib, a10):
    """kernels.cost_table's launch for a library whose K10 reads the table
    set as it is (the earlier K10: pactpu_cost_table(_f64) with tab_lens
    and esc_len, before the packed set), on the same arguments."""
    mixed, lay, lens, esc, n_scale_bits, max_mant = a10
    b, c, half = mixed.shape
    n_bands = lay["n_lines"].shape[0]
    n_tab, n_sym = lens.shape
    exp2 = K._exp2_ks(mixed.device, mixed.dtype, (1 << n_scale_bits) - 1,
                      int(max_mant))
    out = torch.empty((b, c, n_bands, K.N_ALLOCS, n_tab), dtype=torch.int32,
                      device=mixed.device)
    fn = getattr(lib, "pactpu_cost_table_f64" if mixed.dtype == torch.float64
                 else "pactpu_cost_table")
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 7 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    stream = torch.cuda.current_stream(mixed.device).cuda_stream
    rc = fn(*(K._ptr(t) for t in (mixed, lay["n_lines"], lens, esc, exp2,
                                  out)),
            b * c, half, n_bands, n_tab, n_sym, int(n_scale_bits),
            int(max_mant), ctypes.c_void_p(stream))
    if rc != 0:
        raise RuntimeError(f"cost_table (unpacked): CUDA error {rc}")
    return out


def exact_scan_count(torch, K, lib, a7, n_valid: int):
    """kernels.exact_scan's launch for a library whose K7 takes the count
    of valid blocks as a launch argument (the earlier K7:
    pactpu_exact_scan(_f64), before the valid mask read on the device), on
    the same arguments, with the count n_valid."""
    smr, lrms, cost, _, carry, budget, n_lines, max_mant, ms_stop, \
        lr_stop, tid_bits, divisor = a7
    b, c, n_bands = smr.shape
    extras = torch.empty(b, dtype=torch.int32, device=smr.device)
    carry_out = torch.empty(2, dtype=torch.int32, device=smr.device)
    fn = getattr(lib, "pactpu_exact_scan_f64" if smr.dtype == torch.float64
                 else "pactpu_exact_scan")
    P, I, D = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
    fn.argtypes = [P] * 7 + [I] * 5 + [D, I, D, D, I, I, P]
    fn.restype = ctypes.c_int
    stream = torch.cuda.current_stream(smr.device).cuda_stream
    rc = fn(*(K._ptr(t) for t in (smr, lrms, cost, n_lines, carry,
                                  carry_out, extras)),
            b, int(n_valid), c, n_bands, cost.shape[4], float(budget),
            int(max_mant), float(ms_stop), float(lr_stop), int(tid_bits),
            int(divisor), ctypes.c_void_p(stream))
    if rc != 0:
        raise RuntimeError(f"exact_scan (count): CUDA error {rc}")
    return extras, carry_out


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
    nl40 = torch.cat([nl, nl[:15]])
    forms = {"f32": (nl, lrms, smr),
             # one row: one warp on the card, as K7 runs its chain
             "f32-1-row": (nl, lrms[:1], smr[:1]),
             "f32-40-bands": (nl40, torch.zeros((512, 40), dtype=torch.bool,
                                                device=dev),
                              torch.cat([smr, smr[:, :15]], 1).contiguous()),
             "f64": (nl, lrms, smr.double())}
    for name in libs:
        use(name)
        for form, (n_lines, ms_flags, s) in forms.items():
            if form != "f32" and name != "this":
                continue
            bands = n_lines.shape[0]
            lo, hi = bands, 16 * bands       # steps: all retire / all cap
            rows = s.shape[0]
            ms = {}
            for steps, budget in ((lo, 0), (hi, 10 ** 7)):
                total = torch.full((rows,), budget, dtype=torch.int32,
                                   device=dev)
                bits, _ = K.water_fill(total, 16, n_lines, s, ms_flags)
                if int(bits.sum()) != (0 if budget == 0
                                       else rows * bands * 16):
                    raise chip_smoke.SmokeError("per_step: unexpected grants")
                ms[steps] = chip_smoke.device_ms(torch, lambda: K.water_fill(
                    total, 16, n_lines, s, ms_flags))
            print(json.dumps({"kernel": "water_fill", "version": name,
                              "form": form, "bands": bands, "rows": rows,
                              f"device_ms_{lo}_steps": ms[lo],
                              f"device_ms_{hi}_steps": ms[hi],
                              "ns_per_step": (ms[hi] - ms[lo]) / (hi - lo)
                              * 1e6}))


def per_grant(torch, K, chip_smoke, libs, use, a9) -> None:
    """K9 on the chunk's SMR rows (const_mnr) and peak-SPL rows
    (const_snr), each version's time alone beside the grants of the walk,
    the grants the jump takes and the steps walked one at a time (the
    plain mirror's counts: "mirror_*"), and its
    ns a step: rows that only walk (a NaN level in each: no jump, 400
    grants a row) and the same finite rows (the jump takes them), each
    against the same rows with a zero budget (chip_smoke.k9_step_rows)."""
    walk = {}
    for what, args in a9.items():
        grants, jump = {}, {}
        K.grant_fill_plain(*args, stats=grants)
        K.grant_fill_jump_plain(*args, stats=jump)
        walk[what] = dict(grants=grants["steps"],
                          grants_max_row=grants["max_steps"],
                          mirror_walked=jump["steps"],
                          mirror_walked_max_row=jump["max_walked"],
                          mirror_jumped=jump["jumped"],
                          mirror_probes=jump["probes"],
                          rows=args[1].shape[0])
    print(json.dumps({"kernel": "grant_fill", "walk": walk}))
    steps = chip_smoke.k9_step_rows(torch, a9["mnr"][2], 1024)
    for name in libs:
        if not hasattr(libs[name], K._C_FUNCS["grant_fill"][0]):
            continue
        use(name)
        line = {"kernel": "grant_fill", "version": name,
                "device_ms_snr": chip_smoke.device_ms(
                    torch, lambda: K.grant_fill(*a9["snr"]))}
        for form, (many, none, grants) in steps.items():
            ms = [chip_smoke.device_ms(torch, lambda: K.grant_fill(*a))
                  for a in (many, none)]
            line[f"ns_per_{form}_grant"] = (ms[0] - ms[1]) / grants * 1e6
        print(json.dumps(line))


def per_trip(torch, K, chip_smoke, libs, use, a8, rounds: int) -> None:
    """K8's trips: those of the chunk's rows (the plain version's count,
    all rows and the longest row), and each version's time alone on rows
    that take 346 trips and on the same rows taking none
    (chip_smoke.k8_step_rows), in float32 and float64, in turns other,
    this, this, other: ns a trip is the difference over the trips, and
    the rows taking none are the launch, one row's init and the store.
    Beside them, the launch floor (chip_smoke.launch_floor_ms)."""
    stats = {}
    K.closed_form_plain(*a8, stats=stats)
    nl = a8[2]
    forms = {"f32": chip_smoke.k8_step_rows(torch, nl, 1024),
             "f64": chip_smoke.k8_step_rows(torch, nl, 1024, torch.float64)}
    trips = {}
    for form, (many, _) in forms.items():
        st = {}
        K.closed_form_plain(*many, stats=st)
        trips[form] = st["max_steps"]
    print(json.dumps({"kernel": "closed_form", "chunk_trips": stats["steps"],
                      "chunk_trips_max_row": stats["max_steps"],
                      "rows": a8[1].shape[0], "step_input_trips": trips}))
    symbol = K._C_FUNCS["closed_form"][0]
    names = [n for n in libs if hasattr(libs[n], symbol)]
    others = [n for n in names if n != "this"]
    got = {n: {f: dict(many=[], none=[]) for f in forms} for n in names}
    floor = []
    for _ in range(rounds):
        for name in others + ["this", "this"] + others[::-1]:
            use(name)
            for form, (many, none) in forms.items():
                for what, a in (("many", many), ("none", none)):
                    got[name][form][what].append(chip_smoke.device_ms(
                        torch, lambda: K.closed_form(*a)))
        floor.append(chip_smoke.launch_floor_ms(torch))
    for name in names:
        line = {"kernel": "closed_form", "version": name,
                "launch_floor_ms_by_round": floor}
        for form, t in got[name].items():
            line[form] = dict(
                device_ms_many=t["many"], zero_trip_device_ms=t["none"],
                ns_per_trip=[(a - b) * 1e6 / trips[form]
                             for a, b in zip(t["many"], t["none"])])
        print(json.dumps(line))


def walk_prefilled(torch, K, words, lut, n_lines, n_scale_bits,
                   n_mant_size_bits, n_table_id_bits):
    """kernels.huffman_walk's launch with the code tensor zero-filled."""
    rows, n_bands, total = words.shape[0], len(n_lines), int(sum(n_lines))
    code = torch.zeros((rows, total), dtype=torch.int32, device=words.device)
    basf, soff = (torch.empty((rows, n_bands), dtype=torch.int32,
                              device=words.device) for _ in range(2))
    misc = torch.empty((rows, 5), dtype=torch.int32, device=words.device)
    # a version this old takes the band layout as a host array
    bands = (ctypes.c_int32 * n_bands)(*(int(n) for n in n_lines))
    K._launch("huffman_walk", words.device, K._ptr(words), K._ptr(lut["l1"]),
              K._ptr(lut["l1b"]), K._ptr(lut["l2"]), bands, K._ptr(code),
              K._ptr(basf), K._ptr(soff), K._ptr(misc), rows, words.shape[1],
              n_bands, total, lut["l1"].shape[0], lut["l2"].shape[1],
              int(n_scale_bits), int(n_mant_size_bits), int(n_table_id_bits))
    return code, basf, soff, misc


def per_line(torch, K, chip_smoke, libs, use, walk, walk_args) -> None:
    """K5's time a decoded line: 1,020 well-formed rows of 192 words (102
    a shipped table, chip_smoke.k5_rows) whose bands are all inactive (25
    band steps a row), all active with each table's two shortest codes
    (1,024 lines through the root table) and, in the 15 narrowest bands,
    with codes past 11 bits (125 lines through the level-2 pool), the
    kernel alone; the differences over the lines are free of the fixed
    cost."""
    import numpy as np
    from pactpu_torch.ops.huffman import load_tables
    lengths = load_tables()[0]
    short = [np.argsort(np.where(ln > 0, ln, 99), kind="stable")[:2]
             for ln in lengths]
    deep = [np.nonzero(ln > K.WALK_ROOT_BITS)[0] for ln in lengths]
    cases = {
        "none": (lambda b: 0, None),
        "root": (lambda b: 3, lambda t, ba, i, r: (int(r.choice(short[t])),
                                                   False)),
        "deep": (lambda b: 3 if b < 15 else 0,
                 lambda t, ba, i, r: (int(r.choice(deep[t])), False)),
    }
    dev = torch.device("cuda")
    inputs, lines = {}, {}
    for case, (ba_of, value_of) in cases.items():
        words, want = chip_smoke.k5_rows(ba_of, value_of, 192)
        inputs[case] = (
            (torch.from_numpy(np.tile(words, (102, 1)).view(np.int32))
             .to(dev), *walk_args[1:]), np.tile(want, (102, 1)))
        lines[case] = sum(n for b, n in enumerate(walk_args[2]) if ba_of(b))
    for name in libs:
        use(name)
        ms = {}
        for case, (args, want) in inputs.items():
            rec = walk(name, args)
            if (not np.array_equal(rec[0].cpu().numpy(), want)
                    or bool(rec[3][:, 2].any())):
                raise chip_smoke.SmokeError(f"per_line: {case} of {name} "
                                            "decodes wrongly")
            ms[case] = chip_smoke.device_ms(torch, lambda: walk(name, args))
        print(json.dumps({
            "kernel": "huffman_walk", "version": name, "device_ms": ms,
            "lines": lines, **{
                f"ns_per_{case}_line": (ms[case] - ms["none"]) / lines[case]
                * 1e6 for case in ("root", "deep")}}))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--other", action="append", default=[],
                    metavar="NAME=DIR", help="another csrc directory")
    ap.add_argument("--kernels", nargs="+", default=list(CHOICES),
                    choices=CHOICES)
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--prefill", nargs="*", default=[], metavar="NAME",
                    help="versions whose huffman_walk needs a zeroed output")
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
        # an older checkout may lack sources and symbols: what it has is
        # built and bound
        src = os.path.abspath(src)
        K.build(src, lib_path, log_path,
                [s for s in K.SOURCES if os.path.exists(os.path.join(src, s))])
        has = ctypes.CDLL(lib_path)
        libs[name] = K.bind(lib_path, [s for s in K.c_symbols()
                                       if hasattr(has, s)])
        print(json.dumps({"build": name, "csrc": src,
                          "ptxas": ptxas(log_path)}))

    eng = Engine(device="cuda", rate_mode="reservoir")
    pcm = chip_smoke.synth(60.0, 4)
    chunk = chip_smoke.main_path_inputs(
        torch, device_tables(eng.cfg, "cuda"), pcm, stream=eng.encode(pcm))
    version = ["this"]           # the library the wrappers launch from

    def walk(name, walk_args):
        if name in args.prefill:
            return walk_prefilled(torch, K, *walk_args)
        return K.huffman_walk(*walk_args)

    plain_args = {}              # the plain versions' extra arguments
    if {"exact_scan", "cost_table", "cost_table_f64"} & set(args.kernels):
        tables = device_tables(eng.cfg, "cuda")
        a7 = chip_smoke.k7_args(torch, eng.cfg, tables, pcm, 512)
        # K7 reads its valid mask from device memory (the engine's and
        # the programs' form); an earlier K7 takes the count
        n7 = a7[3]
        a7 = (*a7[:3], torch.arange(512, device="cuda") < n7, *a7[4:])
        a10 = chip_smoke.k10_args(torch, eng.cfg, tables, pcm, 512)
        a10d = chip_smoke.k10_args(torch, eng.cfg, device_tables(
            eng.cfg, "cuda", "f64"), pcm, 512)
        # the table set packed once, as the exact mode keeps it
        p10 = K.pack_tables(a10[2], a10[3])
        steps = dict(steps=0, fills=0)
        # the greedy steps of the chain (the plain version without K7's
        # jump), the work a step's time is counted against
        plain_args["exact_scan"] = dict(stats=steps, jump=False)
    if "grant_fill" in args.kernels:
        a9 = chip_smoke.k9_args(torch, device_tables(eng.cfg, "cuda"), pcm)
    if {"closed_form", "closed_form_f64"} & set(args.kernels):
        a8 = chip_smoke.k8_args(torch, device_tables(eng.cfg, "cuda"), pcm)
        a8d = chip_smoke.k8_args(torch, device_tables(eng.cfg, "cuda", "f64"),
                                 pcm)
    if "pack_payload" in args.kernels:
        from pactpu_torch.ops import bitpack
        layout = (eng.cfg.band_layout.n_lines, eng.cfg.n_scale_bits,
                  eng.cfg.n_mant_size_bits, eng.cfg.n_table_id_bits)
        f3 = chunk["k3"]
        w3, n3 = bitpack.pack_payload_bits_plain(*f3, *layout, 256)
        plan3 = bitpack.device_plan(tuple(layout[0]), *layout[1:], "cuda")
        print(json.dumps({"kernel": "pack_payload", "rows": w3.shape[0],
                          "bound_ms": chip_smoke.nbytes(*f3, *plan3, w3, n3)
                          / chip_smoke.PEAK_BYTES_PER_S * 1e3,
                          "launch_floor_ms": chip_smoke.launch_floor_ms(
                              torch)}))
    if "pack_words" in args.kernels:
        a3 = chip_smoke.k3_args(torch, torch.device("cuda"))[-1]
        out3 = K.pack_words(*a3)
        # bytes once (parts, word indices, words) over the card's rate
        print(json.dumps({"kernel": "pack_words", "bound_ms":
                          chip_smoke.nbytes(*a3[:3], out3)
                          / chip_smoke.PEAK_BYTES_PER_S * 1e3}))
    calls = {
        "extract_codes": (lambda: K.extract_codes(*chunk["k1"]),
                          lambda: K.extract_codes_plain(*chunk["k1"])),
        "spread_maskers_up": (lambda: K.spread_maskers_up(*chunk["k4"]),
                              lambda: K.spread_maskers_up_plain(
                                  *chunk["k4"])),
        "water_fill": (lambda: K.water_fill(*chunk["k2"]),
                       lambda: K.water_fill_plain(*chunk["k2"])),
        "spread_maskers": (lambda: K.spread_maskers(*chunk["k6"]),
                           lambda: K.spread_maskers_plain(*chunk["k6"])),
        "huffman_walk": (lambda: walk(version[0], chunk["k5"]),
                         lambda: K.huffman_walk_plain(*chunk["k5"])),
        "exact_scan": (lambda: K.exact_scan(*a7),
                       lambda **kw: K.exact_scan_plain(*a7, **kw)),
        "cost_table": (lambda: K.cost_table(*a10, p10),
                       lambda: K.cost_table_plain(*a10)),
        "cost_table_f64": (lambda: K.cost_table(*a10d, p10),
                           lambda: K.cost_table_plain(*a10d)),
        "grant_fill": (lambda: K.grant_fill(*a9["mnr"]),
                       lambda: K.grant_fill_plain(*a9["mnr"])),
        "closed_form": (lambda: K.closed_form(*a8),
                        lambda: K.closed_form_plain(*a8)),
        "closed_form_f64": (lambda: K.closed_form(*a8d),
                            lambda: K.closed_form_plain(*a8d)),
        "pack_words": (lambda: K.pack_words(*a3),
                       lambda: K.pack_words_plain(*a3)),
        "pack_payload": (lambda: bitpack.pack_payload_bits(*f3, *layout,
                                                           256),
                         lambda: bitpack.pack_payload_bits_plain(
                             *f3, *layout, 256)),
    }
    # bit for bit, else K4_RTOL
    exact = ("extract_codes", "water_fill", "huffman_walk", "exact_scan",
             "cost_table", "cost_table_f64", "grant_fill", "closed_form",
             "closed_form_f64", "pack_words", "pack_payload")

    def use(name):                # "NAME:parts" runs NAME's library
        K._lib = libs.get(name.split(":")[0], libs["this"])
        version[0] = name

    try:
        for kernel in args.kernels:
            fn, plain_fn = calls[kernel]
            plain = plain_fn(**plain_args.get(kernel, {}))
            # the versions whose library has the kernel; the cost tables'
            # plain version (the tensor operations K10 replaced) takes a
            # turn as "plain"
            f64 = kernel.endswith("_f64")
            symbol = (K._C_FUNCS_F64 if f64 else K._C_FUNCS)[
                kernel.removesuffix("_f64")][0]
            names = [n for n, lib in libs.items() if hasattr(lib, symbol)]
            run = {n: fn for n in names}
            if kernel.startswith("cost_table"):
                old = "pactpu_cost_table" + ("_f64" if f64 else "")
                for n, lib in libs.items():     # K10 before the packed set
                    if n not in run and hasattr(lib, old):
                        names.append(n)
                        run[n] = functools.partial(
                            cost_table_unpacked, torch, K, lib,
                            a10d if f64 else a10)
                names.append("plain")
                run["plain"] = plain_fn
            if kernel == "exact_scan":     # K7 before the valid mask
                for n, lib in libs.items():
                    if n not in run and hasattr(lib, "pactpu_exact_scan"):
                        names.append(n)
                        run[n] = functools.partial(exact_scan_count, torch,
                                                   K, lib, a7, n7)
            if kernel == "pack_payload":    # the parent's pack step
                parts = functools.partial(chip_smoke.pack_prologue_and_k3,
                                          f3, eng.cfg, 256)
                for n, lib in libs.items():
                    if hasattr(lib, K._C_FUNCS["pack_words"][0]):
                        names.append(f"{n}:parts")
                        run[f"{n}:parts"] = parts
            times = {name: [] for name in names}
            device = {name: [] for name in names}
            same, mine = {}, None    # bit for bit this checkout's result?
            for name in names:
                use(name)
                got = run[name]()
                torch.cuda.synchronize()
                flat = torch.cat([g.flatten().view(torch.int32) for g in (
                    got if isinstance(got, tuple) else (got,))])
                mine = flat if mine is None else mine
                same[name] = torch.equal(flat, mine)
                if kernel in exact:
                    ok = all(torch.equal(a, b) for a, b in zip(
                        *(x if isinstance(x, tuple) else (x,)
                          for x in (got, plain))))
                else:
                    ok = bool(((got - plain).abs() <= chip_smoke.K4_RTOL
                               * plain.abs() + 1e-30).all())
                if not ok:
                    raise chip_smoke.SmokeError(
                        f"{kernel} of {name} differs from the plain version")
            if kernel == "water_fill":   # the longest row's dependent steps
                print(json.dumps({"kernel": kernel, "chain_steps_max": int(
                    plain[0].sum(1).max()) + plain[0].shape[1]}))
            others = [n for n in names if n != "this"]
            for _ in range(args.rounds):
                for name in others + ["this", "this"] + others[::-1]:
                    use(name)
                    times[name].append(chip_smoke.median_ms(torch, run[name]))
                    device[name].append(chip_smoke.device_ms(torch,
                                                             run[name]))
            for name, ms in times.items():
                line = {"kernel": kernel, "version": name,
                        "median_ms_by_turn": ms,
                        "device_ms_by_turn": device[name],
                        "equals_this": same[name]}
                if kernel == "pack_payload":
                    use(name)
                    line["launches"] = device_launches(torch, run[name])
                if kernel == "exact_scan":   # the chain's greedy steps
                    line.update(steps=steps["steps"], fills=steps["fills"],
                                ns_per_step=[d * 1e6 / steps["steps"]
                                             for d in device[name]])
                print(json.dumps(line))
        if "water_fill" in args.kernels:
            per_step(torch, K, chip_smoke, libs, use)
        if "huffman_walk" in args.kernels:
            per_line(torch, K, chip_smoke, libs, use, walk, chunk["k5"])
        if "grant_fill" in args.kernels:
            per_grant(torch, K, chip_smoke, libs, use, a9)
        if "closed_form" in args.kernels:
            per_trip(torch, K, chip_smoke, libs, use, a8, args.rounds)
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
