"""Closed loop, one client: each call is `Engine.encode_many` of a batch of
short clips (a media platform's batch ingest of short uploads: the audio
of social video, ads, previews), their streams kept.

Traffic keys: lengths (median_s, sigma, lo_s, hi_s, count: the clips of a
call, every call the same set of lengths, each call in its own order drawn
from the seed), pool (distinct synthetic tracks the clips are cut from),
pool_s (the length of each), trace_items (calls inside the device trace),
check (calls: how many calls the reference judges, a sample drawn from the
seed as the window runs; clips: clips judged in each, one from each of as
many equal parts of the call's positions; blocks: blocks sampled in each
judged clip).  A call must give one stream a clip, each of its clip's
samples by its header, or it counts as failed; its blocks are counted
from those headers.  Each judged clip is judged whole for its reservoir
chain and at sampled blocks for its coding, from the statistics
`Engine.last_many` keeps of each file; a program without them reports its
last file's alone (`last_extras`, `last_measure`), and the last clip of
each judged call is judged.
"""

from __future__ import annotations

import struct
import sys
import time

import numpy as np

from harness import synth, tracks


def plan(run, rng) -> list:
    """One call's clips: (pool entry, first sample, samples) each, the
    lengths in an order drawn from rng, cut at offsets drawn from rng."""
    st = run.state
    sizes, pool = st["sizes"], st["pool"]
    order = rng.permutation(len(sizes))
    entry = rng.integers(0, len(pool), len(sizes))
    room = pool.shape[1] - sizes[order]
    start = (rng.random(len(sizes)) * room).astype(np.int64)
    return [(int(p), int(s), int(sizes[j]))
            for p, s, j in zip(entry, start, order)]


def clips(run, calls: list) -> list:
    pool = run.state["pool"]
    return [pool[p][s:s + n] for p, s, n in calls]


def prepare(run) -> None:
    tr = run.traffic
    ln = tr["lengths"]
    secs = synth.lognormal_lengths(ln["median_s"], ln["sigma"], ln["lo_s"],
                                   ln["hi_s"], ln["count"])
    sizes = (secs * synth.FS).astype(np.int64)
    pool = synth.track_pool(run.torch, run.seed, tr["pool"], tr["pool_s"],
                            run.device)
    eng = tracks.make_engine(run)
    run.state.update(eng=eng, sizes=sizes, pool=pool, rng=run.rng(1))
    # every call has the same lengths, so one call warms up every shape
    eng.encode_many(clips(run, plan(run, run.rng(3))))
    run.info["captures_setup"] = eng.programs.captures
    run.state["keys_setup"] = tracks.program_keys(eng)


def samples(stream: bytes) -> int:
    """The samples a channel a .wak stream's header declares."""
    return struct.unpack_from("<LHLLHH", stream, 4)[2]


def stats(eng, n: int) -> list:
    """Each file's statistics of the last encode_many of n files: the
    program's own (read after the window), or where it keeps the last
    file's alone, None for the others and (extras, measure) for it."""
    many = getattr(eng, "last_many", None)
    if many is not None:
        return list(many)
    return [None] * (n - 1) + [(eng.last_extras, eng.last_measure)]


def window(run) -> None:
    st = run.state
    eng, rng = st["eng"], st["rng"]
    traced_items = run.traffic.get("trace_items", 0)
    # a sample of check["calls"] of the calls, kept whole for the judge
    # (reservoir sampling, drawn from the seed)
    keep, kept = run.rng(4), []
    n_keep = run.traffic["check"]["calls"]
    if run.trace is not None:
        run.trace.start()
    t0 = time.perf_counter()
    k = 0
    while True:
        calls = plan(run, rng)
        in_trace = run.trace is not None and run.trace.on
        run.attempted += 1
        try:
            with run.spans.span("encode"):
                streams = eng.encode_many(clips(run, calls))
            got = [samples(s) for s in streams]
            if got != [n for _, _, n in calls]:
                raise ValueError(f"{len(streams)} streams for {len(calls)} "
                                 f"clips; samples {got}")
            rec = {"k": k, "calls": calls, "traced": in_trace}
            done = len(run.items)
            slot = (done if done < n_keep
                    else int(keep.integers(0, done + 1)))
            if slot < n_keep:
                if slot < len(kept):
                    for key in ("streams", "stats"):
                        run.items[kept[slot]].pop(key)
                    kept[slot] = done
                else:
                    kept.append(done)
                rec.update(streams=streams, stats=stats(eng, len(streams)))
            run.items.append(rec)
            run.count("encoded_blocks",
                      sum(tracks.n_blocks(n) for n in got), in_trace)
            run.count("clips", len(streams), in_trace)
        except Exception as e:          # a call that never comes back
            print(f"call {k}: {type(e).__name__}: {e}", file=sys.stderr)
            run.failed += 1
        k += 1
        if in_trace and k >= traced_items:
            run.trace.stop()
        if time.perf_counter() - t0 >= run.seconds:
            break
    run.window_s = time.perf_counter() - t0
    run.info["captures_window"] = (eng.programs.captures
                                   - run.info["captures_setup"])
    if run.info["captures_window"]:
        run.info["captured_in_window"] = [
            str(key) for key in tracks.program_keys(eng)
            - st["keys_setup"]][:8]


def release(run) -> None:
    run.state.pop("eng", None)


def judge(run, tally, pool_map) -> None:
    import judge as J
    import wakref as R
    from harness.core import reference_config
    cfg = reference_config(R, run.config)
    ck = run.traffic["check"]
    rng = run.rng(2)
    for rec in (r for r in run.items if "streams" in r):
        calls, kept = rec["calls"], rec["stats"]
        n = len(calls)
        if kept[0] is None:             # the program kept the last file's
            picks = [n - 1]
        else:
            edges = np.linspace(0, n, min(n, ck["clips"]) + 1).astype(int)
            picks = [int(rng.integers(a, b))
                     for a, b in zip(edges[:-1], edges[1:])]
        for i in picks:
            p, s, m = calls[i]
            pcm = run.state["pool"][p][s:s + m]
            extras, measure = (kept[i] if isinstance(kept[i], tuple)
                               else (kept[i].extras, kept[i].measure))
            blocks = tracks.sample_blocks(tracks.n_blocks(m), ck["blocks"],
                                          rng)
            J.judge_reservoir_track(tally, cfg, pcm, rec["streams"][i],
                                    extras, measure, blocks, pool_map)
        tally.add("streams_judged", len(picks))
