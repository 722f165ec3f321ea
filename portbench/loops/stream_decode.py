"""Open loop of streamed decodes: S `StreamingDecoder`s, each taking the
bytes of its stream's next push_blocks blocks once every push period
(push_blocks * 1,024 samples at the stream's rate), the header with the
first; their phases evenly spread over the period and dealt to the
decoders by the seed (every seed offers the same arrivals); one server
thread takes the pushes in due order.  A push's latency runs from its
due time to its PCM returned, so a stall delays every push due after
it; the benchmark's span "push" times each call, queue wait excluded
(push_service_ms_p50.stream reads it over the whole window).  A decoder whose stream has no bytes left flushes in its next slot
and then stops.  (A relay that decodes each listener's stream to PCM as
it arrives, to mix or re-encode it.)

Traffic keys: streams (S), push_blocks, pool (distinct streams, coded
once in set-up by Engine.encode from the tracks' synthetic music;
decoder s reads stream s mod pool), stream_blocks (each stream's blocks,
a multiple of the Engine's 512-block chunk, so that one program size
synthesizes every push), warm_pushes (pushes each decoder takes in
set-up, the first with the header: it captures the decoder's programs),
ending (streams: decoders dealt by the seed that set-up takes to within
`pushes` pushes of their stream's end, so that their last pushes and
their flush fall in the window), trace_seconds, check (decoders: the
decoders whose every output is kept for the judge, drawn from the
seed besides one of the ending ones).

The judge decodes sampled pushes of the kept decoders with the
reference decoder on the same bytes (pcm_err_lsb, as the tracks hold
the decode): a decoder's first push in the window, its push across the
stream's first chunk boundary, and an ending decoder's last push, whose
flush must bring the output to the header's sample count; and checks
that each kept decoder's outputs joined equal Engine.decode of its
stream sample for sample (joined_gap_lsb: the widest gap, 65,536 where
the joined output has another length than its pushes give).
"""

from __future__ import annotations

import sys
import time

import numpy as np

from harness import synth, tracks

HALF = 1024


def prepare(run) -> None:
    import judge as J
    import wakref as R
    from pactpu_torch import CodecConfig, StreamingDecoder
    tr = run.traffic
    s_count = int(tr["streams"])
    per = int(tr["push_blocks"])
    length = int(tr["stream_blocks"])
    cfg = CodecConfig(**run.config.get("codec", {}))
    n = (length - 1) * HALF - 7
    pool = synth.track_pool(run.torch, run.seed, tr["pool"],
                            n / synth.FS + 0.001, run.device)
    eng = tracks.make_engine(run)
    streams = [eng.encode(pool[q][:n]) for q in range(tr["pool"])]
    want = [eng.decode(s)[1] for s in streams]
    del eng
    # each push's bytes: the header with the first push's blocks
    cuts = []
    for s in streams:
        _, _, start = R.read_header(s)
        offs = J.block_offsets(s, start, cfg.n_channels)
        edge = [0] + [int(offs[k]) for k in range(per, length, per)] \
            + [len(s)]
        cuts.append(edge)
    rng = run.rng(1)
    end = tr["ending"]
    ending = set(int(s) for s in rng.choice(
        s_count, min(s_count, end["streams"]), replace=False))
    kept = set(int(s) for s in rng.choice(
        sorted(set(range(s_count)) - ending),
        min(s_count - len(ending), tr["check"]["decoders"]),
        replace=False))
    if ending:
        kept.add(min(ending))
    phases = rng.permutation((np.arange(s_count) + 0.5) / s_count) \
        * (per * HALF / cfg.sample_rate)
    decs = [StreamingDecoder(chunk_blocks=per, window=cfg.window,
                             device=run.device) for _ in range(s_count)]
    run.state.update(decs=decs, streams=streams, want=want, cuts=cuts,
                     phases=phases, period=per * HALF / cfg.sample_rate,
                     length=length, sent=[0] * s_count,
                     done=[False] * s_count, kept=kept, ending=ending,
                     outs={s: [] for s in kept}, n_samples=n)
    total = len(cuts[0]) - 1
    for s in range(s_count):
        warm = (total - int(end["pushes"]) if s in ending
                else int(tr["warm_pushes"]))
        for _ in range(max(0, warm)):
            serve(run, s)
    run.spans.ms.clear()


def serve(run, s: int) -> None:
    """Decoder s's next call: its next push, or its flush once its
    stream's bytes are all pushed."""
    st = run.state
    q = s % len(st["streams"])
    k = st["sent"][s]
    cut = st["cuts"][q]
    dec = st["decs"][s]
    with run.spans.span("push"):
        if k < len(cut) - 1:
            out = dec.push(st["streams"][q][cut[k]:cut[k + 1]])
        else:
            out = dec.flush()
            st["done"][s] = True
    if s in st["kept"]:
        st["outs"][s].append((k, out))
    st["sent"][s] = k + 1


def window(run) -> None:
    st = run.state
    decs, period = st["decs"], st["period"]
    due = [(st["phases"][s] + i * period, s)
           for i in range(int(np.ceil(run.seconds / period)) + 1)
           for s in range(len(decs))]
    due = sorted(d for d in due if d[0] < run.seconds)
    trace_s = run.traffic.get("trace_seconds", 0)
    if run.trace is not None:
        run.trace.start()
    t0 = time.perf_counter()
    late = 0.0
    for i, (t_due, s) in enumerate(due):
        if st["done"][s]:
            continue
        now = time.perf_counter() - t0
        if now < t_due:
            time.sleep(t_due - now)
        late = max(late, time.perf_counter() - t0 - t_due)
        in_trace = run.trace is not None and run.trace.on
        run.attempted += 1
        try:
            serve(run, s)
        except Exception as e:       # a push whose PCM never comes
            print(f"push {i}: {type(e).__name__}: {e}", file=sys.stderr)
            run.failed += 1
            continue
        done = time.perf_counter() - t0
        run.latency_ms.append((done - t_due) * 1e3)
        run.count("pushes", 1, in_trace)
        if in_trace and done >= trace_s:
            run.trace.stop()
    run.window_s = time.perf_counter() - t0
    run.info["late_s_max"] = late
    run.info["streams"] = len(decs)
    run.info["flushed"] = int(sum(st["done"]))


def release(run) -> None:
    run.state.pop("decs", None)


def emitted(k: int, per: int, length: int, n: int) -> tuple:
    """The samples [lo, hi) that push k of a stream of `length` blocks
    (k = length / per: the flush) gives: its blocks' output blocks, the
    stream's first skipped, trimmed to the header's n."""
    first = max(0, k * per - 1)
    last = min(length, (k + 1) * per) - 1
    if k * per >= length:
        first, last = length - 1, length
    return min(first * HALF, n), min(last * HALF, n)


def judge(run, tally, pool_map) -> None:
    import judge as J
    import wakref as R
    from harness.core import reference_config
    cfg = reference_config(R, run.config)
    st = run.state
    per = int(run.traffic["push_blocks"])
    n = st["n_samples"]
    warm = int(run.traffic["warm_pushes"])
    length = st["length"]
    for s in sorted(st["kept"]):
        q = s % len(st["streams"])
        stream, want = st["streams"][q], st["want"][q]
        pushes = len(st["cuts"][q]) - 1
        outs = st["outs"][s]
        # the decoder's outputs joined, against Engine.decode
        got = (np.concatenate([o for _, o in outs]) if outs
               else np.zeros((0, cfg.n_channels), np.int16))
        hi = emitted(outs[-1][0], per, length, n)[1] if outs else 0
        if got.shape[0] != hi:
            gap = 1 << 16
        else:
            gap = float(np.abs(got.astype(np.int32)
                               - want[:hi].astype(np.int32)).max(
                                   initial=0))
        tally.high("joined_gap_lsb", gap)
        # sampled pushes: the first in the window, the one across the
        # first chunk boundary, an ending decoder's last and its flush
        picks = {k for k, _ in outs if k == warm or k * per == tracks.CHUNK
                 or (s in st["ending"] and k >= pushes - 1)}
        full = np.zeros((n, cfg.n_channels), np.int16)
        blocks = []
        for k, out in outs:
            if k not in picks:
                continue
            lo, hi = emitted(k, per, length, n)
            if out.shape[0] != hi - lo:
                tally.high("pcm_err_lsb", 1 << 16)
                continue
            full[lo:hi] = out
            if hi > lo:
                blocks += range(lo // HALF, -(-hi // HALF))
        J.judge_decode(tally, cfg, stream, full, sorted(set(blocks)))
        tally.add("streams_judged")
