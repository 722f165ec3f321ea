"""Closed loop over whole spoken-word episodes, one client: `Engine.encode`
of each episode, then `Engine.decode` of its stream (a podcast or
audiobook platform transcoding each upload to its speech tier and
verifying it).

Traffic keys: lengths (median_s, sigma, count: the episodes are the
count quantiles of a lognormal, unclipped, every seed the same set in
its own order), pool (synthetic speakers, each as long as the longest
episode; episode k is cut from a speaker and at an offset drawn from the
seed and k), speech (the generator's parameters, harness/speech.py),
trace_items (episodes inside the device trace), check (episodes, blocks,
decode_blocks: what the reference judges).

The episodes take the configuration's channels and rate (mono at 22.05
kHz for wak-mono-22k).  Set-up warms every chunk shape of the window's
episodes, encode and decode, and the decode's programs for the first two
of the host route's upload layouts with crafted streams of the
configuration, so that no program is captured in the window.  The judge
is the tracks' (harness/tracks.py), on the window's longest episode and
a sample of the others drawn from the seed (the loop keeps their
outputs alone: class Keeper), with three more kinds of sampled block:
the reservoir replay over every block of each judged episode, block 0,
the flush block and both sides of the first chunk boundary (those of the
longest episode among them), and one block inside the episode's longest
pause and the first two blocks of the spurt after it, where the
reservoir lends most.
"""

from __future__ import annotations

import sys
import time

import numpy as np

from harness import speech, synth, tracks

CHUNK = tracks.CHUNK
# the words of a crafted stream's widest row: the first and the second
# upload layout of the host route (engine._decode_layouts: rows of up to
# 128 and of up to 256 words)
DECODE_WORDS = (96, 192)
HALF = 1024                      # samples a block (the MDCT's lines)


def crafted_stream(cfg, b: int, words: int) -> bytes:
    """A .wak stream of cfg's header and b silent blocks whose first
    channel-block spends `words` 32-bit words of mantissa bits (the same
    bits on every line of the bands that have lines) and every other one
    64: it makes the decode capture its program for this block count's
    chunks in the layout of that row width."""
    import wakref as R
    lay = cfg.band_layout
    nl = np.asarray(lay.n_lines, np.int64)
    tabs = R.HuffmanTables.load()

    def block(first: int) -> bytes:
        blk = R.EncodedBlock([0] * cfg.n_channels, [], [], [], [], [], [],
                             np.zeros(lay.n_bands, np.int64))
        for c in range(cfg.n_channels):
            v = first if c == 0 else 2
            alloc = np.where(nl > 0, v, 0).astype(np.int64)
            line_bits = np.repeat(alloc, nl)
            tid, codes, lens = tabs.encode_best(
                np.zeros(line_bits.size, np.int64), line_bits)
            blk.table_id.append(tid)
            blk.bit_alloc.append(alloc)
            blk.scale_factor.append(np.zeros(lay.n_bands, np.int64))
            blk.sign_bits.append(np.zeros(line_bits.size, np.int64))
            blk.huff_codes.append(codes)
            blk.huff_lengths.append(lens)
        return R.pack_block(blk, cfg)
    head, _ = R.write_header(cfg, (b - 1) * HALF - 7)
    return head + block(words * 32 // HALF) + block(2) * (b - 1)


def placement(run, k: int, n: int) -> tuple:
    """(speaker, first sample) of episode k, n samples long: drawn from
    the seed and k, so every run of a seed cuts the same episodes."""
    rng = np.random.default_rng([run.seed & ((1 << 64) - 1), 3, k])
    pool = run.state["pool"]
    p = int(rng.integers(0, pool.shape[0]))
    return p, int(rng.integers(0, pool.shape[1] - n + 1))


def prepare(run) -> None:
    import wakref as R
    from harness.core import reference_config
    tr = run.traffic
    ln = tr["lengths"]
    fs = int(run.config.get("codec", {}).get("sample_rate", synth.FS))
    secs = synth.lognormal_lengths(ln["median_s"], ln["sigma"], 0.0,
                                   float("inf"), ln["count"])
    sizes = (secs * fs).astype(np.int64)
    order = run.rng(1).permutation(len(sizes))
    pool, spurts = speech.speaker_pool(run.torch, run.seed, tr["pool"],
                                       tr["speech"], float(sizes.max()) / fs,
                                       fs, run.device)
    eng = tracks.make_engine(run)
    if run.traced:
        from pactpu_torch import native
        run.spans.wrap(native, "unpack_file", "native.unpack_file")
        run.spans.wrap(native, "repack_codes", "native.repack_codes")
    run.state.update(eng=eng, sizes=sizes, order=order, pool=pool,
                     spurts=spurts, decode=True)
    warm = {}
    for n in sizes:
        b = tracks.n_blocks(int(n))
        tail = b % CHUNK or CHUNK
        if b > CHUNK:
            warm.setdefault(tracks.bucket(tail), CHUNK + tail)
        else:
            warm.setdefault(("short", tracks.pad(b)), b)
    cfg = reference_config(R, run.config)
    for k, b in enumerate(sorted(warm.values())):
        x = pool[k % len(pool)][:(b - 1) * HALF - 7, None]
        tracks.item(run, x, warm=True)
        for words in DECODE_WORDS:
            eng.decode(crafted_stream(cfg, b, words))
    run.info["warm_files"] = len(warm)
    run.info["captures_setup"] = eng.programs.captures
    run.state["keys_setup"] = tracks.program_keys(eng)


def window(run) -> None:
    st = run.state
    sizes, order, pool = st["sizes"], st["order"], st["pool"]
    traced_items = run.traffic.get("trace_items", 0)
    keeper = Keeper(run)
    if run.trace is not None:
        run.trace.start()
    t0 = time.perf_counter()
    k = 0
    while True:
        n = int(sizes[int(order[k % len(order)])])
        p, off = placement(run, k, n)
        in_trace = run.trace is not None and run.trace.on
        run.attempted += 1
        try:
            rec = tracks.item(run, pool[p][off:off + n, None])
        except Exception as e:          # an episode that never comes back
            print(f"episode {k}: {type(e).__name__}: {e}", file=sys.stderr)
            run.failed += 1
            rec = None
        if rec is not None:
            rec.update(k=k, pool=p, off=off, traced=in_trace)
            run.items.append(rec)
            keeper.take(len(run.items) - 1)
            run.count("encoded_blocks", rec["blocks"], in_trace)
            run.count("episodes", 1, in_trace)
        k += 1
        if in_trace and k >= traced_items:
            run.trace.stop()
        if time.perf_counter() - t0 >= run.seconds:
            break
    run.window_s = time.perf_counter() - t0
    st["judged"] = keeper.judged()
    run.info["captures_window"] = (st["eng"].programs.captures
                                   - run.info["captures_setup"])
    if run.info["captures_window"]:
        run.info["captured_in_window"] = [
            str(x) for x in tracks.program_keys(st["eng"])
            - st["keys_setup"]][:8]
    traced_totals(run)


class Keeper:
    """What the judge reads of an episode (its stream, decoded PCM and
    reservoir state: hundreds of MB for an hour) is kept for the longest
    episode so far and for a sample of check["episodes"] - 1 of the
    others drawn from the seed as the window runs (reservoir sampling),
    and dropped for the rest as soon as they end."""

    DROP = ("stream", "out", "extras", "measure")

    def __init__(self, run):
        self.run = run
        self.rng = run.rng(4)
        self.n = run.traffic["check"]["episodes"] - 1
        self.sample: list = []
        self.longest = None
        self.seen = 0

    def drop(self, i: int) -> None:
        for key in self.DROP:
            self.run.items[i].pop(key, None)

    def take(self, i: int) -> None:
        items = self.run.items
        if self.longest is None:
            self.longest = i
            return
        if items[i]["n"] > items[self.longest]["n"]:
            # the longest so far joins the others' draw
            i, self.longest = self.longest, i
        slot = (self.seen if self.seen < self.n
                else int(self.rng.integers(0, self.seen + 1)))
        self.seen += 1
        if slot >= self.n:
            self.drop(i)
        elif slot < len(self.sample):
            self.drop(self.sample[slot])
            self.sample[slot] = i
        else:
            self.sample.append(i)

    def judged(self) -> list:
        """The longest episode, then the sample."""
        return ([] if self.longest is None else [self.longest]) \
            + self.sample


def traced_totals(run) -> None:
    """The counts of the program's spans in the traced part that no
    metric reads (the parse's route, the replays' blocks, the final
    pass's width), for the run's info."""
    from harness import program
    m = program.recorder()
    spans = program.traced_spans(run)
    if m is None or not spans:
        return
    tot = m.totals(spans)
    run.info["traced_spans"] = {
        k: {c: v for c, v in tot[k].items() if c != "host_s"}
        for k in ("parse", "repack", "final", "frame", "rate",
                  "replay:analyze", "replay:decode") if k in tot}


release = tracks.release


def pause_blocks(spurts: np.ndarray, off: int, n: int, nb: int) -> list:
    """Blocks of the episode [off, off + n) of a speaker whose spurts are
    `spurts`: the block at the middle of its longest whole pause and the
    first two blocks of the spurt after it (block i frames the samples
    [(i - 1) * 1024, (i + 1) * 1024) of the episode)."""
    s = spurts[(spurts[:, 1] > off) & (spurts[:, 0] < off + n)] - off
    gaps = [(int(b), int(a)) for (_, b), (a, _) in zip(s[:-1], s[1:])
            if b >= 0 and a <= n]
    if not gaps:
        return []
    lo, hi = max(gaps, key=lambda g: g[1] - g[0])
    out = {(lo + hi) // 2 // HALF, hi // HALF, hi // HALF + 1}
    return sorted(b for b in out if 0 <= b < nb)


def judge(run, tally, pool_map) -> None:
    import bands
    with bands.judging():
        judge_episodes(run, tally, pool_map)


def judge_episodes(run, tally, pool_map) -> None:
    import judge as J
    import wakref as R
    from harness.core import reference_config
    cfg = reference_config(R, run.config)
    ck = run.traffic["check"]
    rng = run.rng(2)
    done = run.items
    pick = run.state.get("judged", [])
    pauses = []
    for i in pick:
        rec = done[i]
        pcm = run.state["pool"][rec["pool"]][rec["off"]:rec["off"]
                                             + rec["n"], None]
        nb = rec["blocks"]
        quiet = pause_blocks(run.state["spurts"][rec["pool"]], rec["off"],
                             rec["n"], nb)
        pauses.append(quiet)
        blocks = sorted(set(tracks.sample_blocks(nb, ck["blocks"], rng))
                        | set(quiet))
        J.judge_reservoir_track(tally, cfg, pcm, rec["stream"],
                                rec["extras"], rec["measure"], blocks,
                                pool_map)
        outs = sorted(set([0, nb - 2] + [b for b in quiet if b < nb - 1]
                          + list(rng.choice(nb - 1, min(
                              nb - 1, ck["decode_blocks"]),
                              replace=False))))
        J.judge_decode(tally, cfg, rec["stream"], rec["out"],
                       [int(j) for j in outs])
    tally.add("streams_judged", len(pick))
    run.info["pause_blocks"] = pauses
