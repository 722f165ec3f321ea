"""The port's own spans (pactpu_torch.utils.metrics.span): nothing
recorded with recording off; an Engine's encode and decode and a stream's
push recorded as their span trees under metrics.tracing() and under a
torch.profiler, each span a profiler range of the same nesting; the
counts (rows analysed, bytes copied); the same bytes and samples with
recording on and off; StageTimer's stages as spans; the bounded buffer
and the per-thread stacks."""

import sys
import threading

import numpy as np
import pytest
from torch.profiler import ProfilerActivity, profile

from pactpu_torch import Engine, StreamingEncoder
from pactpu_torch.codec import engine as E
from pactpu_torch.codec.header import write_header
from pactpu_torch.utils import metrics as M
from torch_threads import torch_threads  # noqa: F401 (autouse)

N = 1024
C = 2
PROGRAMME = 3600 * 44100

# each call's spans in start order, as (parent, span); on the CPU every
# chunk stage runs directly
TREES = {
    "encode": [
        ("encode", "upload"), ("encode", "analyze"),
        ("analyze", "direct:analyze"), ("encode", "rate"),
        ("rate", "direct:measure"), ("encode", "final"),
        ("final", "direct:final"), ("encode", "download"),
        ("encode", "frame"), ("encode", "release")],
    "decode": [
        ("decode", "parse"), ("decode", "repack"), ("decode", "compact"),
        ("decode", "upload"), ("decode", "queue"),
        ("queue", "direct:decode"), ("decode", "download"),
        ("decode", "assemble")],
    "push": [
        ("push", "upload"), ("push", "analyze"),
        ("analyze", "direct:analyze"), ("push", "rate"),
        ("rate", "direct:measure"), ("push", "final"),
        ("final", "direct:final"), ("push", "download"),
        ("push", "frame"), ("push", "carry"), ("push", "release")],
}


def tone(n: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    t = np.arange(n)[:, None]
    x = (6000 * np.sin(2 * np.pi * 440 * t / 44100.0)
         + rng.normal(0, 600, (n, C)))
    return np.clip(x, -32767, 32767).astype(np.int16)


@pytest.fixture(scope="module")
def inputs():
    return tone(5 * N, 1), tone(44100, 2)


def run_calls(pcm, piece, rate_mode="reservoir", programme=PROGRAMME):
    """An encode, its decode and a push of `piece` into a programme of
    `programme` samples, and the spans each recorded (calls in that
    order)."""
    eng = Engine(device="cpu", rate_mode=rate_mode)
    enc = StreamingEncoder(device="cpu", rate_mode=rate_mode)
    enc.header(programme)
    out = {}
    M.reset()
    out["encode"] = eng.encode(pcm)
    out["decode"] = eng.decode(out["encode"])[1]
    out["push"] = enc.push(piece)
    return out, M.spans()


@pytest.fixture(scope="module")
def runs(inputs):
    """Each mode's outputs, spans and (under the profiler) the profiler's
    ranges of the program's spans, [(name, start_ns, end_ns, thread)] by
    start.  Under the profiler the calls run in cbr, a push of 5 blocks
    into a 6-block programme: the profiler records every operator of the
    kernels' plain versions, and the reservoir's and a 512-row batch's
    would take it seconds."""
    pcm, piece = inputs
    got = {"off": run_calls(pcm, piece) + (None,),
           "off-cbr": run_calls(pcm, pcm, "cbr", 6 * N) + (None,)}
    with M.tracing():
        got["tracing"] = run_calls(pcm, piece) + (None,)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out, spans = run_calls(pcm, pcm, "cbr", 6 * N)
    ranges = sorted(((e.name(), e.start_ns(), e.end_ns(),
                      e.start_thread_id())
                     for e in prof.profiler.kineto_results.events()
                     if e.name().startswith(M.PREFIX)), key=lambda r: r[1])
    got["profiler"] = (out, spans, ranges)
    M.reset()
    return got


def by_call(spans):
    """{root name: (root, [its spans in start order])}."""
    by_id = {s.id: s for s in spans}
    out = {}
    for s in spans:
        r = s
        while r.parent is not None:
            r = by_id[r.parent]
        out.setdefault(r.name, (r, []))
        if r is not s:
            out[r.name][1].append(s)
    return out


def test_off_records_nothing(runs):
    assert runs["off"][1] == []
    assert M.dropped() == 0
    with M.span("x", blocks=1) as sp:
        assert sp is None
    assert M.span("a") is M.span("b")
    assert M.spans() == []


@pytest.mark.parametrize("mode", ["tracing", "profiler"])
@pytest.mark.parametrize("call", ["encode", "decode", "push"])
def test_each_call_records_its_span_tree(runs, mode, call):
    spans = runs[mode][1]
    calls = by_call(spans)
    assert set(calls) == {"encode", "decode", "push"}
    root, under = calls[call]
    by_id = {s.id: s for s in spans}
    # cbr (under the profiler) has no measurement pass and no carry
    tree = [e for e in TREES[call] if mode == "tracing"
            or e not in (("rate", "direct:measure"), ("push", "carry"))]
    assert [(by_id[s.parent].name, s.name) for s in under] == tree
    for s in under:
        p = by_id[s.parent]
        assert p.start_ns <= s.start_ns <= s.end_ns <= p.end_ns
        assert s.request == root.request
        assert s.thread == root.thread == threading.get_ident()
    assert len({r.request for r, _ in calls.values()}) == 3
    # a 1 s push into a 1 h programme: 43 or 44 blocks at their rows of
    # one 512-row batch; the encode's 6 blocks in a 16-row batch
    analyze = next(s for s in under if s.name == "analyze"
                   ) if call != "decode" else None
    if call == "push" and mode == "tracing":
        assert root.counts == {"blocks": 43}
        assert analyze.counts["rows"] == 512
        assert analyze.counts["real_rows"] in (43, 44)
    elif call == "push":
        assert root.counts == {"blocks": 5}
        assert analyze.counts == {"rows": 16, "real_rows": 5}
    elif call == "encode":
        assert root.counts == {"blocks": 6}
        assert analyze.counts == {"rows": 16, "real_rows": 6}
    else:
        assert root.counts == {"blocks": 6}
    for s in under:
        if s.name.startswith("direct:"):
            assert s.counts["blocks"] in (16, 64, 512)


def test_each_span_is_one_profiler_range_of_the_same_nesting(runs):
    _, spans, ranges = runs["profiler"]
    assert [r[0] for r in ranges] == [M.PREFIX + s.name for s in spans]
    assert len({r[3] for r in ranges}) == 1          # one thread
    by_id = {s.id: k for k, s in enumerate(spans)}

    def enclosing(k):
        """The innermost earlier range that holds range k."""
        return next((j for j in range(k - 1, -1, -1)
                     if ranges[j][2] >= ranges[k][2]), None)

    assert [enclosing(k) for k in range(len(ranges))] == [
        None if s.parent is None else by_id[s.parent] for s in spans]


@pytest.mark.parametrize("mode", ["tracing", "profiler"])
def test_copies_count_the_arrays_bytes(runs, inputs, mode):
    pcm, piece = inputs
    calls = by_call(runs[mode][1])
    dense = E.PACK_DENSE_WORDS + 1                 # words a row, + nbits

    def one(call, name):
        s = [s for s in calls[call][1] if s.name == name]
        assert len(s) == 1 and s[0].counts["pinned"] == 0
        return s[0].counts["bytes"]

    b = 6                                           # 5 blocks + flush
    assert one("encode", "upload") == C * (16 + 1) * N * 2
    assert one("encode", "download") == 16 * C * dense * 4
    assert one("decode", "upload") == (
        16 * C * 25 * 2 + 16 * C * E.PACK_DENSE_WORDS * 4 + 16 * C
        + 16 * 25)
    assert one("decode", "download") == b * C * N * 2  # the delay row dropped
    if mode == "profiler":                          # 5 blocks a push
        assert one("push", "upload") == C * (5 + 1) * N * 2
        assert one("push", "download") == 16 * C * dense * 4
    else:
        m = piece.shape[0] // N
        assert one("push", "upload") == C * (m + 1) * N * 2
        assert one("push", "download") == 64 * C * dense * 4


def test_bytes_and_samples_are_the_same_on_and_off(runs):
    for mode, base in (("tracing", "off"), ("profiler", "off-cbr")):
        out, off = runs[mode][0], runs[base][0]
        assert out["encode"] == off["encode"]
        assert np.array_equal(out["decode"], off["decode"])
        assert out["push"] == off["push"]


@pytest.mark.parametrize("api", ["many", "roundtrip_many"])
def test_each_half_of_a_many_file_call_is_a_root(inputs, api):
    """encode_many, decode_many and roundtrip_many: each file's staged
    half is a root span of its blocks, its finishing half a root span of
    0 blocks, each root a request of its own; metrics.totals sums their
    counts."""
    pcm, _ = inputs
    eng = Engine(device="cpu", rate_mode="cbr")
    header = len(write_header(eng.cfg, pcm.shape[0])[0])
    M.reset()
    with M.tracing():
        if api == "many":
            streams = eng.encode_many([pcm, pcm])
            pcms = eng.decode_many(streams)
        else:
            pcms, streams = eng.roundtrip_many([pcm, pcm],
                                               return_streams=True)
    spans = M.spans()
    M.reset()
    roots = [s for s in spans if s.parent is None]
    if api == "many":
        order = [("encode", 6)] * 2 + [("encode", 0)] * 2 + [
            ("decode", 6)] * 2 + [("decode", 0)] * 2
    else:
        order = [("encode", 6)] * 2 + [("encode", 0), ("decode", 6)] * 2 + [
            ("decode", 0)] * 2
    assert [(s.name, s.counts["blocks"]) for s in roots] == order
    assert len({s.request for s in roots}) == 8
    tot = M.totals(spans)
    assert (tot["encode"]["calls"], tot["encode"]["blocks"]) == (4, 12)
    assert (tot["decode"]["calls"], tot["decode"]["blocks"]) == (4, 12)
    assert tot["frame"]["bytes_out"] == sum(len(x) - header
                                            for x in streams)
    assert (tot["frame"]["wide"], tot["frame"]["padded"]) == (0, 0)
    assert tot["download"]["pinned"] == tot["upload"]["pinned"] == 0
    assert tot["assemble"]["samples"] == sum(len(x) for _, x in pcms)
    assert tot["frame"]["host_s"] == pytest.approx(
        sum(s.ms for s in spans if s.name == "frame") / 1e3)


def test_stage_timer_report_and_its_stages_as_spans(inputs):
    pcm, _ = inputs
    eng = Engine(device="cpu", rate_mode="cbr")
    t = M.StageTimer()
    M.reset()
    with t.stage("job"):
        pass
    assert M.spans() == []                          # off: no span
    with M.tracing():
        with t.stage("job"):
            eng.encode(pcm)
    rep = t.report()
    assert list(rep) == ["job"] and rep["job"]["calls"] == 2
    assert set(rep["job"]) == {"total_s", "calls"}
    spans = M.spans()
    M.reset()
    job, enc = spans[0], spans[1]
    assert (job.name, job.parent, enc.name, enc.parent) == (
        "job", None, "encode", job.id)
    assert {s.request for s in spans} == {job.request}


def test_the_buffer_is_bounded_and_counts_what_it_drops(monkeypatch):
    monkeypatch.setattr(M, "MAX_SPANS", 3)
    M.reset()
    with M.tracing():
        for _ in range(5):
            with M.span("x", rows=1):
                pass
    assert len(M.spans()) == 3 and M.dropped() == 2
    M.reset()
    assert M.spans() == [] and M.dropped() == 0


def test_each_thread_keeps_its_own_stack():
    M.reset()
    go = threading.Barrier(2)

    def work(name):
        with M.span(name):
            go.wait()
            with M.span(name + ".child"):
                go.wait()

    with M.tracing():
        ts = [threading.Thread(target=work, args=(n,)) for n in "ab"]
        for t in ts:
            t.start()
        for t in ts:
            t.join()
    spans = {s.name: s for s in M.spans()}
    M.reset()
    for n in "ab":
        assert spans[n].parent is None
        assert spans[n + ".child"].parent == spans[n].id
        assert spans[n + ".child"].request == spans[n].request
    assert spans["a"].request != spans["b"].request


def test_threads_lose_no_span_and_no_drop(monkeypatch):
    """16 threads record nested spans against a buffer that fills: every
    span is kept or counted as dropped, and each keeps its thread's
    parent."""
    monkeypatch.setattr(M, "MAX_SPANS", 1000)
    M.reset()
    per = 200
    saved = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work():
            for _ in range(per // 2):
                with M.span("outer"):
                    with M.span("inner"):
                        pass

        with M.tracing():
            ts = [threading.Thread(target=work) for _ in range(16)]
            for t in ts:
                t.start()
            for t in ts:
                t.join(timeout=60)
        assert not any(t.is_alive() for t in ts)
    finally:
        sys.setswitchinterval(saved)
    spans = M.spans()
    assert len(spans) == 1000 and M.dropped() == 16 * per - 1000
    by_id = {s.id: s for s in spans}
    for s in spans:
        if s.name == "inner" and s.parent in by_id:
            p = by_id[s.parent]
            assert (p.name, p.thread, p.request) == ("outer", s.thread,
                                                     s.request)
    M.reset()
