"""The readers of the program's own spans (harness/program.py and the
metrics that use it) on synthetic spans and profiler events: their
arithmetic, and None where the program records no spans."""

import types

import pytest

from conftest import BENCH, ROOT
from harness import program
from harness.manifest import Manifest
from pactpu_torch.utils import metrics as M

PREFIX = "pactpu_torch:"
NEW = ("decode_staging_ms_per_kblock.roundtrip",
       "decode_wait_ms_per_kblock.roundtrip", "program_misses.roundtrip",
       "encode_host_ms_per_kblock.encode", "pageable_copy_pct.encode",
       "analysis_pad_pct.stream", "push_wait_ms_p50.stream",
       "analysis_device_ms_per_push.stream")


class S:
    """A recorded span as the program's recorder keeps it."""
    ids = iter(range(1, 10 ** 6))

    def __init__(self, name, t0, t1, parent=None, **counts):
        self.id = next(S.ids)
        self.name, self.counts = name, counts
        self.parent = None if parent is None else parent.id
        self.start_ns, self.end_ns = int(t0 * 1e6), int(t1 * 1e6)

    @property
    def ms(self):
        return (self.end_ns - self.start_ns) / 1e6


class Ev:
    """A profiler event: times in us."""

    def __init__(self, name, t0, t1, device="CPU", id=0, thread=1,
                 annotation=False):
        self.name, self.id, self.thread = name, id, thread
        self.device_type = types.SimpleNamespace(name=device)
        self.is_user_annotation = annotation
        self.time_range = types.SimpleNamespace(
            start=t0, end=t1, elapsed_us=lambda: t1 - t0)


def traced(monkeypatch, spans, events=(), window=(0.0, 1.0)):
    """A traced run whose window is `window` (s), and a recorder that
    holds `spans` (the program's own, its trace helpers included)."""
    fake = types.SimpleNamespace(**{**vars(M), "spans": lambda: spans})
    monkeypatch.setattr(program, "recorder", lambda: fake)
    prof = types.SimpleNamespace(events=lambda: list(events))
    return types.SimpleNamespace(trace=types.SimpleNamespace(
        t0=window[0], t1=window[1], prof=prof))


def read(name, run):
    return Manifest(ROOT, BENCH).reader(name).read(run)


def test_decode_staging_and_wait_split_the_decode(monkeypatch):
    d = S("decode", 0, 100, blocks=1500)
    d2 = S("decode", 200, 300, blocks=500)
    spans = [d, S("parse", 1, 41, d, bytes_in=9), S("repack", 41, 51, d),
             S("compact", 51, 60, d), S("download", 90, 95, d),
             S("assemble", 95, 99, d), d2, S("parse", 201, 251, d2),
             S("download", 290, 295, d2),
             S("encode", 400, 500, blocks=2000)]
    run = traced(monkeypatch, spans)
    staging = read("decode_staging_ms_per_kblock.roundtrip", run)
    wait = read("decode_wait_ms_per_kblock.roundtrip", run)
    assert staging == pytest.approx((100 - 55 + 100 - 55) / 2.0)
    assert wait == pytest.approx(10 / 2.0)
    # with the parse and repack time they are the decode's own
    assert staging + wait + (40 + 10 + 50) / 2.0 == pytest.approx(100.0)


def test_only_the_trace_windows_spans_are_read(monkeypatch):
    """Spans of an earlier run in the same process (before the window)
    and of a call still open at its end are left out."""
    old = S("decode", 0, 100, blocks=1000)
    d = S("decode", 200, 300, blocks=500)
    late = S("decode", 900, 1100, blocks=500)
    spans = [old, S("capture:decode", 5, 9, old), S("download", 10, 90, old),
             d, S("download", 210, 220, d), late,
             S("capture:decode", 905, 909, late),
             S("download", 910, 920, late)]
    run = traced(monkeypatch, spans, window=(0.15, 1.0))
    assert [s.name for s in program.traced_spans(run)] == [
        "decode", "download"]
    assert read("decode_wait_ms_per_kblock.roundtrip", run) == \
        pytest.approx(10 / 0.5)
    assert read("program_misses.roundtrip", run) == 0


def test_program_misses_count_captures_and_direct_runs(monkeypatch):
    e = S("encode", 0, 10, blocks=100)
    d = S("decode", 20, 30, blocks=100)
    spans = [e, S("analyze", 1, 2, e), S("replay:analyze", 1, 2, e),
             S("capture:final", 3, 4, e), d,
             S("direct:decode", 21, 22, d),
             S("capture:analyze", 40, 41)]        # outside any call
    assert read("program_misses.roundtrip",
                traced(monkeypatch, spans)) == 2
    assert read("program_misses.roundtrip",
                traced(monkeypatch, [e, S("replay:final", 1, 2, e)])) == 0
    assert read("program_misses.roundtrip",
                traced(monkeypatch, [])) is None


def test_encode_host_time_and_pageable_share(monkeypatch):
    e = S("encode", 0, 50, blocks=4000)
    f = S("frame", 30, 45, e)
    spans = [e, S("upload", 1, 3, e, bytes=100, pinned=0),
             S("download", 20, 30, e, bytes=200, pinned=1), f,
             S("download", 32, 34, f, bytes=100, pinned=1)]
    run = traced(monkeypatch, spans)
    assert read("encode_host_ms_per_kblock.encode", run) == pytest.approx(
        (50 - 12) / 4.0)
    assert read("pageable_copy_pct.encode", run) == pytest.approx(25.0)


def test_stream_padding_and_wait(monkeypatch):
    spans = []
    for k, (rows, real, dl, carry) in enumerate(
            ((512, 43, 1.0, 0.5), (1024, 44, 2.0, 0.0), (512, 43, 3.0, 1.0))):
        p = S("push", 100 * k, 100 * k + 50, blocks=real)
        spans += [p, S("analyze", 100 * k + 1, 100 * k + 10, p, rows=rows,
                       real_rows=real),
                  S("download", 100 * k + 20, 100 * k + 20 + dl, p,
                    bytes=8, pinned=0),
                  S("carry", 100 * k + 30, 100 * k + 30 + carry, p)]
    run = traced(monkeypatch, spans)
    assert read("analysis_pad_pct.stream", run) == pytest.approx(
        100.0 * (2048 - 130) / 2048)
    assert read("push_wait_ms_p50.stream", run) == pytest.approx(2.0)


def test_analysis_device_time_by_correlation(monkeypatch):
    events = [
        Ev(PREFIX + "push", 0, 100), Ev(PREFIX + "analyze", 10, 50),
        Ev("cudaGraphLaunch", 20, 21, id=7),
        Ev("cudaMemcpyAsync", 30, 31, id=9),
        Ev("cudaLaunchKernel", 60, 61, id=8),      # after the analysis
        Ev("cudaLaunchKernel", 40, 41, id=10, thread=2),  # another thread
        Ev("k_a", 25, 55, "CUDA", id=7), Ev("k_b", 55, 60, "CUDA", id=7),
        Ev("Memcpy HtoD", 35, 37, "CUDA", id=9),
        Ev("k_c", 70, 170, "CUDA", id=8), Ev("k_d", 40, 90, "CUDA", id=10),
        Ev(PREFIX + "push", 200, 300),
        Ev("pb:push", 0, 300, "CUDA", annotation=True)]
    run = traced(monkeypatch, [], events)
    assert read("analysis_device_ms_per_push.stream", run) == pytest.approx(
        (30 + 5 + 2) / 1e3 / 2)


@pytest.mark.parametrize("name", NEW)
def test_a_program_without_spans_reads_none(monkeypatch, name):
    monkeypatch.setattr(program, "recorder", lambda: None)
    run = types.SimpleNamespace(trace=types.SimpleNamespace(
        t0=0.0, t1=1.0, prof=types.SimpleNamespace(events=lambda: [
            Ev("pb:push", 0, 10), Ev("k", 1, 2, "CUDA", id=3)])))
    assert read(name, run) is None
    assert read(name, types.SimpleNamespace(trace=None)) is None


def test_idle_time_by_the_innermost_range():
    ranges = [(0, 100, "push"), (10, 40, "analyze"), (15, 20, "replay"),
              (60, 90, "download")]
    pieces = M.innermost(ranges)
    assert pieces == [(0, 10, "push"), (10, 15, "analyze"),
                      (15, 20, "replay"), (20, 40, "analyze"),
                      (40, 60, "push"), (60, 90, "download"),
                      (90, 100, "push")]
    events = [Ev("k", 0, 12, "CUDA", id=1), Ev("k", 18, 50, "CUDA", id=2),
              Ev("k", 70, 80, "CUDA", id=3), Ev("k", 130, 140, "CUDA", id=4),
              Ev("pb:push", 0, 140, "CUDA", annotation=True)]
    gaps = M.idle_gaps(events, (program.BENCH_PREFIX,))
    assert gaps == [(12, 18), (50, 70), (80, 130)]
    idle = M.idle_by_range(gaps, pieces)
    assert idle == pytest.approx({"analyze": 3e-6, "replay": 3e-6,
                                  "push": 20e-6, "download": 20e-6,
                                  "outside": 30e-6})
