"""The cells wak-mono-22k.podcast and wak-default.stream-decode: the
frozen reference at 22.05 kHz mono against the port's oracle (with its
reading of the bands of no lines, reference/bands.py), the speech
generator, both loops at tiny sizes on the CPU (a mono episode with an
altered mantissa, and a decoder's pushes with a block dropped or
repeated, come out not correct), and the new readers over recorded spans
and profiler events."""

import json
import os

import numpy as np
import pytest
import torch

import bands
import judge as J
import tiny
import wakref as R
from conftest import BENCH, ROOT
from harness import controls, core, speech
from harness.manifest import Manifest
from pactpu_torch.compat import refcodec
from pactpu_torch.utils.config import CodecConfig
from test_pb_program import PREFIX, S, Ev, read, traced
from test_pb_reference import clip

FS = 22050
CELLS = ("wak-mono-22k.podcast", "wak-default.stream-decode")
P = json.load(open(os.path.join(BENCH, "traffic", "podcast.json")))["speech"]
TINY = {
    "wak-mono-22k.tiny-podcast": ("wak-mono-22k", {
        **json.load(open(os.path.join(BENCH, "traffic", "podcast.json"))),
        "lengths": {"median_s": 6.0, "sigma": 0.3, "count": 2},
        "speech": {**P, "spurt_s": [1.0, 2.0]},
        "pool": 2, "check": {"episodes": 2, "blocks": 6,
                             "decode_blocks": 4}},
        "wak-mono-22k.podcast"),
    "wak-default.tiny-stream-decode": ("wak-default", {
        **json.load(open(os.path.join(BENCH, "traffic",
                                      "stream-decode.json"))),
        "streams": 3, "stream_blocks": 48, "pool": 2,
        "ending": {"streams": 1, "pushes": 1}},
        "wak-default.stream-decode")}


@pytest.fixture(scope="module")
def voices():
    return speech.speaker_pool(torch, 2 ** 35 + 9, 2, P, 20.0, FS, "cpu")


def test_frozen_reference_is_the_oracle_at_22k_mono(voices):
    pcm = voices[0][0][:30_000, None]
    cfg = CodecConfig(sample_rate=FS, n_channels=1)
    oracle = refcodec.encode_file(pcm, FS, cfg)
    with pytest.raises(ValueError):      # a maximum over no lines
        R.encode_file(pcm, FS, R.CodecConfig(sample_rate=FS, n_channels=1))
    with bands.judging():
        ours = R.encode_file(pcm, FS, R.CodecConfig(sample_rate=FS,
                                                    n_channels=1))
    assert ours == oracle
    assert np.array_equal(R.decode_file(ours)[1],
                          refcodec.decode_file(oracle)[1])


def test_bands_functions_are_the_frozen_ones_where_bands_have_lines():
    cfg = R.CodecConfig()
    x = J.as_float(clip(12, 20_000))
    for i, extra in ((3, 0), (9, 400), (17, -50)):
        an = R.analyze_block(J.full_block(x, i, 1024), cfg)
        got = bands.allocate_block(an, cfg, extra, J.tables())
        want = R.allocate_block(an, cfg, extra, J.tables())
        assert R.pack_block(got[0], cfg) == R.pack_block(want[0], cfg)
        assert got[1:] == want[1:]
        parsed = R.unpack_block(R.pack_block(got[0], cfg), 0, cfg,
                                J.tables())
        assert bands.line_err_steps(an, parsed, cfg) == J.line_err_steps(
            an, parsed, cfg)
    assert R.allocate_block is not bands.allocate_block


def test_the_speech_is_the_seeds_and_holds_its_levels(voices,
                                                      monkeypatch):
    pcm, spurts = voices
    again = speech.speaker_pool(torch, 2 ** 35 + 9, 2, P, 20.0, FS, "cpu")
    other = speech.speaker_pool(torch, 2 ** 35 + 10, 1, P, 20.0, FS, "cpu")
    assert pcm.dtype == np.int16 and pcm.shape == (2, 20 * FS)
    assert np.array_equal(pcm, again[0])
    assert not np.array_equal(pcm[0], other[0][0])
    # made in pieces (an hour's speech is), the same speech to a few steps
    monkeypatch.setattr(speech, "PIECE", 40_009)
    cut = speech.speaker_pool(torch, 2 ** 35 + 9, 2, P, 20.0, FS, "cpu")
    assert all(np.array_equal(a, b) for a, b in zip(cut[1], spurts))
    gap = np.abs(cut[0].astype(np.int32) - pcm)
    assert np.percentile(gap, 99) <= 2 * 10 ** (P["floor_dbfs"] / 20) \
        * 32767 * 3
    for x, s in zip(pcm, spurts):
        inside = np.zeros(x.size, bool)
        for a, b in s:
            inside[a:b] = True
        assert 0.1 <= np.mean(~inside) <= 0.32
        rms = lambda v: 20 * np.log10(  # noqa: E731
            np.sqrt(np.mean(v.astype(np.float64) ** 2)) / 32767)
        assert abs(rms(x[inside]) - P["spurt_dbfs"]) < 0.5
        assert abs(rms(x[~inside]) - P["floor_dbfs"]) < 0.5
        assert np.mean(x[~inside] == 0) < 0.05     # never digital zero
        assert ((np.diff(s[:, 0]) / FS) >= P["spurt_s"][0]
                + P["pause_s"][0] - 1e-3).all()


def test_manifest_has_the_new_cells_and_metrics():
    m = Manifest(ROOT, BENCH)
    for name in CELLS:
        cell = m.cell(name)
        assert cell["chips"] == 1
        assert hasattr(m.loop(m.traffic(cell)), "window")
        assert m.limits(cell)
    assert m.config(m.cell(CELLS[0]))["codec"] == {"sample_rate": FS,
                                                   "n_channels": 1}
    assert [x["name"] for x in m.metrics(CELLS[0], False)] == [
        "roundtrip_blocks_per_s", "setup_s"]
    assert [x["name"] for x in m.metrics(CELLS[1], False)] == [
        "push_p95_ms", "setup_s"]
    assert {x["name"] for x in m.metrics(CELLS[1], True)} == {
        "device_idle_pct.stream", "decode_push_ms_p50.stream-decode",
        "push_service_ms_p50.stream", "push_device_ms.stream",
        "synthesis_pad_pct.stream-decode"}
    assert len(m.metrics(CELLS[0], True)) == 12
    for x in m.metrics(CELLS[0], True) + m.metrics(CELLS[1], True):
        assert hasattr(m.reader(x["name"]), "read")


@pytest.fixture(scope="module")
def bench(tmp_path_factory):
    """tiny.make's copy with a tiny cell of each new traffic under its
    real cell's limits."""
    d = str(tmp_path_factory.mktemp("bench"))
    path = tiny.make(d)
    with open(os.path.join(d, "BENCHMARK.json")) as f:
        doc = json.load(f)
    for name, (config, traffic, real) in TINY.items():
        tname = name.split(".", 1)[1]
        with open(os.path.join(path, "traffic", tname + ".json"), "w") as f:
            json.dump(traffic, f)
        with open(os.path.join(path, "limits", real + ".json")) as f:
            limits = f.read()
        with open(os.path.join(path, "limits", name + ".json"), "w") as f:
            f.write(limits)
        doc["workloads"].append({"name": name, "config": config,
                                 "traffic": tname, "chips": 1,
                                 "why": "tiny"})
        for x in doc["end_to_end"] + doc["per_layer"]:
            if real in x.get("workloads", []):
                x["workloads"].append(name)
    with open(os.path.join(d, "BENCHMARK.json"), "w") as f:
        json.dump(doc, f)
    return Manifest(d, path)


def run_tiny(bench, cell, hook=None, seconds=0.3):
    try:
        return core.run_cell(bench, cell, 2 ** 33 + 21, seconds, False,
                             device="cpu", workers=1, hook=hook)
    finally:
        controls.restore()


def failed(out):
    return [k for k, v in out["check"].items()
            if v["value"] is None or v["value"] > v["limit"]]


@pytest.mark.parametrize("fault", [None, "answer"])
def test_the_episodes_loop(bench, fault):
    out = run_tiny(bench, "wak-mono-22k.tiny-podcast",
                   controls.FAULTS.get(fault))
    if fault is None:
        assert out["correct"], out["check"]
        assert out["attempted"] >= 1 and out["failed"] == 0
        assert out["metrics"]["roundtrip_blocks_per_s"]["value"] > 0
        assert out["check"]["extras_off"]["value"] == 0
        assert out["_info"]["streams_judged"] == min(2, out["attempted"])
        assert any(out["_info"]["pause_blocks"])
    else:
        assert not out["correct"] and failed(out), out["check"]


def push_hook(change):
    """A hook under which StreamingDecoder.push returns change(pcm) of its
    third call's PCM."""
    def hook(run):
        from pactpu_torch.codec import stream
        push, calls = stream.StreamingDecoder.push, [0]

        def altered(self, data):
            out = push(self, data)
            calls[0] += 1
            return change(out) if calls[0] == 3 else out
        controls._patch(stream.StreamingDecoder, "push", altered)
    return hook


PUSH_FAULTS = {
    "dropped": push_hook(lambda pcm: pcm[1024:]),
    "repeated": push_hook(lambda pcm: np.concatenate([pcm[:1024], pcm])),
}


@pytest.mark.parametrize("fault", [None, "dropped", "repeated"])
def test_the_stream_decode_loop(bench, fault):
    runs = []
    hook = PUSH_FAULTS.get(fault, runs.append)
    out = run_tiny(bench, "wak-default.tiny-stream-decode", hook,
                   seconds=1.2)
    if fault is None:
        assert out["correct"], out["check"]
        assert out["attempted"] >= 6 and out["failed"] == 0
        assert out["check"]["joined_gap_lsb"]["value"] == 0
        assert out["_info"]["flushed"] >= 1
        assert out["_info"]["pcm_blocks"] > 0
        # the benchmark's span around each call in the window, which
        # push_service_ms_p50.stream reads
        assert len(runs[0].spans.ms["push"]) == out["attempted"]
        assert read("push_service_ms_p50.stream", runs[0]) > 0
    else:
        assert not out["correct"] and failed(out), out["check"]


def test_decode_push_median(monkeypatch):
    spans = [S("decode_push", 0, 4, blocks=16), S("parse", 1, 2),
             S("decode_push", 10, 12, blocks=16),
             S("decode_push", 20, 29, blocks=0), S("encode", 30, 90)]
    spans[1].parent = spans[0].id
    run = traced(monkeypatch, spans)
    assert read("decode_push_ms_p50.stream-decode", run) == 4.0
    run = traced(monkeypatch, [S("push", 0, 4, blocks=16)])
    assert read("decode_push_ms_p50.stream-decode", run) is None


def test_synthesis_padding_share(monkeypatch):
    spans = [S("decode_push", 0, 4, blocks=16),
             S("replay:synthesize", 1, 2, blocks=512),
             S("decode_push", 10, 12, blocks=16),
             S("replay:synthesize", 10, 11, blocks=16),
             S("direct:synthesize", 11, 12, blocks=32),
             S("decode_push", 20, 29, blocks=0),
             S("push", 30, 40, blocks=16),
             S("replay:synthesize", 31, 32, blocks=512)]
    for i in (1, 3, 4, 7):
        spans[i].parent = spans[i - 1 - (i == 4)].id
    run = traced(monkeypatch, spans)
    assert read("synthesis_pad_pct.stream-decode", run) == \
        pytest.approx(100.0 * (560 - 32) / 560)
    run = traced(monkeypatch, [S("push", 0, 4, blocks=16)])
    assert read("synthesis_pad_pct.stream-decode", run) is None


def test_analysis_device_time_per_kblock(monkeypatch):
    enc = S("encode", 0.0, 0.3, blocks=2000)
    events = [
        Ev(PREFIX + "encode", 0, 300),
        Ev(PREFIX + "analyze", 10, 50), Ev(PREFIX + "replay:analyze", 15, 45),
        Ev("cudaGraphLaunch", 20, 21, id=7),
        Ev("cudaMemcpyAsync", 46, 47, id=9),       # analyze, after replay
        Ev("cudaLaunchKernel", 60, 61, id=8),      # after the analysis
        Ev("k_a", 25, 55, "CUDA", id=7), Ev("k_b", 55, 60, "CUDA", id=7),
        Ev("Memcpy HtoD", 50, 52, "CUDA", id=9),
        Ev("k_c", 70, 170, "CUDA", id=8),
        Ev(PREFIX + "analyze", 400, 450),          # under no encode
        Ev("cudaGraphLaunch", 410, 411, id=11),
        Ev("k_d", 420, 440, "CUDA", id=11)]
    run = traced(monkeypatch, [enc], events)
    assert read("analysis_device_ms_per_kblock.podcast", run) == \
        pytest.approx((30 + 5 + 2) / 1e3 / 2)


def test_k4_mono_count_and_roofline(voices):
    import k4_mono
    pcm = voices[0][0][:8 * 1024, None]
    fr = __import__("k4").frames(pcm)[0]
    hann, sw = R.hann_window(2048), R.sine_window(2048)
    reach = k4_mono.reach(FS)
    want = sum(int(reach[R.find_peak_bins(np.fft.fft(hann * sw * f)[
        :1024])].sum()) for f in fr)
    got, rows = k4_mono.triples(pcm, FS)
    assert rows == fr.shape[0] and abs(got - want) <= 0.001 * want
    assert (k4_mono.reach(44100) == __import__("k4").reach()).all()

    class Run:
        config = {"codec": {"sample_rate": FS}}
        items = [{"traced": True, "pool": 0, "off": 0, "n": pcm.shape[0]}]
        state = {"pool": voices[0]}
        trace = type("T", (), {"t1": 1.0, "summarise": lambda self: {
            "kernels": {"spread_up_kernel": 1e-5}}})()
    assert read("k4_roofline_pct.podcast", Run()) == pytest.approx(
        100.0 * k4_mono.bound_s([pcm], FS) / 1e-5)


def test_the_episodes_loop_keeps_only_what_it_judges():
    import types
    loop = Manifest(ROOT, BENCH).loop({"loop": "episodes"})
    run = types.SimpleNamespace(items=[], traffic={"check": {"episodes": 3}},
                                rng=lambda salt: np.random.default_rng(salt))
    keeper = loop.Keeper(run)
    for n in (5, 3, 9, 1, 9, 12, 2, 7, 4, 8, 6):
        run.items.append(dict(n=n, stream=b"", out=0, extras=0, measure=0))
        keeper.take(len(run.items) - 1)
    judged = keeper.judged()
    assert run.items[judged[0]]["n"] == 12 and len(set(judged)) == 3
    assert [i for i, r in enumerate(run.items) if "out" in r] == sorted(
        judged)
