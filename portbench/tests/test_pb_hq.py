"""The cells wak-hq.tracks and wak-default.clips: the frozen reference at
4.93 bits a sample against the port's oracle, the manifest's new entries,
the clips loop at tiny sizes on the CPU (each fault a clip can carry,
an altered mantissa among them, comes out not correct), and the three
metrics over recorded spans."""

import json
import os

import numpy as np
import pytest

import tiny
import wakref as R
from harness import controls, core
from harness.manifest import Manifest
from pactpu_torch.compat import refcodec
from pactpu_torch.utils.config import CodecConfig
from conftest import BENCH, ROOT
from test_pb_program import S, read, traced
from test_pb_reference import clip

CELLS = ("wak-hq.tracks", "wak-default.clips")
METRICS = ("refinalize_pct.roundtrip", "padded_download_pct.roundtrip",
           "decode_row_fill_pct.roundtrip")
TINY_CLIPS = {"loop": "many", "lengths": {
    "median_s": 0.6, "sigma": 0.6, "lo_s": 0.2, "hi_s": 1.3, "count": 4},
    "pool": 2, "pool_s": 2.0, "trace_items": 1,
    "check": {"calls": 2, "clips": 2, "blocks": 6}}


def test_frozen_reference_is_the_oracle_at_4_93():
    pcm = clip(11, 12_000)
    ours = R.encode_file(pcm, 44100, R.CodecConfig(
        target_bits_per_sample=4.93))
    oracle = refcodec.encode_file(pcm, 44100, CodecConfig(
        target_bits_per_sample=4.93))
    assert ours == oracle
    assert len(ours) > 1.8 * len(R.encode_file(pcm, 44100, R.CodecConfig()))
    assert np.array_equal(R.decode_file(ours)[1],
                          refcodec.decode_file(oracle)[1])


def test_manifest_has_the_new_cells_and_metrics():
    m = Manifest(ROOT, BENCH)
    for name in CELLS:
        cell = m.cell(name)
        assert cell["chips"] == 1
        assert hasattr(m.loop(m.traffic(cell)), "window")
        assert m.limits(cell)
    assert m.config(m.cell("wak-hq.tracks"))["codec"] == {
        "target_bits_per_sample": 4.93}
    for name in METRICS:
        assert hasattr(m.reader(name), "read")
        for cell in ("wak-hq.tracks", "wak-default.tracks"):
            assert name in [x["name"] for x in m.metrics(cell, True)]
    assert [x["name"] for x in m.metrics("wak-default.clips", False)] == [
        "encode_blocks_per_s", "setup_s"]


@pytest.fixture(scope="module")
def bench(tmp_path_factory):
    """tiny.make's copy with a tiny clips cell under the clips limits."""
    d = str(tmp_path_factory.mktemp("bench"))
    bench = tiny.make(d)
    with open(os.path.join(bench, "traffic", "tiny-clips.json"), "w") as f:
        json.dump(TINY_CLIPS, f)
    with open(os.path.join(d, "BENCHMARK.json")) as f:
        doc = json.load(f)
    doc["workloads"].append({"name": "wak-default.tiny-clips",
                             "config": "wak-default",
                             "traffic": "tiny-clips", "chips": 1,
                             "why": "tiny"})
    for x in doc["end_to_end"] + doc["per_layer"]:
        if "wak-default.clips" in x.get("workloads", []):
            x["workloads"].append("wak-default.tiny-clips")
    with open(os.path.join(d, "BENCHMARK.json"), "w") as f:
        json.dump(doc, f)
    with open(os.path.join(bench, "limits", "wak-default.clips.json")) as f:
        limits = f.read()
    with open(os.path.join(bench, "limits", "wak-default.tiny-clips.json"),
              "w") as f:
        f.write(limits)
    return Manifest(d, bench)


def many_hook(change):
    """A hook that runs Engine.encode_many as change(encode_many, engine,
    pcms) does."""
    def hook(run):
        from pactpu_torch.codec import engine
        many = engine.Engine.encode_many
        controls._patch(engine.Engine, "encode_many",
                        lambda self, pcms: change(many, self, pcms))
    return hook


def _last_only(many, eng, pcms):
    out = many(eng, pcms)
    del eng.last_many
    return out


CLIP_FAULTS = {
    # a clip dropped: one stream fewer than clips
    "dropped": many_hook(lambda many, eng, pcms: many(eng, pcms[1:])),
    # one stream a clip, each another clip's
    "rotated": many_hook(lambda many, eng, pcms: (lambda s: s[1:] + s[:1])(
        many(eng, pcms))),
    # every clip but the last coded as silence of its length
    "silent": many_hook(lambda many, eng, pcms: many(
        eng, [np.zeros_like(p) for p in pcms[:-1]] + pcms[-1:])),
}


@pytest.mark.parametrize("fault", [None, "state", "half", "answer"])
def test_the_clips_loop_and_its_faults(bench, fault):
    hook = controls.FAULTS[fault] if fault else None
    try:
        out = core.run_cell(bench, "wak-default.tiny-clips", 2 ** 33 + 5,
                            0.3, False, device="cpu", workers=1,
                            hook=hook)
    finally:
        controls.restore()
    if fault is None:
        assert out["correct"], out["check"]
        assert out["attempted"] >= 1 and out["failed"] == 0
        assert out["metrics"]["encode_blocks_per_s"]["value"] > 0
        assert out["check"]["extras_off"]["value"] == 0
        ck = TINY_CLIPS["check"]
        assert out["_info"]["streams_judged"] == ck["clips"] * min(
            ck["calls"], out["attempted"])
    else:
        failed = [k for k, v in out["check"].items()
                  if v["value"] is None or v["value"] > v["limit"]]
        assert not out["correct"] and failed, out["check"]


def test_the_three_metrics_read_the_program_counters(monkeypatch):
    e1, e2 = S("encode", 0, 10, blocks=600), S("encode", 11, 20, blocks=40)
    d1, d2 = S("decode", 21, 30, blocks=600), S("decode", 31, 40, blocks=40)
    spans = [e1, S("rate", 1, 2, e1, chunks=2),
             S("frame", 3, 4, e1, bytes_out=9, wide=1, padded=0),
             e2, S("rate", 12, 13, e2, chunks=2),
             S("frame", 14, 15, e2, bytes_out=9, wide=0, padded=1),
             d1, S("repack", 22, 23, d1, rows=10, words=128, bits=20480),
             d2, S("repack", 32, 33, d2, rows=30, words=96, bits=46080)]
    run = traced(monkeypatch, spans)
    assert read(METRICS[0], run) == 25.0
    assert read(METRICS[1], run) == 25.0
    assert read(METRICS[2], run) == pytest.approx(
        100.0 * (20480 + 46080) / (10 * 128 * 32 + 30 * 96 * 32))
    # a program whose repack counts neither reads nothing
    d = S("decode", 0, 5, blocks=9)
    run = traced(monkeypatch, [d, S("repack", 1, 2, d, rows=10, threads=8)])
    assert read(METRICS[2], run) is None


def run_tiny_clips(bench, hook):
    try:
        return core.run_cell(bench, "wak-default.tiny-clips", 2 ** 33 + 5,
                             0.3, False, device="cpu", workers=1, hook=hook)
    finally:
        controls.restore()


@pytest.mark.parametrize("fault", sorted(CLIP_FAULTS))
def test_each_clip_of_a_call_is_held_to_the_reference(bench, fault):
    """A call whose streams are fewer than its clips, or not of its clips'
    lengths, fails; clips other than the last coded wrong come out not
    correct."""
    out = run_tiny_clips(bench, CLIP_FAULTS[fault])
    assert not out["correct"], out["check"]
    if fault != "silent":
        assert out["failed"] == out["attempted"] >= 1
    else:
        assert out["failed"] == 0 and out["_info"]["streams_judged"] >= 2


def test_a_program_keeping_the_last_files_statistics_is_judged_there(bench):
    """Without Engine.last_many (an older program) the loop judges the
    last clip of each judged call, from last_extras and last_measure."""
    out = run_tiny_clips(bench, many_hook(_last_only))
    assert out["correct"], out["check"]
    assert out["_info"]["streams_judged"] == min(
        TINY_CLIPS["check"]["calls"], out["attempted"])
