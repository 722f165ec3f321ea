"""PyTorch port, the whole slice on the CPU: reservoir (and cbr) encode ->
decode against pactpu on the same input, the batch entry points against
the serial ones, and the payload overflow fallbacks."""

import numpy as np
import pytest

from make_torch_port_fixture import fixture_pcm
from pactpu.codec import engine as je
from pactpu_torch import Engine
from pactpu_torch.codec import engine as te
from pactpu_torch.codec.header import read_header
from torch_threads import torch_threads  # noqa: F401 (autouse)

CHUNK = 16


def snr_db(ref, out):
    x = ref.astype(np.float64)
    e = x - out[:len(ref)].astype(np.float64)
    return 10 * np.log10((x * x).sum() / (e * e).sum())


def rows(stream: bytes) -> list:
    _, _, off = read_header(stream)
    p, out, i = stream[off:], [], 0
    while i < len(p):
        n = int.from_bytes(p[i:i + 4], "little")
        out.append(p[i + 4:i + 4 + n])
        i += 4 + n
    return out


@pytest.fixture(scope="module")
def pcms():
    """0.5 s (23 blocks: one 16-block chunk and a padded tail, the least
    that covers two chunks) and a shorter second file."""
    return [fixture_pcm(seed=11, seconds=0.5), fixture_pcm(seed=12,
                                                           seconds=0.3)]


@pytest.fixture(scope="module")
def port(pcms):
    eng = Engine(device="cpu", rate_mode="reservoir", chunk_blocks=CHUNK)
    streams = [eng.encode(p) for p in pcms]
    return eng, streams, [eng.decode(s)[1] for s in streams]


@pytest.fixture(scope="module")
def jax_gold(pcms):
    """pactpu's encode and decode of the first file, per rate mode."""
    out = {}
    for rate_mode in ("reservoir", "cbr"):
        ref = je.Engine(rate_mode=rate_mode, chunk_blocks=CHUNK)
        gold = ref.encode(pcms[0])
        out[rate_mode] = (gold, ref.decode(gold)[1])
    return out


@pytest.mark.parametrize("rate_mode", ["reservoir", "cbr"])
def test_slice_matches_pactpu(pcms, port, jax_gold, rate_mode):
    """SNR against the input within 0.1 dB of pactpu's and the stream
    size within 1%; nearly every channel-block byte-identical (a block
    differs only where an FFT last-bit difference moves a decision)."""
    pcm = pcms[0]
    if rate_mode == "reservoir":
        stream, out = port[1][0], port[2][0]
    else:
        eng = Engine(device="cpu", rate_mode="cbr", chunk_blocks=CHUNK)
        stream = eng.encode(pcm)
        out = eng.decode(stream)[1]
    gold, gold_pcm = jax_gold[rate_mode]
    assert abs(snr_db(pcm, out) - snr_db(pcm, gold_pcm)) <= 0.1
    assert abs(len(stream) - len(gold)) <= 0.01 * len(gold)
    rj, rt = rows(gold), rows(stream)
    assert len(rj) == len(rt) == 2 * (-(-pcm.shape[0] // 1024) + 1)
    same = sum(a == b for a, b in zip(rj, rt))
    assert same >= 0.9 * len(rj)


def test_roundtrip_many_equals_serial(pcms, port, jax_gold):
    """The batch entry points give the serial ones' streams and samples;
    the reservoir stream is the one held to pactpu's."""
    eng, streams, outs = port
    gold = jax_gold["reservoir"][0]
    assert abs(len(streams[0]) - len(gold)) <= 0.01 * len(gold)
    results, batch_streams = eng.roundtrip_many(pcms, return_streams=True)
    assert batch_streams == streams
    for (fs, out), gold in zip(results, outs):
        assert fs == 44100
        np.testing.assert_array_equal(out, gold)
    assert eng.encode_many(pcms) == streams


def test_encode_many_keeps_each_files_statistics(pcms):
    """last_many: each file's extras, measurement pass and savings, what
    last_extras, last_measure and last_savings read after encoding that
    file alone; the last_* properties describe the last file."""
    eng = Engine(device="cpu", rate_mode="reservoir", chunk_blocks=CHUNK)
    eng.encode_many(pcms)
    many = eng.last_many
    assert len(many) == len(pcms)
    assert eng.last_extras is many[-1].extras
    one = Engine(device="cpu", rate_mode="reservoir", chunk_blocks=CHUNK)
    for p, st in zip(pcms, many):
        one.encode(p)
        assert len(st.extras) == one._blocks(p)
        np.testing.assert_array_equal(st.extras, one.last_extras)
        for a, b in zip(st.measure, one.last_measure):
            np.testing.assert_array_equal(a, b)
        assert int(st.host("savings").sum()) == one.last_savings


@pytest.mark.parametrize("knob,value", [("PACK_WORDS", 32),
                                        ("PACK_DENSE_WORDS", 8)])
def test_overflow_fallbacks_same_stream(pcms, port, monkeypatch, knob,
                                        value):
    """Rows past the narrow packer re-finalize with a wider one; a dense
    download past its budget falls back to padded rows.  Either way the
    stream is the same."""
    monkeypatch.setattr(te, knob, value)
    eng = Engine(device="cpu", rate_mode="reservoir", chunk_blocks=CHUNK)
    assert eng.encode(pcms[0]) == port[1][0]
