"""The port's streaming encoder/decoder (pactpu_torch.codec.stream):
split invariance and checkpoint/resume against the port's Engine, byte for
byte and sample for sample (tests/test_stream.py's seven tests on the
port), each block analysed and synthesized in a batch of the Engine's
size, the exact mode, .pac decode, and checkpoints that cross between the
two packages."""

import numpy as np
import pytest

from pactpu.codec.engine import Engine as JaxEngine
from pactpu.codec.stream import StreamingDecoder as JaxDecoder
from pactpu.codec.stream import StreamingEncoder as JaxEncoder
from pactpu_torch import CodecConfig, Engine
from pactpu_torch.codec import engine as E
from pactpu_torch.codec import stream as S
from pactpu_torch.codec.stream import StreamingDecoder, StreamingEncoder
from torch_threads import torch_threads  # noqa: F401 (autouse)

CPU = dict(device="cpu")


@pytest.fixture(scope="module")
def pcm() -> np.ndarray:
    rng = np.random.default_rng(7)
    n = 6 * 1024 + 123
    t = np.arange(n)[:, None]
    tone = 9000 * np.sin(2 * np.pi * 750 * t / 44100.0)
    noise = rng.normal(0.0, 1500.0, (n, 2))
    return np.clip(tone + noise, -32767, 32767).astype(np.int16)


@pytest.fixture(scope="module")
def batch_stream(pcm) -> bytes:
    return Engine(rate_mode="reservoir", **CPU).encode(pcm)


def _encode(pcm, splits, rate_mode="reservoir", cfg=None, resume_at=None):
    """Stream pcm cut at `splits` (restored from a checkpoint after the
    piece that ends at resume_at)."""
    enc = StreamingEncoder(cfg=cfg, rate_mode=rate_mode, **CPU)
    parts = [enc.header(pcm.shape[0])]
    for a, b in zip(splits[:-1], splits[1:]):
        parts.append(enc.push(pcm[a:b]))
        if b == resume_at:
            enc = StreamingEncoder.restore(enc.state_bytes(), cfg=cfg,
                                           rate_mode=rate_mode, **CPU)
    parts.append(enc.flush())
    return b"".join(parts)


def _decode(stream, step, chunk_blocks, fmt="wak", resume_at=None):
    dec = StreamingDecoder(fmt=fmt, chunk_blocks=chunk_blocks, **CPU)
    outs = []
    for i in range(0, len(stream), step):
        outs.append(dec.push(stream[i:i + step]))
        if i == resume_at:
            dec = StreamingDecoder.restore(dec.state_bytes(), fmt=fmt,
                                           chunk_blocks=chunk_blocks, **CPU)
    outs.append(dec.flush())
    return dec, np.concatenate([o for o in outs if o.size])


def test_encoder_split_invariance(pcm, batch_stream):
    splits = [0, 700, 1024, 2048 + 1, 5000, pcm.shape[0]]
    assert _encode(pcm, splits) == batch_stream


def test_encoder_checkpoint_resume(pcm, batch_stream):
    enc = StreamingEncoder(rate_mode="reservoir", **CPU)
    parts = [enc.header(pcm.shape[0]), enc.push(pcm[:3000])]
    state = enc.state_bytes()

    resumed = StreamingEncoder.restore(state, rate_mode="reservoir", **CPU)
    parts.append(resumed.push(pcm[3000:]))
    parts.append(resumed.flush())
    assert b"".join(parts) == batch_stream


def test_encoder_cbr_mode(pcm):
    batch = Engine(rate_mode="cbr", **CPU).encode(pcm)
    splits = list(range(0, pcm.shape[0], 999)) + [pcm.shape[0]]
    assert _encode(pcm, splits, rate_mode="cbr") == batch


def test_decoder_split_invariance(pcm, batch_stream):
    _, gold = Engine(**CPU).decode(batch_stream)
    dec, out = _decode(batch_stream, 1777, chunk_blocks=4)
    assert dec.sample_rate == 44100
    np.testing.assert_array_equal(out, gold)


def test_decoder_checkpoint_resume(pcm, batch_stream):
    _, gold = Engine(**CPU).decode(batch_stream)

    dec = StreamingDecoder(chunk_blocks=4, **CPU)
    mid = len(batch_stream) // 2
    parts = [dec.push(batch_stream[:mid])]
    state = dec.state_bytes()

    resumed = StreamingDecoder.restore(state, chunk_blocks=4, **CPU)
    parts.append(resumed.push(batch_stream[mid:]))
    parts.append(resumed.flush())
    np.testing.assert_array_equal(np.concatenate(parts), gold)


def test_roundtrip_through_streams(pcm):
    enc = StreamingEncoder(**CPU)
    stream = enc.header(pcm.shape[0]) + enc.push(pcm) + enc.flush()
    dec = StreamingDecoder(**CPU)
    out = np.concatenate([dec.push(stream), dec.flush()])
    # trimmed to the header's numSamples, the input's length here
    n = pcm.shape[0]
    assert out.shape[0] == n
    err = out.astype(np.float64) - pcm.astype(np.float64)
    snr = 10 * np.log10(np.sum(pcm.astype(np.float64) ** 2)
                        / max(np.sum(err ** 2), 1e-9))
    assert snr > 10.0


def test_mono_streaming_matches_batch():
    """Mono: the split stream equals the Engine's bytes, and the streaming
    decoder its samples."""
    rng = np.random.default_rng(31)
    t = np.arange(3 * 1024 + 500) / 44100.0
    sig = 0.5 * np.sin(2 * np.pi * 660 * t) \
        + 0.03 * rng.standard_normal(t.shape[0])
    pcm = np.clip(sig[:, None] * 32767, -32768, 32767).astype(np.int16)

    cfg = CodecConfig(n_channels=1)
    batch = Engine(cfg=cfg, rate_mode="reservoir", **CPU).encode(pcm)
    splits = list(range(0, pcm.shape[0], 700)) + [pcm.shape[0]]
    assert _encode(pcm, splits, cfg=cfg) == batch

    _, want = Engine(cfg=cfg, **CPU).decode(batch)
    _, got = _decode(batch, 999, chunk_blocks=16)
    assert got.shape[1] == 1
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n, blocks", [(0, 1), (1, 2), (1023, 2), (1024, 2),
                                       (1025, 3), (2048, 3)])
def test_block_counts_from_a_total_and_a_header(n, blocks):
    """file_blocks is the Engine's block count; header_blocks reads it
    back from the header's numSamples (Q6: a whole number of blocks is
    written one block longer)."""
    from pactpu_torch.codec.header import read_header, write_header
    assert S.file_blocks(n, 1024) == blocks
    assert Engine(**CPU).encode_arrays(np.zeros((n, 2), np.int16))[1] \
        == blocks
    _, written, _ = read_header(write_header(CodecConfig(), n)[0])
    assert S.header_blocks(written, 1024) == blocks


def test_batch_pieces_follow_the_default_chunking():
    """A 600-block file is analysed in a 512-block batch and a 96-block
    tail; past the file's batches, and without a total, 512 blocks."""
    assert E._default_batches(600) == [512, 96]
    assert S.batch_pieces(500, 530, 600) == [(500, 512, 0, 512),
                                             (512, 530, 512, 96)]
    assert S.batch_pieces(600, 700, 600) == [(600, 608, 512, 96),
                                             (608, 700, 608, 512)]
    assert S.batch_pieces(0, 5, 5) == [(0, 5, 0, 16)]
    assert S.batch_pieces(1000, 1030, None) == [(1000, 1024, 512, 512),
                                                (1024, 1030, 1024, 512)]


def _record(monkeypatch, module, name, log, field):
    """Wrap module.name to log (batch size, row) of every real row of its
    batches: rows whose `field` argument is not all zero."""
    real_fn = getattr(module, name)

    def wrapped(cfg, *args):
        x = args[field]
        real = x.reshape(x.shape[0], -1).abs().sum(1) > 0
        log.extend((x.shape[0], int(r)) for r in real.nonzero().flatten())
        return real_fn(cfg, *args)

    monkeypatch.setattr(module, name, wrapped)


def test_each_block_sits_in_a_batch_of_the_engines_size(monkeypatch):
    """A 40-block file in 5-block pushes: every block is analysed, and
    synthesized, at its own row of a batch of the size that holds it in
    the Engine (not in a 5-block batch); the bytes and samples agree.  A
    push's analysis takes the batch's PCM window with the push's samples
    in it, so the rows at its edges, which hold half a neighbour's frame,
    are analysed too (and dropped): the stream's rows are the Engine's,
    some more than once."""
    rng = np.random.default_rng(11)
    pcm = np.clip(rng.normal(0, 3000, (39 * 1024 + 700, 2)), -32768,
                  32767).astype(np.int16)
    logs = {k: [] for k in ("eng-a", "eng-s", "str-a", "str-s")}
    _record(monkeypatch, E, "analyze", logs["eng-a"], 0)
    _record(monkeypatch, E, "synthesize", logs["eng-s"], 0)
    _record(monkeypatch, S, "analyze", logs["str-a"], 0)
    _record(monkeypatch, S, "synthesize", logs["str-s"], 0)
    eng = Engine(**CPU)
    stream = eng.encode(pcm)
    _, want = eng.decode(stream)
    splits = list(range(0, pcm.shape[0], 5 * 1024)) + [pcm.shape[0]]
    assert _encode(pcm, splits) == stream
    _, got = _decode(stream, 2500, chunk_blocks=5)
    np.testing.assert_array_equal(got, want)
    b = S.file_blocks(pcm.shape[0], 1024)
    assert logs["eng-a"] == [(64, k) for k in range(b)]
    assert set(logs["str-a"]) == set(logs["eng-a"])
    assert logs["eng-s"] == [(64, k) for k in range(b)]
    assert logs["str-s"] == logs["eng-s"]


def test_exact_mode_stream():
    """rate_mode="exact": K7's (bitDeposit, extraBits) carry goes from push
    to push and through a checkpoint."""
    rng = np.random.default_rng(5)
    n = 20 * 1024 + 300
    t = np.arange(n)[:, None] / 44100.0
    pcm = np.clip(8000 * np.sin(2 * np.pi * 500 * t)
                  + rng.normal(0, 900, (n, 2)), -32768,
                  32767).astype(np.int16)
    gold = Engine(rate_mode="exact", **CPU).encode(pcm)
    splits = [0, 2500, 9000, 9001, n]
    assert _encode(pcm, splits, rate_mode="exact", resume_at=9000) == gold


def test_pac_stream_decode():
    """A .pac stream through StreamingDecoder(fmt="pac") gives the .pac
    Engine's samples, across a restored state."""
    rng = np.random.default_rng(2)
    pcm = np.clip(rng.normal(0, 2500, (9 * 1024 + 77, 2)), -32768,
                  32767).astype(np.int16)
    eng = Engine(fmt="pac", **CPU)
    stream = eng.encode(pcm)
    _, want = eng.decode(stream)
    _, got = _decode(stream, 1500, chunk_blocks=3, fmt="pac",
                     resume_at=4500)
    np.testing.assert_array_equal(got, want)


def test_push_after_flush_refused(pcm):
    enc = StreamingEncoder(**CPU)
    enc.header(pcm.shape[0])
    enc.flush()
    with pytest.raises(RuntimeError):
        enc.push(pcm[:10])
    with pytest.raises(RuntimeError):
        enc.flush()
    dec = StreamingDecoder(**CPU)
    dec.flush()
    with pytest.raises(RuntimeError):
        dec.push(b"PAC ")


def test_port_stream_equals_pactpus_stream(pcm):
    """On pactpu's own test signal the two Engines' bytes agree, and so
    do the two packages' streams of the same splits."""
    jax_batch = JaxEngine(rate_mode="reservoir").encode(pcm)
    port_batch = Engine(rate_mode="reservoir", **CPU).encode(pcm)
    assert jax_batch == port_batch
    splits = [0, 700, 3000, 5000, pcm.shape[0]]
    enc = JaxEncoder(rate_mode="reservoir")
    parts = [enc.header(pcm.shape[0])]
    parts += [enc.push(pcm[a:b]) for a, b in zip(splits[:-1], splits[1:])]
    assert b"".join(parts + [enc.flush()]) == _encode(pcm, splits)


@pytest.mark.parametrize("first", ["pactpu", "port"])
def test_encoder_checkpoint_crosses_packages(pcm, batch_stream, first):
    """An encoder checkpoint of either package resumes in the other; the
    joined stream is the Engines' (equal on this signal)."""
    enc = (JaxEncoder() if first == "pactpu" else StreamingEncoder(**CPU))
    parts = [enc.header(pcm.shape[0]), enc.push(pcm[:3000])]
    state = enc.state_bytes()
    other = (StreamingEncoder.restore(state, **CPU) if first == "pactpu"
             else JaxEncoder.restore(state))
    parts += [other.push(pcm[3000:]), other.flush()]
    assert b"".join(parts) == batch_stream


@pytest.mark.parametrize("first", ["pactpu", "port"])
def test_decoder_checkpoint_crosses_packages(batch_stream, first):
    """A decoder checkpoint of either package resumes in the other; the
    samples are the port's Engine's within 1 LSB (the JAX package's float
    carry and synthesis against the port's)."""
    _, gold = Engine(**CPU).decode(batch_stream)
    dec = (JaxDecoder(chunk_blocks=4) if first == "pactpu"
           else StreamingDecoder(chunk_blocks=4, **CPU))
    mid = len(batch_stream) // 2
    parts = [dec.push(batch_stream[:mid])]
    state = dec.state_bytes()
    other = (StreamingDecoder.restore(state, chunk_blocks=4, **CPU)
             if first == "pactpu" else JaxDecoder.restore(state,
                                                          chunk_blocks=4))
    parts += [other.push(batch_stream[mid:]), other.flush()]
    out = np.concatenate(parts)
    assert out.shape == gold.shape
    assert int(np.abs(out.astype(np.int32) - gold).max()) <= 1
