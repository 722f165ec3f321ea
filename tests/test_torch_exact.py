"""The port's exact rate mode (pactpu_torch.codec.exact, kernel K7's plain
version on the CPU) against pactpu.codec.exact and the float64 oracle:

- the cost table integer-equal to pactpu's cost_table_body on the same
  analysis dict, stereo and mono;
- the plain scan equal to pactpu's extras_scan_body in extras and carry,
  across two chunks with a padded tail;
- Engine(rate_mode="exact", precision="f64") byte-equal to the port's
  oracle and to pactpu's f64 engine on the mono signal of
  tests/test_exact_mode.py:146-153 and a 20-block stereo signal;
- the float32 exact mode byte-equal to pactpu's given pactpu's analysis,
  within 0.1 dB and 1% from PCM, and independent of the chunk size;
- what the exact mode and float64 refuse."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from pactpu.codec import engine as je
from pactpu.codec import exact as jx
from pactpu.utils.config import CodecConfig
from pactpu_torch.codec import engine as te
from pactpu_torch.codec import exact as tx
from pactpu_torch.compat import refcodec as trc
from pactpu_torch.utils.config import CodecConfig as TorchConfig
from test_torch_refcodec import mono_pcm
from torch_threads import torch_threads  # noqa: F401 (autouse)

CHUNK = 16


def stereo_pcm() -> np.ndarray:
    """20 coded blocks (19 of audio and the flush block)."""
    return chip_smoke.synth(19 * 1024 / 44100, 1)


def jax_analyses(cfg: CodecConfig, pcm: np.ndarray):
    """pactpu's chunked analysis of pcm (float32), as the engine runs it.
    Returns (its analysis dicts, consts, real blocks, chunk sizes)."""
    half = cfg.n_mdct_lines
    b = -(-pcm.shape[0] // half) + 1
    sizes = je._chunk_sizes(b, CHUNK)
    offs = je._offsets(sizes)
    glob = np.zeros((cfg.n_channels, (offs[-1] + 1) * half), np.int16)
    glob[:, half:half + pcm.shape[0]] = pcm.T
    consts = je.Engine(cfg=cfg, rate_mode="exact").consts()
    analyze = je._chunk_analyze_fn(cfg)
    return ([analyze(jnp.asarray(glob[:, offs[k] * half:
                                      (offs[k + 1] + 1) * half]), consts)
             for k in range(len(sizes))], consts, b, sizes)


def to_torch(a: dict) -> dict:
    return dict(mixed=torch.from_numpy(np.array(a["mixed"])),
                smr=torch.from_numpy(np.array(a["smr"])),
                lrms=torch.from_numpy(np.array(a["lrms"])),
                overall=torch.from_numpy(np.array(a["overall"], np.int32)))


@pytest.fixture(scope="module", params=[2, 1], ids=["stereo", "mono"])
def run(request):
    """pactpu's exact run on a 20-block file (two 16-block chunks, the
    second padded): analyses, cost tables, extras and carry."""
    c = request.param
    cfg = CodecConfig(n_channels=c)
    pcm = np.ascontiguousarray(stereo_pcm()[:, :c])
    analyses, consts, b, sizes = jax_analyses(cfg, pcm)
    cost_fn = jx.cost_table_body(cfg)
    extras, carry = jx.exact_extras_chunked(analyses, consts, cfg, "f32", b)
    return dict(c=c, analyses=analyses, consts=consts, b=b, sizes=sizes,
                costs=[np.asarray(cost_fn(a, consts)) for a in analyses],
                extras=[np.asarray(e) for e in extras],
                carry=np.asarray(carry))


@pytest.fixture(scope="module")
def dev():
    return {c: te.device_tables(TorchConfig(n_channels=c), "cpu")
            for c in (1, 2)}


def test_cost_table_integer_equal(run, dev):
    cfg = TorchConfig(n_channels=run["c"])
    for a, gold in zip(run["analyses"], run["costs"]):
        cost = tx.cost_table(cfg, to_torch(a), dev[run["c"]])
        assert cost.dtype == torch.int32 and cost.shape == gold.shape
        np.testing.assert_array_equal(cost.numpy(), gold)
        assert not cost[:, :, :, 0].any()


def test_plain_scan_equals_extras_scan(run, dev):
    """Two chunks, the second with 4 real blocks of 16: per-chunk extras
    (0 on the padding) and the final carry equal pactpu's."""
    cfg = TorchConfig(n_channels=run["c"])
    assert run["b"] == 20 and run["sizes"] == [16, 16]
    extras, carry = tx.extras_chunked(
        cfg, [to_torch(a) for a in run["analyses"]], dev[run["c"]], run["b"])
    for mine, gold in zip(extras, run["extras"]):
        np.testing.assert_array_equal(mine.numpy(), gold)
    np.testing.assert_array_equal(carry.numpy(), run["carry"])
    assert not extras[1][4:].any() and extras[0].any()


def test_f32_exact_given_pactpus_analysis(run, dev):
    """The float32 exact mode's payload from pactpu's analysis dicts:
    pactpu's words and bit counts, chunk for chunk."""
    c = run["c"]
    cfg, jcfg = TorchConfig(n_channels=c), CodecConfig(n_channels=c)
    final = je._finalize_fn(jcfg, pack_words=je.PACK_WORDS)
    extras, _ = tx.extras_chunked(
        cfg, [to_torch(a) for a in run["analyses"]], dev[c], run["b"])
    for a, ex in zip(run["analyses"], extras):
        gold = final(a, jnp.asarray(ex.numpy()), run["consts"])
        out = te.finalize(cfg, to_torch(a), ex, dev[c])
        np.testing.assert_array_equal(out["words"].numpy().view(np.uint32),
                                      np.asarray(gold["words"]))
        np.testing.assert_array_equal(out["nbits"].numpy(),
                                      np.asarray(gold["nbits"]))


@pytest.mark.parametrize("channels", [1, 2])
def test_f64_engine_byte_equal_to_oracle_and_pactpu(channels):
    cfg, jcfg = TorchConfig(n_channels=channels), CodecConfig(
        n_channels=channels)
    pcm = mono_pcm() if channels == 1 else stereo_pcm()
    mine = te.Engine(device="cpu", cfg=cfg, rate_mode="exact",
                     precision="f64", chunk_blocks=CHUNK).encode(pcm)
    assert mine == trc.encode_file(pcm, 44100, cfg)
    with jax.enable_x64(True):
        gold = je.Engine(cfg=jcfg, rate_mode="exact", precision="f64",
                         chunk_blocks=CHUNK).encode(pcm)
    assert mine == gold


def test_f32_exact_from_pcm_and_chunk_invariance():
    """From PCM the float32 exact stream is within 0.1 dB and 1% of
    pactpu's, and the same bytes with 16- and 64-block chunks."""
    pcm = stereo_pcm()
    s16 = te.Engine(device="cpu", rate_mode="exact", chunk_blocks=16).encode(
        pcm)
    s64 = te.Engine(device="cpu", rate_mode="exact", chunk_blocks=64).encode(
        pcm)
    assert s16 == s64
    gold = je.Engine(rate_mode="exact", chunk_blocks=16).encode(pcm)
    assert abs(len(s16) - len(gold)) <= 0.01 * len(gold)
    dec = te.Engine(device="cpu")
    snr = [chip_smoke.snr_db(pcm, dec.decode(s)[1]) for s in (s16, gold)]
    assert abs(snr[0] - snr[1]) <= 0.1


@pytest.mark.parametrize("blocks", [20, 700, 1100])
def test_analysis_batches_independent_of_chunk_blocks(monkeypatch, blocks):
    """The engine analyses a file in the batches of its default chunking
    whatever chunk_blocks is (the card's GEMM and FFT round a block by the
    batch it sits in), then cuts the chunks from them: every chunk size
    makes the same analysis calls on the file's blocks, and each chunk's
    dict holds its own blocks in order."""
    def fake_analyze(cfg, frames, dev):
        calls.append(frames.shape[0])
        return dict(id=frames[:, 0, cfg.n_mdct_lines].long(),
                    pair=frames[:, :, cfg.n_mdct_lines].long())

    monkeypatch.setattr(te, "analyze", fake_analyze)
    pcm = np.zeros(((blocks - 1) * 1024, 2), np.int16)
    pcm[::1024, 0] = np.arange(1, blocks)          # block k's id: k + 1
    pcm[::1024, 1] = -np.arange(1, blocks)
    want = torch.cat([torch.arange(1, blocks), torch.zeros(1, dtype=int)])
    seen = {}
    for chunk in (None, 16, 100, 128, 1024):
        calls = []
        b, sizes, analyses = te.Engine(device="cpu",
                                       chunk_blocks=chunk)._analyze(pcm)
        assert b == blocks
        assert [a["id"].shape[0] for a in analyses] == sizes
        ids = torch.cat([a["id"] for a in analyses])
        assert torch.equal(ids[:b], want)
        assert not bool(ids[b:].any())                 # zero padding
        assert torch.equal(torch.cat([a["pair"] for a in analyses])[:b],
                           torch.stack([want, -want], 1))
        # the calls that hold the file's blocks
        covered = np.cumsum(calls)
        seen[chunk] = calls[:int(np.searchsorted(covered, b)) + 1]
    assert all(v == seen[None] for v in seen.values()), seen


def test_pac_batches_independent_of_chunk_blocks(monkeypatch):
    """The .pac encode (no rate control across blocks) runs in the default
    batches whatever chunk_blocks is: the same calls, the same bytes."""
    real = te.encode_baseline

    def recording(cfg, frames, dev):
        calls.append(frames.shape[0])
        return real(cfg, frames, dev)

    monkeypatch.setattr(te, "encode_baseline", recording)
    pcm = stereo_pcm()
    seen = {}
    for chunk in (None, 16, 48):
        calls = []
        stream = te.Engine(device="cpu", fmt="pac",
                           chunk_blocks=chunk).encode(pcm)
        seen[chunk] = (calls, stream)
    assert seen[16] == seen[48] == seen[None]


def test_refusals():
    """pactpu's exact-mode refusals (water-fill, sine window, intensity
    M/S, no .pac); float64 accepts the aidan peak modes (K6's float64
    form) and refuses an unknown precision."""
    te.Engine(device="cpu", rate_mode="exact", precision="f64")
    for fields in (dict(window="kbd"), dict(ms_decision="bitalloc")):
        with pytest.raises(ValueError, match="rate_mode='exact'"):
            te.Engine(device="cpu", rate_mode="exact",
                      cfg=TorchConfig(**fields))
    with pytest.raises(ValueError, match="no reservoir"):
        te.Engine(device="cpu", rate_mode="exact", fmt="pac")
    for mode in ("para", "weighted"):
        te.Engine(device="cpu", cfg=TorchConfig(peak_mode=mode))
        eng = te.Engine(device="cpu", precision="f64",
                        cfg=TorchConfig(peak_mode=mode))
        assert eng.consts()["psy"]["zvec"].dtype == torch.float64
    with pytest.raises(ValueError, match="unknown precision"):
        te.Engine(device="cpu", precision="f16")


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("name", chip_smoke.K2_EDGES)
def test_row_plain_fill_equals_water_fill_plain(name, dtype):
    """The plain scan's one-row fill (a Python loop, kernels.
    water_fill_row_plain) equals water_fill_plain row for row on every K2
    edge input, NaN and the dead key included, in both float types."""
    from pactpu_torch.ops import kernels as K
    total, max_mant, n_lines, smr, lrms = chip_smoke.k2_edge(name)
    smr = torch.from_numpy(smr.astype(dtype))
    bits, left = K.water_fill_plain(
        torch.from_numpy(total), max_mant, torch.from_numpy(n_lines), smr,
        torch.from_numpy(lrms))
    for r in range(smr.shape[0]):
        row_bits, row_left = K.water_fill_row_plain(
            int(total[r]), max_mant, n_lines.tolist(), smr[r],
            lrms[r].tolist(), -5.0, -15.0)
        assert row_bits == bits[r].tolist() and row_left == int(left[r])
