"""The port at the WAK reference's second operating point, 4.93 bits a
sample (about 217 kbps a channel), on the CPU:

- the float64 exact encode byte-equal to the port's float64 oracle;
- the reservoir float32 final pass, given pactpu's analysis and extras,
  pactpu's payload words and bit counts at the same packer width;
- the packer's width follows the bit budget: a chunk whose rows pass 256
  words is packed by the one final pass (`frame` counts no `wide` and no
  `padded` chunk), and its bytes equal the host packer's;
- the decode takes the wide upload layout and agrees with the oracle's
  decoder within 1 LSB."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from pactpu.codec import engine as je
from pactpu.utils.config import CodecConfig
from pactpu_torch.codec import engine as te
from pactpu_torch.compat import refcodec as trc
from pactpu_torch.utils import metrics as M
from pactpu_torch.utils.config import CodecConfig as TorchConfig
from test_torch_exact import stereo_pcm
from torch_threads import torch_threads  # noqa: F401 (autouse)

BPS = 4.93
CHUNK = 16


@pytest.fixture(scope="module")
def pcm():
    """3 s of the smoke test's music: 131 blocks, rows past 256 words."""
    return chip_smoke.synth(3.0, 7)


@pytest.fixture(scope="module")
def traced(pcm):
    """A reservoir encode and decode of pcm at 4.93 in 16-block chunks,
    recorded: (stream, decoded PCM, the spans, the encode's host arrays)."""
    eng = te.Engine(TorchConfig(target_bits_per_sample=BPS), "reservoir",
                    chunk_blocks=CHUNK, device="cpu")
    M.reset()
    with M.tracing():
        stream = eng.encode(pcm)
        _, out = eng.decode(stream)
    spans = M.spans()
    M.reset()
    return stream, out, spans, eng.encode_arrays(pcm)[0]


def test_pack_widths_follow_the_bit_budget():
    assert te.pack_widths(TorchConfig()) == (te.PACK_WORDS,
                                             te.PACK_DENSE_WORDS)
    assert te.pack_widths(TorchConfig(target_bits_per_sample=BPS)) == (608,
                                                                       257)
    assert te.pack_widths(TorchConfig(target_bits_per_sample=1.0)) == (
        te.PACK_WORDS, te.PACK_DENSE_WORDS)


def test_f64_exact_equals_the_oracle():
    cfg = TorchConfig(target_bits_per_sample=BPS)
    pcm = stereo_pcm()
    mine = te.Engine(cfg, "exact", chunk_blocks=CHUNK, precision="f64",
                     device="cpu").encode(pcm)
    assert mine == trc.encode_file(pcm, 44100, cfg)


def test_f32_final_pass_given_pactpus_analysis(pcm):
    """pactpu's chunked reservoir encode stage by stage, its final pass at
    the port's width for 4.93 (pactpu's own 256 words would drop the wide
    rows' tails): the port's final pass on the same analysis and extras
    gives the same words and bit counts, rows past 256 words among them."""
    jcfg = CodecConfig(target_bits_per_sample=BPS)
    cfg = TorchConfig(target_bits_per_sample=BPS)
    width = te.pack_widths(cfg)[0]
    half = cfg.n_mdct_lines
    x = pcm[:40 * half]
    b = -(-x.shape[0] // half) + 1
    sizes = je._chunk_sizes(b, CHUNK)
    offs = je._offsets(sizes)
    glob = np.zeros((2, (offs[-1] + 1) * half), np.int16)
    glob[:, half:half + x.shape[0]] = x.T
    consts = je.Engine(cfg=jcfg, rate_mode="reservoir",
                       chunk_blocks=CHUNK).consts()
    analyze = je._chunk_analyze_fn(jcfg)
    measure = je._finalize_fn(jcfg, measure_only=True)
    scan = je._reservoir_scan_fn(jcfg)
    final = je._finalize_fn(jcfg, pack_words=width)
    dev = te.device_tables(cfg, "cpu")
    carry = jnp.zeros(2, jnp.int32)
    widest = 0
    for k, sz in enumerate(sizes):
        a = analyze(jnp.asarray(glob[:, offs[k] * half:
                                     (offs[k + 1] + 1) * half]), consts)
        m = measure(a, jnp.zeros(sz, jnp.float32), consts)
        ex, carry = scan(m["savings"], m["leftover"],
                         jnp.arange(sz) < max(0, b - offs[k]), carry)
        gold = final(a, ex, consts)
        mine = te.finalize(cfg, dict(
            mixed=torch.from_numpy(np.array(a["mixed"])),
            smr=torch.from_numpy(np.array(a["smr"])),
            lrms=torch.from_numpy(np.array(a["lrms"])),
            overall=torch.from_numpy(np.array(a["overall"], np.int32))),
            torch.from_numpy(np.array(ex)), dev, pack_words=width)
        np.testing.assert_array_equal(mine["words"].numpy().view(np.uint32),
                                      np.asarray(gold["words"]))
        np.testing.assert_array_equal(mine["nbits"].numpy(),
                                      np.asarray(gold["nbits"]))
        widest = max(widest, int(np.asarray(gold["nbits"]).max()))
    assert widest > 32 * 256


def test_wide_rows_packed_by_the_final_pass(pcm, traced):
    stream, _, spans, arrays = traced
    assert int(arrays["nbits"].max()) > 32 * 256
    final = [s for s in spans if s.name == "final"]
    frame = [s for s in spans if s.name == "frame"]
    assert [s.counts["words"] for s in final] == [608]
    assert [(s.counts["wide"], s.counts["padded"]) for s in frame] == [(0, 0)]
    host = te.Engine(TorchConfig(target_bits_per_sample=BPS), "reservoir",
                     chunk_blocks=CHUNK, device_pack=False, device="cpu")
    assert host.encode(pcm) == stream


def test_the_narrow_packer_falls_back_to_the_same_bytes(pcm, traced,
                                                        monkeypatch):
    """With the default's widths the wide rows re-finalize and the chunks
    download their padded rows: the same stream, the fallbacks counted."""
    monkeypatch.setattr(te, "pack_widths",
                        lambda cfg: (te.PACK_WORDS, te.PACK_DENSE_WORDS))
    eng = te.Engine(TorchConfig(target_bits_per_sample=BPS), "reservoir",
                    chunk_blocks=CHUNK, device="cpu")
    M.reset()
    with M.tracing():
        assert eng.encode(pcm) == traced[0]
    frame = [s for s in M.spans() if s.name == "frame"]
    M.reset()
    assert frame[0].counts["wide"] > 0 and frame[0].counts["padded"] > 0


def test_decode_takes_the_wide_layout_within_one_lsb(traced):
    stream, out, spans, _ = traced
    compact = [s for s in spans if s.name == "compact"]
    repack = [s for s in spans if s.name == "repack"]
    assert [s.counts["overflow"] for s in compact] == [0]
    assert repack[0].counts["words"] == 384
    assert 0 < repack[0].counts["bits"] < 384 * 32 * repack[0].counts["rows"]
    staged = te.Engine(device="cpu", chunk_blocks=CHUNK)._decode_staging(
        stream)
    rows = CHUNK * 2
    assert {a[2].shape for a in staged["chunk_args"]} == {
        (rows * te._decode_layouts()[-1][0],)}
    _, gold = trc.decode_file(stream)
    assert out.shape == gold.shape
    d = np.abs(out.astype(np.int32) - gold.astype(np.int32))
    assert d.max() <= 1


def test_each_rate_expands_to_its_layouts_width(pcm, traced, monkeypatch):
    """A 2.27 stream's rows (96 or 128 words at the widest) expand to 128
    words on the device, as wide as the host's repack; a 4.93 stream's
    (384) to 512."""
    widths = []
    expand = te.expand_flat

    def spy(flat, ba_rows, n_words, lay):
        widths.append(n_words)
        return expand(flat, ba_rows, n_words, lay)
    monkeypatch.setattr(te, "expand_flat", spy)
    eng = te.Engine(device="cpu", chunk_blocks=CHUNK)
    default = eng.encode(pcm)
    assert eng._host_parse(default[te.read_header(default)[2]:],
                           TorchConfig())[3] <= 128
    eng.decode(default)
    assert set(widths) == {128}
    widths.clear()
    eng.decode(traced[0])
    assert set(widths) == {512}
