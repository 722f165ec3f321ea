"""The port's precision="f64" stage by stage against pactpu's float64 path
(pactpu under jax.enable_x64(True)):

- analysis: the integer decisions (overall scale, LRMS flags) exactly, the
  MDCT lines within 1e-13 and the SMRs within 1e-9 dB (FFT, GEMM and the
  masking sum's order: K4's dense form here, pactpu's compact loop there);
- finalize: given pactpu's float64 analysis dict, both reservoir passes bit
  for bit (the float64 helpers of pactpu_torch.ops.quantize reproduce
  JAX's float64 2**k, fused multiply-add and reciprocal);
- decode: synthesis within 1e-12 of pactpu's, and the PCM of a whole
  stream equal;
- K2's plain version in float64 bit for bit with pactpu's XLA loop in
  float64 on the edge inputs."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from pactpu.codec import engine as je
from pactpu.ops import bitalloc as jba
from pactpu.utils.config import CodecConfig
from pactpu_torch.codec import engine as te
from pactpu_torch.ops import kernels as K
from pactpu_torch.utils.config import CodecConfig as TorchConfig
from torch_threads import torch_threads  # noqa: F401 (autouse)


@pytest.fixture(scope="module", params=[2, 1], ids=["stereo", "mono"])
def run(request):
    """pactpu's float64 analysis and both finalize passes of one 16-block
    chunk, and the port's analysis of the same frames."""
    c = request.param
    cfg, tcfg = CodecConfig(n_channels=c), TorchConfig(n_channels=c)
    pcm = chip_smoke.synth(15 * 1024 / 44100, 3)[:, :c]
    glob = np.zeros((c, 17 * 1024), np.int16)
    glob[:, 1024:1024 + pcm.shape[0]] = pcm.T
    extra = (np.arange(16) * 37 - 200).astype(np.float32)
    with jax.enable_x64(True):
        consts = je.Engine(cfg=cfg, precision="f64").consts()
        a = je._chunk_analyze_fn(cfg, "f64")(jnp.asarray(glob), consts)
        measure = je._finalize_fn(cfg, measure_only=True, precision="f64")(
            a, jnp.zeros(16, jnp.float32), consts)
        final = je._finalize_fn(cfg, pack_words=je.PACK_WORDS,
                                precision="f64")(a, jnp.asarray(extra),
                                                 consts)
        host = lambda d: {k: np.array(v) for k, v in d.items()}  # noqa: E731
        run = dict(analysis=host(a), measure=host(measure),
                   final=host(final))
    dev = te.device_tables(tcfg, "cpu", "f64")
    run.update(c=c, cfg=tcfg, jcfg=cfg, dev=dev, extra=extra,
               mine=te.analyze(tcfg, te._overlap_frames(
                   torch.from_numpy(glob), 1024), dev))
    return run


def test_analysis(run):
    gold, mine = run["analysis"], run["mine"]
    assert mine["mixed"].dtype == mine["smr"].dtype == torch.float64
    np.testing.assert_array_equal(mine["overall"].numpy(), gold["overall"])
    np.testing.assert_array_equal(mine["lrms"].numpy(), gold["lrms"])
    np.testing.assert_allclose(mine["mixed"].numpy(), gold["mixed"], rtol=0,
                               atol=1e-13)
    np.testing.assert_allclose(mine["smr"].numpy(), gold["smr"], rtol=0,
                               atol=1e-9)


def test_finalize_bit_identical(run):
    a = run["analysis"]
    analysis = dict(mixed=torch.from_numpy(a["mixed"]),
                    smr=torch.from_numpy(a["smr"]),
                    lrms=torch.from_numpy(a["lrms"]),
                    overall=torch.from_numpy(a["overall"]))
    m = te.finalize(run["cfg"], analysis, torch.zeros(16), run["dev"],
                    measure_only=True)
    for key in ("savings", "leftover"):
        np.testing.assert_array_equal(m[key].numpy(), run["measure"][key])
    out = te.finalize(run["cfg"], analysis, torch.from_numpy(run["extra"]),
                      run["dev"])
    gold = run["final"]
    for key in ("bits", "sf", "tid"):
        np.testing.assert_array_equal(out[key].numpy(), gold[key])
    np.testing.assert_array_equal(out["words"].numpy().view(np.uint32),
                                  gold["words"])
    np.testing.assert_array_equal(out["nbits"].numpy(), gold["nbits"])


def test_decode(run):
    """Synthesis of the same quantized arrays within 1e-12 of pactpu's; a
    stream's PCM equal to pactpu's float64 decode."""
    g = run["final"]
    b, c = g["bits"].shape[:2]
    stream = te.Engine(device="cpu", cfg=run["cfg"], rate_mode="exact",
                       precision="f64").encode(
        chip_smoke.synth(10 * 1024 / 44100, 8)[:, :c])
    with jax.enable_x64(True):
        jeng = je.Engine(cfg=run["jcfg"], precision="f64")
        _, gold_pcm = jeng.decode(stream)
        # the final pass's allocations and scale factors with mantissas
        # of their widths, through both syntheses
        ba, sf = g["bits"].astype(np.int32), g["sf"].astype(np.int32)
        width = ba[..., np.asarray(run["jcfg"].band_layout.line_to_band)]
        mant = (np.random.default_rng(6).integers(0, 2 ** 16, width.shape)
                & ((1 << width) - 1)).astype(np.int32)
        gold_td = np.asarray(je.decode_body(run["jcfg"], "f64")(
            jnp.asarray(ba), jnp.asarray(sf), jnp.asarray(mant),
            jnp.asarray(g["overall"].astype(np.int32)),
            jnp.asarray(g["lrms"]), jeng.consts()))
    td = te.decode_body(run["cfg"], torch.from_numpy(ba),
                        torch.from_numpy(sf), torch.from_numpy(mant),
                        torch.from_numpy(g["overall"].astype(np.int32)),
                        torch.from_numpy(g["lrms"]), run["dev"])
    assert td.dtype == torch.float64 and td.shape == (b, c, 2048)
    np.testing.assert_allclose(td.numpy(), gold_td, rtol=0, atol=1e-12)
    _, pcm = te.Engine(device="cpu", cfg=run["cfg"],
                       precision="f64").decode(stream)
    np.testing.assert_array_equal(pcm, gold_pcm)


@pytest.mark.parametrize("name", [n for n in chip_smoke.K2_EDGES
                                  if n not in ("nan", "dead-key")])
def test_water_fill_plain_f64_matches_xla_loop(name):
    total, max_mant, n_lines, smr, lrms = chip_smoke.k2_edge(name)
    smr = smr.astype(np.float64)
    with jax.enable_x64(True):
        gold = jba.water_fill(jnp.asarray(total), max_mant, n_lines,
                              jnp.asarray(smr), jnp.asarray(lrms),
                              use_pallas=False)
        gold = [np.asarray(x) for x in gold]
    t = torch.from_numpy
    bits, left = K.water_fill(t(total), max_mant, t(n_lines), t(smr),
                              t(lrms))
    np.testing.assert_array_equal(bits.numpy(), gold[0])
    np.testing.assert_array_equal(left.numpy(), gold[1])
