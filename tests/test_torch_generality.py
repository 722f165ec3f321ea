"""The port away from 44.1 kHz at 2.27 bits/sample: other rates, bit rates,
band layouts, mantissa-size fields, each against pactpu on the 12,177-sample
two-tone signal of tests/test_variants.py:437-444.

Where the streams are byte-equal the case says so; at 48 kHz and 22.05 kHz
they part in a float stage of the analysis (ROADMAP queue 3 (f)): the
MDCT lines' summation order flips one mantissa at 48 kHz, the SMRs' FFT
and masker-sum rounding one allocation at 22.05 kHz.  Given pactpu's
analysis dict the port's finalize is bit-identical at both rates.  In
every case the port decodes pactpu's stream within 1 LSB."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from pactpu.codec import engine as je
from pactpu.ops import huffman_decode as jhd
from pactpu.utils.config import CodecConfig
from pactpu_torch.codec import engine as te
from pactpu_torch.ops import huffman_decode as hd
from pactpu_torch.ops import huffman_walk as hw
from pactpu_torch.utils.config import CodecConfig as TorchConfig
from torch_threads import torch_threads  # noqa: F401 (autouse)

LIMITS_20 = (150.0, 350.0, 550.0, 800.0, 1100.0, 1450.0, 1850.0, 2300.0,
             2800.0, 3400.0, 4100.0, 5000.0, 6100.0, 7400.0, 9000.0,
             11000.0, 13500.0, 16500.0, 20000.0, 24000.0)

# name: (CodecConfig fields, rate mode, format, byte-equal to pactpu)
CASES = {
    "4.93-bits": (dict(target_bits_per_sample=4.93), "reservoir", "wak",
                  True),
    "20-bands": (dict(band_limits=LIMITS_20), "cbr", "wak", True),
    "32k": (dict(sample_rate=32000), "cbr", "wak", True),
    "48k-mono-kbd": (dict(sample_rate=48000, n_channels=1, window="kbd"),
                     "reservoir", "wak", True),
    "48k-bitalloc": (dict(sample_rate=48000, ms_decision="bitalloc"), "cbr",
                     "wak", True),
    "48k-pac": (dict(sample_rate=48000), "reservoir", "pac", True),
    "6-size-bits": (dict(n_mant_size_bits=6), "reservoir", "wak", True),
    "96-bands": (dict(band_line_counts=chip_smoke.WIDE_BANDS), "reservoir",
                 "wak", True),
    "48k-reservoir": (dict(sample_rate=48000), "reservoir", "wak", False),
    "48k-cbr": (dict(sample_rate=48000), "cbr", "wak", False),
    "22k-reservoir": (dict(sample_rate=22050), "reservoir", "wak", False),
    "22k-cbr": (dict(sample_rate=22050), "cbr", "wak", False),
}


def tone(fs: int, chans: int, n: int = 12177) -> np.ndarray:
    """tests/test_variants.py:437-444's signal at n samples."""
    rng = np.random.default_rng(7)
    t = np.arange(n) / fs
    sig = (0.45 * np.sin(2 * np.pi * 440 * t)
           + 0.12 * np.sin(2 * np.pi * 2900 * t)
           + 0.02 * rng.standard_normal(n))
    cols = [sig, 0.7 * sig][:chans]
    return np.clip(np.stack(cols, 1) * 32767, -32768, 32767).astype(np.int16)


@pytest.mark.parametrize("name", list(CASES))
def test_case_against_pactpu(name):
    """Byte-equal streams where the case says so, else within 0.1 dB SNR and
    1% size (or byte-equal); the port decodes pactpu's stream within 1 LSB
    of pactpu's own decode and its own stream to the same length."""
    fields, rate, fmt, equal = CASES[name]
    pcm = tone(fields.get("sample_rate", 44100), fields.get("n_channels", 2))
    jeng = je.Engine(cfg=CodecConfig(**fields), rate_mode=rate, fmt=fmt,
                     chunk_blocks=16)
    teng = te.Engine(device="cpu", cfg=TorchConfig(**fields), rate_mode=rate,
                     fmt=fmt, chunk_blocks=16)
    gold, mine = jeng.encode(pcm), teng.encode(pcm)
    _, gold_pcm = jeng.decode(gold)
    _, mine_pcm = teng.decode(mine)
    if equal:
        assert mine == gold
    else:           # the recorded float parting (byte-equal passes too)
        snr = [chip_smoke.snr_db(pcm, x) for x in (mine_pcm, gold_pcm)]
        assert abs(snr[0] - snr[1]) <= 0.1
        assert abs(len(mine) - len(gold)) <= 0.01 * len(gold)
    _, cross = teng.decode(gold)
    assert cross.shape == gold_pcm.shape == mine_pcm.shape
    assert np.abs(cross.astype(np.int32) - gold_pcm.astype(np.int32)).max() \
        <= 1


@pytest.mark.parametrize("fs", [48000, 22050])
def test_parting_is_in_the_analysis(fs):
    """At 48 and 22.05 kHz the streams part in the analysis: its integer
    decisions (overall scale, LRMS flags) are equal, its floats (MDCT lines
    within 1e-6, SMRs within 0.05 dB) are not, and the port's finalize on
    pactpu's analysis dict gives pactpu's payload words bit for bit."""
    jcfg, tcfg = CodecConfig(sample_rate=fs), TorchConfig(sample_rate=fs)
    pcm = tone(fs, 2)
    glob = np.zeros((2, 17 * 1024), np.int16)
    glob[:, 1024:1024 + pcm.shape[0]] = pcm.T
    consts = je.Engine(cfg=jcfg, rate_mode="cbr").consts()
    a = je._chunk_analyze_fn(jcfg)(jnp.asarray(glob), consts)
    ja = {k: np.array(v) for k, v in a.items()}
    dev = te.device_tables(tcfg, "cpu")
    mine = te.analyze(tcfg, te._overlap_frames(torch.from_numpy(glob), 1024),
                      dev)
    np.testing.assert_array_equal(mine["overall"].numpy(), ja["overall"])
    np.testing.assert_array_equal(mine["lrms"].numpy(), ja["lrms"])
    np.testing.assert_allclose(mine["mixed"].numpy(), ja["mixed"], rtol=0,
                               atol=1e-6)
    np.testing.assert_allclose(mine["smr"].numpy(), ja["smr"], rtol=0,
                               atol=0.05)
    gold = je._finalize_fn(jcfg, pack_words=je.PACK_WORDS)(
        a, jnp.zeros(16, jnp.float32), consts)
    out = te.finalize(tcfg, dict(
        mixed=torch.from_numpy(ja["mixed"]), smr=torch.from_numpy(ja["smr"]),
        lrms=torch.from_numpy(ja["lrms"]),
        overall=torch.from_numpy(ja["overall"].astype(np.int32))),
        torch.zeros(16), dev)
    np.testing.assert_array_equal(out["words"].numpy().view(np.uint32),
                                  np.asarray(gold["words"]))
    np.testing.assert_array_equal(out["nbits"].numpy(),
                                  np.asarray(gold["nbits"]))


def test_six_size_bits_refused_on_the_device_route_only():
    """6 mantissa-size bits: encode and host parse run (test_case_against_
    pactpu holds them to pactpu); the device-parse route, whose walk holds
    5, refuses the stream with a clear message."""
    cfg = TorchConfig(n_mant_size_bits=6)
    stream = te.Engine(device="cpu", cfg=cfg, chunk_blocks=16).encode(
        tone(44100, 2, 4000))
    te.Engine(device="cpu", decode_parse="host").decode(stream)
    with pytest.raises(ValueError, match="mantissa-size bits"):
        te.Engine(device="cpu", decode_parse="device").decode(stream)


def test_walk_past_64_bands_matches_xla_walk():
    """K5's plain version under the 96-band layout (past the 64 bands its
    kernel once took by value), on a stream's rows and on random rows,
    equals pactpu's XLA walk in all seven outputs; the device route decodes
    the stream to the host route's samples."""
    fields = dict(band_line_counts=chip_smoke.WIDE_BANDS)
    tcfg = TorchConfig(**fields)
    stream = te.Engine(device="cpu", cfg=tcfg, chunk_blocks=16).encode(
        tone(44100, 2, 6000))
    payload = stream[te.read_header(stream)[2]:]
    words, nbits = hd.frame_rows(payload)
    rng = np.random.default_rng(96)
    garbage = rng.integers(0, 2 ** 32, words.shape, dtype=np.uint64).astype(
        np.uint32)
    for w in (words, garbage):
        ref = jhd.parse_rows_fn(CodecConfig(**fields), True)(
            w, nbits, jhd.build_lut())
        got = hw.parse_rows_walk(tcfg, w, nbits, None, "cpu")
        for key in ("overall", "tid", "ba", "sf", "mant", "lrms", "bad"):
            np.testing.assert_array_equal(got[key].numpy(),
                                          np.asarray(ref[key]), err_msg=key)
    _, host = te.Engine(device="cpu", cfg=tcfg,
                        decode_parse="host").decode(stream)
    _, device = te.Engine(device="cpu", cfg=tcfg,
                          decode_parse="device").decode(stream)
    np.testing.assert_array_equal(device, host)
