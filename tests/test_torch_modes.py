"""PyTorch port, the codec modes beside the main path, against pactpu on
the CPU: the KBD window, the mono SMRs, the bit-allocation M/S decision,
the baseline .pac coder (its tail, its payload bytes, its device parse by
kernel K1, corrupt rows included) and, stream by stream, mono .wak, stereo
and mono .pac, the KBD window and the bit-allocation decision: the port's
decode of pactpu's stream within 1 LSB, and the port's own stream within
0.1 dB SNR and 1% size of pactpu's."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from make_torch_port_fixture import fixture_pcm
from pactpu import native as jnative
from pactpu.codec import engine as je
from pactpu.compat import refcodec as rc
from pactpu.ops import bitalloc as jba
from pactpu.ops import huffman_decode as jhd
from pactpu.ops import psycho as jpsy
from pactpu.ops import windows as jwin
from pactpu.utils.config import CodecConfig
from pactpu_torch import Engine
from pactpu_torch import native as tnative
from pactpu_torch.codec import engine as te
from pactpu_torch.ops import bitalloc as tba
from pactpu_torch.ops import huffman_decode as thd
from pactpu_torch.ops import psycho as tpsy
from pactpu_torch.ops import windows as twin
from pactpu_torch.utils.config import CodecConfig as TorchConfig
from torch_threads import torch_threads  # noqa: F401 (autouse)

CHUNK = 16
# (CodecConfig fields, Engine fmt) of each mode of chip_smoke.py phase 7
MODES = {name: (fields, fmt) for name, fields, fmt in chip_smoke.MODES}
KEYS = ("overall", "tid", "ba", "sf", "mant", "lrms", "bad")

t = lambda a: torch.from_numpy(np.array(a))  # noqa: E731


def snr_db(ref, out):
    x = ref.astype(np.float64)
    e = x - out[:len(ref)].astype(np.float64)
    return 10 * np.log10((x * x).sum() / (e * e).sum())


def rows(stream: bytes) -> list:
    _, _, off = rc.read_header(stream)
    p, out, i = stream[off:], [], 0
    while i < len(p):
        n = int.from_bytes(p[i:i + 4], "little")
        out.append(p[i + 4:i + 4 + n])
        i += 4 + n
    return out


def mode_pcm(mode: str, seconds: float = 0.5) -> np.ndarray:
    """0.5 s of the fixture recipe (23 blocks: two 16-block chunks); the
    mono modes take its first channel."""
    pcm = fixture_pcm(seed=31, seconds=seconds)
    return np.ascontiguousarray(pcm[:, :MODES[mode][0].get("n_channels",
                                                           2)])


@pytest.fixture(scope="module")
def jax_streams():
    """pactpu's encode and decode of each mode's input, once per module."""
    out = {}
    for mode, (fields, fmt) in MODES.items():
        eng = je.Engine(cfg=CodecConfig(**fields), fmt=fmt,
                        chunk_blocks=CHUNK)
        pcm = mode_pcm(mode)
        stream = eng.encode(pcm)
        out[mode] = (pcm, stream, eng.decode(stream)[1])
    return out


@pytest.fixture(scope="module")
def dev():
    return te.device_tables(TorchConfig(), "cpu")


def test_kbd_window_matches():
    for n in (256, 2048):
        np.testing.assert_array_max_ulp(twin.kbd_window(n),
                                        jwin.kbd_window(n), 1)
        np.testing.assert_array_max_ulp(twin.analysis_window("kbd", n),
                                        jwin.analysis_window("kbd", n), 1)
    w = twin.kbd_window(2048)                       # Princen-Bradley
    np.testing.assert_allclose(w[:1024] ** 2 + w[1024:] ** 2, 1.0,
                               atol=1e-12)
    with pytest.raises(ValueError):
        twin.analysis_window("hann", 2048)


@pytest.mark.parametrize("peak_mode", ["ref", "weighted"])
def test_calc_smrs_matches(dev, peak_mode):
    """Mono SMRs of 12 seeded blocks within 0.05 dB of pactpu's, K4 on
    the reference peaks and K6 on the weighted ones."""
    from make_torch_port_fixture import pactpu_maskers_in_order
    cfg = CodecConfig(n_channels=1, peak_mode=peak_mode)
    frames = je.frame_blocks_np(fixture_pcm(seed=5, seconds=0.3)[:, :1],
                                1024, 12)
    consts = je.engine_consts_np(cfg)
    sw = np.asarray(je.q_ops.pcm16_to_float(jnp.asarray(frames[:, 0]))
                    * jwin.sine_window(2048).astype(np.float32))
    lines = np.asarray(je.mdct(jnp.asarray(sw), consts["basis"]))
    overall = np.asarray(je.q_ops.scale_factor(
        jnp.max(jnp.abs(lines), axis=-1), cfg.n_scale_bits, 5))
    scaled = np.asarray(lines * jnp.exp2(overall[:, None].astype(
        jnp.float32)))
    with pactpu_maskers_in_order():
        ref = np.asarray(jpsy.calc_smrs(
            sw, scaled, overall, 44100, cfg.band_layout,
            consts=consts["psy"], peak_mode=peak_mode))
    mine = tpsy.calc_smrs(t(sw), t(scaled), t(overall.astype(np.int32)),
                          dev["psy"], dev["lay"], 44100, peak_mode)
    np.testing.assert_allclose(mine.numpy(), ref, atol=0.05, rtol=0)


def test_lrms_decision_bitalloc_matches():
    """Given the same SMRs of both codings, the per-band decision is
    pactpu's bit for bit (four codings a block water-filled in one K2
    call), seeded SMRs plus ties and silent bands."""
    rng = np.random.default_rng(8)
    cfg = CodecConfig()
    b, nb = 24, cfg.n_bands
    smr_lr = rng.uniform(-30, 40, (b, 2, nb)).astype(np.float32)
    smr_ms = (smr_lr + rng.normal(0, 6, (b, 2, nb))).astype(np.float32)
    smr_ms[:4] = smr_lr[:4]                          # equal costs: L/R
    smr_lr[4:8, :, 20:] = smr_ms[4:8, :, 20:] = -60.0
    n_lines = cfg.band_layout.n_lines_array
    args = (int(cfg.bit_budget()), 16, cfg.ms_stop_threshold_db,
            cfg.lr_stop_threshold_db)
    ref = np.asarray(jba.lrms_decision_bitalloc(smr_lr, smr_ms, n_lines,
                                                *args))
    mine = tba.lrms_decision_bitalloc(t(smr_lr), t(smr_ms),
                                      t(n_lines.astype(np.int32)), *args)
    np.testing.assert_array_equal(mine.numpy(), ref)
    assert ref.any() and not ref.all() and not ref[:4].any()


@pytest.mark.parametrize("n_channels", [1, 2])
def test_finalize_baseline_bit_identical(dev, n_channels):
    """Given pactpu's analysis (its mono analysis of every channel-block,
    the computation encode_body_baseline runs), the port's baseline tail
    gives pactpu encode_body_baseline's integer outputs bit for bit, and
    the payload both serialize from them is the same bytes."""
    cfg = CodecConfig(n_channels=n_channels)
    pcm = fixture_pcm(seed=9, seconds=0.35)[:, :n_channels]
    frames = je.frame_blocks_np(pcm, 1024, 16)
    consts = je.engine_consts_np(cfg)
    ref = {k: np.asarray(v) for k, v in je.encode_body_baseline(cfg)(
        jnp.asarray(frames), consts).items()}
    b, c = frames.shape[:2]
    mono = je.analyze_body(CodecConfig(n_channels=1))(
        jnp.asarray(frames.reshape(b * c, 1, -1)), consts)
    mine = te.finalize_baseline(
        TorchConfig(n_channels=n_channels),
        t(np.asarray(mono["mixed"]).reshape(b, c, -1)),
        t(np.asarray(mono["overall"]).reshape(b, c).astype(np.int32)),
        t(np.asarray(mono["smr"]).reshape(b, c, -1)), dev)
    for key in ("overall", "bits", "sf", "mant"):
        np.testing.assert_array_equal(mine[key].numpy(),
                                      ref[key].astype(np.int32), err_msg=key)
    assert int(ref["bits"].max()) > 0
    n_lines = np.asarray(cfg.band_layout.n_lines, np.int32)
    r2 = lambda a: np.asarray(a).reshape(b * c, *a.shape[2:])  # noqa: E731
    args = (n_lines, 4, 4, 0, r2(ref["overall"]), np.zeros(b * c, np.int32),
            r2(ref["bits"]), r2(ref["sf"]), np.zeros((b * c, 1024), np.int32),
            r2(ref["mant"]), r2(ref["nm_l"]), np.zeros((b, 25), np.int32))
    want = jnative.pack_file(*args, write_lrms=False, n_channels=c)
    assert tnative.pack_file(*args, write_lrms=False, n_channels=c) == want
    ours = {k: mine[k].numpy() for k in ("overall", "bits", "sf", "mant")}
    assert tnative.pack_file(
        n_lines, 4, 4, 0, r2(ours["overall"]), np.zeros(b * c, np.int32),
        r2(ours["bits"]), r2(ours["sf"]), np.zeros((b * c, 1024), np.int32),
        r2(ours["mant"]), r2(ours["bits"])[:, cfg.band_layout.line_to_band],
        np.zeros((b, 25), np.int32), write_lrms=False, n_channels=c) == want


def _corrupt(words, nbits):
    """Row 0 zeroed with nbits 0 (padding), row 1 cut short, every third
    row from 3 on with one word XORed with random bits."""
    words, nbits = words.copy(), nbits.copy()
    words[0], nbits[0] = 0, 0
    nbits[1] = 40
    rng = np.random.default_rng(2)
    for r in range(3, words.shape[0], 3):
        w = rng.integers(0, max(1, nbits[r] // 32))
        words[r, w] ^= np.uint32(rng.integers(1, 1 << 32))
    return words, nbits


@pytest.mark.parametrize("mutate", ["clean", "corrupt"])
def test_pac_device_parse_matches(jax_streams, dev, mutate):
    """The .pac layout's device parse (a band loop and one mantissa launch
    of K1; on the CPU its plain version) equals pactpu's parse_rows_body
    (huff=False) bit for bit in all seven outputs, and on clean rows the
    host parser's fields."""
    stream = jax_streams["stereo-pac"][1]
    cfg, _, off = rc.read_header(stream)
    words, nbits = thd.frame_rows(stream[off:])
    if mutate == "corrupt":
        words, nbits = _corrupt(words, nbits)
    ref = jhd.parse_rows_fn(cfg, False)(words, nbits, None)
    got = thd.parse_rows_raw(TorchConfig(), t(words.view(np.int32)),
                             t(nbits), dev["lay"])
    for k in KEYS:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(ref[k]),
                                      err_msg=k)
    if mutate == "corrupt":
        assert bool(got["bad"][1]) and not got["bad"][0]
    else:
        assert not got["bad"].any()
        host = tnative.unpack_file(stream[off:], np.asarray(
            cfg.band_layout.n_lines, np.int32), 4, 4, 0, read_lrms=False)
        for k in ("overall", "ba", "sf", "mant"):
            np.testing.assert_array_equal(got[k].numpy(), host[k])


@pytest.mark.parametrize("route", ["host", "device"])
@pytest.mark.parametrize("mode", ["mono-wak", "stereo-pac", "mono-pac"])
def test_decode_within_1_lsb(jax_streams, mode, route):
    """The port decodes pactpu's stream within 1 LSB of pactpu's decode,
    by either parse route."""
    pcm, stream, gold = jax_streams[mode]
    fields, fmt = MODES[mode]
    fs, out = Engine(device="cpu", cfg=TorchConfig(**fields), fmt=fmt,
                     chunk_blocks=CHUNK, decode_parse=route).decode(stream)
    assert fs == 44100 and out.shape == gold.shape == pcm.shape
    d = np.abs(out.astype(np.int32) - gold.astype(np.int32))
    assert int(d.max()) <= 1 and (d == 0).mean() >= 0.999


@pytest.mark.parametrize("mode", list(MODES))
def test_stream_matches_pactpu(jax_streams, mode):
    """The port's own stream of the same input: SNR within 0.1 dB and size
    within 1% of pactpu's, nearly every channel-block byte-identical;
    both parse routes give the same samples."""
    pcm, gold, gold_pcm = jax_streams[mode]
    fields, fmt = MODES[mode]
    kw = dict(device="cpu", cfg=TorchConfig(**fields), fmt=fmt,
              chunk_blocks=CHUNK)
    stream = Engine(**kw).encode(pcm)
    _, out = Engine(**kw).decode(stream)
    _, out_dev = Engine(**kw, decode_parse="device").decode(stream)
    np.testing.assert_array_equal(out, out_dev)
    assert abs(snr_db(pcm, out) - snr_db(pcm, gold_pcm)) <= 0.1
    assert abs(len(stream) - len(gold)) <= 0.01 * len(gold)
    rj, rt = rows(gold), rows(stream)
    assert len(rj) == len(rt) == pcm.shape[1] * (-(-pcm.shape[0] // 1024)
                                                 + 1)
    assert sum(a == b for a, b in zip(rj, rt)) >= 0.9 * len(rj)


@pytest.mark.parametrize("mode", ["mono-wak", "stereo-pac"])
def test_batch_and_range_equal_serial(mode):
    """roundtrip_many, encode_many and decode_range give what serial
    encode and decode give, in mono and in the .pac format."""
    fields, fmt = MODES[mode]
    eng = Engine(device="cpu", cfg=TorchConfig(**fields), fmt=fmt,
                 chunk_blocks=CHUNK)
    pcms = [mode_pcm(mode, 0.3), mode_pcm(mode, 0.2)]
    streams = [eng.encode(p) for p in pcms]
    outs = [eng.decode(s)[1] for s in streams]
    results, batch = eng.roundtrip_many(pcms, return_streams=True)
    assert batch == streams == eng.encode_many(pcms)
    for (_, out), gold in zip(results, outs):
        np.testing.assert_array_equal(out, gold)
    _, window = eng.decode_range(streams[0], 3000, 5000)
    np.testing.assert_array_equal(window, outs[0][3000:8000])


def test_config_checks():
    """The new modes are accepted; the four other allocators are accepted
    in cbr and reservoir and refused by the exact mode, as pactpu refuses
    them, and pactpu's own format checks hold."""
    for fields, fmt in MODES.values():
        Engine(device="cpu", cfg=TorchConfig(**fields), fmt=fmt)
    for alloc in ("closed_form", "uniform", "const_snr", "const_mnr"):
        for rate in ("cbr", "reservoir"):
            Engine(device="cpu", cfg=TorchConfig(alloc_mode=alloc),
                   rate_mode=rate)
        with pytest.raises(ValueError, match="water-filling trajectory"):
            Engine(device="cpu", rate_mode="exact",
                   cfg=TorchConfig(alloc_mode=alloc))
    Engine(device="cpu", rate_mode="exact")
    for fields in (dict(window="kbd"), dict(ms_decision="bitalloc")):
        with pytest.raises(ValueError, match="rate_mode='exact'"):
            Engine(device="cpu", rate_mode="exact", cfg=TorchConfig(**fields))
    with pytest.raises(ValueError, match="no reservoir"):
        Engine(device="cpu", rate_mode="exact", fmt="pac")
    with pytest.raises(ValueError, match="unknown format"):
        Engine(device="cpu", fmt="mp3")
    with pytest.raises(ValueError, match="n_channels"):
        Engine(device="cpu", cfg=TorchConfig(n_channels=3))
    with pytest.raises(ValueError):
        Engine(device="cpu").encode(np.zeros((100, 1), np.int16))
