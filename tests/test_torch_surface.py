"""PyTorch port, the rest of pactpu's Engine surface against pactpu:

- which CodecConfig x Engine arguments are accepted (a grid of every value
  each field takes and one it does not);
- Huffman table training (pactpu_torch.ops.huffman_train) array for array,
  Engine(tables=...) bit for bit from the same analysis, each package
  reading the other's saved table sets, and a table set outside kernel
  K5's LUT (host parse only);
- Engine(device_pack=False) (the same bytes), Engine(debug_checks=True)
  (pactpu's checks and messages), last_savings / last_measure /
  last_extras;
- the float64 aidan path (kernel K6's float64 form, here its plain
  version) against pactpu's float64 compact path, with pactpu's masker
  tuple in order (make_torch_port_fixture.pactpu_maskers_in_order);
- pactpu's allocator streams of tests/data/torch_port_fixture_alloc.npz,
  which chip_smoke.py decodes on the card against the float64 oracle:
  the oracle's decode and the port's are within 1 LSB of pactpu's."""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from make_torch_port_fixture import (ALLOC_MODES, PATH_ALLOC, RATE_MODES,
                                     fixture_pcm, pactpu_maskers_in_order,
                                     short_pcm)
from pactpu.codec import engine as je
from pactpu.ops import huffman_train as jht
from pactpu.ops import psycho as jpsy
from pactpu.utils.config import CodecConfig
from pactpu_torch.codec import engine as te
from pactpu_torch.compat import refcodec
from pactpu_torch.ops import huffman_train as tht
from pactpu_torch.ops import kernels as K
from pactpu_torch.ops import psycho as tpsy
from pactpu_torch.utils.config import CodecConfig as TorchConfig
from torch_threads import torch_threads  # noqa: F401 (autouse)

FS = 44100

# every value each field takes, and one it does not (peak_mode: below)
GRID = dict(alloc_mode=("water_fill", "closed_form", "uniform", "const_snr",
                        "const_mnr", "greedy"),
            peak_mode=("ref", "para", "weighted"),
            window=("sine", "kbd", "hann"),
            ms_decision=("intensity", "bitalloc", "energy"))
ENGINE_GRID = dict(precision=("f32", "f64", "f16"),
                   rate_mode=("cbr", "reservoir", "exact", "vbr"),
                   fmt=("wak", "pac", "mp3"))


def _accepts(make) -> bool:
    try:
        make()
    except (ValueError, TypeError):
        return False
    return True


def test_config_grid_accepted_where_pactpu_accepts():
    """The port's Engine accepts a CodecConfig x Engine argument combination
    exactly where pactpu's Engine does (5,832 combinations)."""
    keys, ekeys = list(GRID), list(ENGINE_GRID)
    accepted = 0
    for vals in itertools.product(*GRID.values()):
        fields = dict(zip(keys, vals))
        for evals in itertools.product(*ENGINE_GRID.values()):
            kw = dict(zip(ekeys, evals))
            gold = _accepts(lambda: je.Engine(cfg=CodecConfig(**fields),
                                              **kw))
            mine = _accepts(lambda: te.Engine(
                device="cpu", cfg=TorchConfig(**fields), **kw))
            assert mine == gold, (fields, kw)
            accepted += gold
    assert 0 < accepted < 6 * 3 * 3 * 3 * 3 * 4 * 3


def test_unknown_peak_mode():
    """An unknown peak picker: pactpu's Engine takes it and fails at its
    first encode; the port refuses it at once."""
    eng = je.Engine(cfg=CodecConfig(peak_mode="parabolic"))
    with pytest.raises(ValueError, match="parabolic"):
        eng.encode(short_pcm()[:2048])
    with pytest.raises(ValueError, match="parabolic"):
        te.Engine(device="cpu", cfg=TorchConfig(peak_mode="parabolic"))


# -- Huffman table training -----------------------------------------------

def _histograms():
    """Per-table histograms: a skewed one, one with symbols below
    LOW_FREQ (they fold into the escape), an escape-only one (every count
    below LOW_FREQ), an empty one, and a missing id (3)."""
    rng = np.random.default_rng(11)
    skew = np.zeros(tht.NUM_SYMBOLS, np.int64)
    np.add.at(skew, np.minimum(rng.geometric(0.05, 200_000), 3000), 1)
    sparse = np.zeros(tht.NUM_SYMBOLS, np.int64)
    sparse[rng.integers(0, 4000, 300)] = rng.integers(1, 40, 300)
    few = np.zeros(tht.NUM_SYMBOLS, np.int64)
    few[[1, 5, 9]] = [3, 9, 2]
    return {1: skew, 2: sparse, 4: few, 5: np.zeros(tht.NUM_SYMBOLS,
                                                      np.int64)}


def test_symbol_histogram_matches():
    rng = np.random.default_rng(2)
    syms = rng.integers(-1, 600, (37, 1024)).astype(np.int32)
    transmit = rng.random((37, 1024)) < 0.8
    for tr in (None, transmit):
        gold = np.asarray(jht.symbol_histogram(
            jnp.asarray(syms), None if tr is None else jnp.asarray(tr)))
        mine = tht.symbol_histogram(
            torch.from_numpy(syms),
            None if tr is None else torch.from_numpy(tr)).numpy()
        np.testing.assert_array_equal(mine, gold)


def test_train_tables_matches():
    gold = jht.train_tables(_histograms())
    mine = tht.train_tables(_histograms())
    assert len(mine) == len(gold) == 4
    for a, b in zip(mine, gold):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    assert mine[2][2] == 1 and mine[2][3] == 1      # ids 3 and 4: escape-only


def test_build_table_refuses_long_codes():
    freqs = np.zeros(64, np.int64)
    freqs[:40] = 2 ** np.arange(40) * 10            # a 39-deep tree
    with pytest.raises(ValueError, match="31 bits"):
        jht.build_table(freqs)
    with pytest.raises(ValueError, match="31 bits"):
        tht.build_table(freqs)


@pytest.fixture(scope="module")
def trained():
    """A table set trained from pactpu's own mantissas of the fixture input
    (as the allocator fixture trains it), and pactpu's chunk-0 analysis
    and cbr finalize outputs on it."""
    with np.load(PATH_ALLOC) as z:
        tabs = tuple(z[f"tables_{k}"] for k in
                     ("lengths", "codes", "escape_lengths", "escape_codes"))
    cfg = CodecConfig()
    pcm = fixture_pcm()
    glob = np.zeros((2, 17 * 1024), np.int16)
    glob[:, 1024:] = pcm[:16 * 1024].T
    eng = je.Engine(rate_mode="cbr", tables=tabs)
    consts = eng.consts()
    a = je._chunk_analyze_fn(cfg)(jnp.asarray(glob), consts)
    out = je._finalize_fn(cfg, pack_words=je.PACK_WORDS)(
        a, jnp.zeros(16, jnp.float32), consts)
    host = lambda d: {k: np.array(v) for k, v in d.items()}  # noqa: E731
    return dict(tabs=tabs, analysis=host(a), out=host(out))


def test_trained_tables_finalize_bit_identical(trained):
    """Given pactpu's analysis, an engine on the trained tables packs
    pactpu's words (and not the shipped tables' words)."""
    a = trained["analysis"]
    ta = dict(mixed=torch.from_numpy(a["mixed"]),
              smr=torch.from_numpy(a["smr"]),
              lrms=torch.from_numpy(a["lrms"]),
              overall=torch.from_numpy(a["overall"].astype(np.int32)))
    eng = te.Engine(device="cpu", rate_mode="cbr", tables=trained["tabs"])
    out = te.finalize(eng.cfg, ta, torch.zeros(16), eng.consts())
    gold = trained["out"]
    for key in ("tid", "savings", "nbits"):
        np.testing.assert_array_equal(out[key].numpy(),
                                      gold[key].astype(np.int64), key)
    np.testing.assert_array_equal(out["words"].numpy().view(np.uint32),
                                  gold["words"])
    shipped = te.finalize(eng.cfg, ta, torch.zeros(16),
                          te.device_tables(eng.cfg, "cpu"))
    assert not torch.equal(shipped["words"], out["words"])


def test_table_sets_cross_load(tmp_path, trained):
    """A set saved by either package loads in the other, array for array,
    and both engines encode the fixture input to the same bytes (cbr)."""
    pcm = short_pcm()
    mine_path, gold_path = tmp_path / "port.npz", tmp_path / "pactpu.npz"
    tht.save_tables(str(mine_path), *trained["tabs"])
    jht.save_tables(str(gold_path), *trained["tabs"])
    for path in (mine_path, gold_path):
        eng = te.Engine(device="cpu", rate_mode="cbr", tables=str(path))
        for a, b in zip(eng.tables, trained["tabs"]):
            np.testing.assert_array_equal(a, b)
    port = te.Engine(device="cpu", rate_mode="cbr", tables=str(gold_path))
    ref = je.Engine(rate_mode="cbr", tables=str(mine_path))
    stream = ref.encode(pcm)
    assert port.encode(pcm) == stream
    np.testing.assert_array_equal(port.decode(stream)[1],
                                  te.Engine(device="cpu", rate_mode="cbr",
                                            tables=trained["tabs"],
                                            decode_parse="device")
                                  .decode(stream)[1])


def test_tables_checks():
    """pactpu's checks of a table set: code lengths <= 31, escape >= 1."""
    lengths, codes, esc_len, esc_code = (np.array(t) for t in
                                         chip_smoke.unfit_tables())
    te.Engine(device="cpu", tables=(lengths, codes, esc_len, esc_code))
    bad = lengths.copy()
    bad[0, 7] = 32
    with pytest.raises(ValueError, match="31 bits"):
        te.Engine(device="cpu", tables=(bad, codes, esc_len, esc_code))
    esc = esc_len.copy()
    esc[3] = 0
    with pytest.raises(ValueError, match="escape code"):
        te.Engine(device="cpu", tables=(lengths, codes, esc, esc_code))


def test_unfit_tables_decode_by_host_parse_only():
    """A table set past the walk LUT's bounds decodes under "auto" and
    "host"; "device" raises, naming the host route."""
    pcm = short_pcm()
    tabs = chip_smoke.unfit_tables()
    stream = te.Engine(device="cpu", rate_mode="cbr", tables=tabs).encode(pcm)
    outs = [te.Engine(device="cpu", rate_mode="cbr", tables=tabs,
                      decode_parse=route).decode(stream)[1]
            for route in ("auto", "host")]
    np.testing.assert_array_equal(outs[0], outs[1])
    with pytest.raises(ValueError, match="decode_parse='host'"):
        te.Engine(device="cpu", rate_mode="cbr", tables=tabs,
                  decode_parse="device").decode(stream)
    shipped = te.Engine(device="cpu", rate_mode="cbr")
    np.testing.assert_array_equal(outs[0],
                                  shipped.decode(shipped.encode(pcm))[1])


def test_pac_water_fills_whatever_the_allocator():
    """The baseline .pac coder water-fills whatever alloc_mode says, as
    pactpu's does (pactpu/codec/engine.py:444-449): the same bytes."""
    pcm = short_pcm()
    want = te.Engine(device="cpu", fmt="pac").encode(pcm)
    for alloc in ("closed_form", "const_snr"):
        cfg = TorchConfig(alloc_mode=alloc)
        assert te.Engine(device="cpu", cfg=cfg, fmt="pac").encode(pcm) == want
    assert je.Engine(cfg=CodecConfig(alloc_mode="uniform"),
                     fmt="pac").encode(pcm) == want


# -- device_pack, debug_checks, last_* -------------------------------------

@pytest.mark.parametrize("chans", [2, 1], ids=["stereo", "mono"])
@pytest.mark.parametrize("rate", ["cbr", "reservoir", "exact"])
def test_host_packing_gives_the_same_bytes(rate, chans):
    pcm = short_pcm(chans)
    cfg = TorchConfig(n_channels=chans)
    packed = te.Engine(device="cpu", cfg=cfg, rate_mode=rate).encode(pcm)
    host = te.Engine(device="cpu", cfg=cfg, rate_mode=rate,
                     device_pack=False).encode(pcm)
    assert host == packed


def test_debug_checks_messages():
    """pactpu's three checks on the inputs of tests/test_debug.py:69-84."""
    good = dict(smr=np.zeros((4, 2, 25), np.float32))
    bad_smr = dict(smr=np.full((4, 2, 25), np.nan, np.float32))
    ok_bits = dict(bits=np.zeros((4, 2, 25), np.int8))
    hot_bits = dict(bits=np.full((4, 2, 25), 17, np.int8))
    one_bits = dict(bits=np.full((4, 2, 25), 2, np.int8))
    one_bits["bits"][2, 1, 3] = 1
    te._debug_check_encode([good], [ok_bits], 16, [4])
    for analyses, outs, match in (([bad_smr], [ok_bits], "non-finite"),
                                  ([good], [hot_bits], "out of"),
                                  ([good], [one_bits], "refund")):
        with pytest.raises(te.DebugCheckError, match=match) as mine:
            te._debug_check_encode(analyses, outs, 16, [4])
        with pytest.raises(je.DebugCheckError) as gold:
            je._debug_check_encode(analyses, outs, 16, [4])
        assert str(mine.value) == str(gold.value)
    # and on tensors, as the engine passes them
    with pytest.raises(te.DebugCheckError, match="block 2"):
        te._debug_check_encode(
            [{"smr": torch.zeros(4, 2, 25)}],
            [{"bits": torch.from_numpy(one_bits["bits"])}], 16, [4])


def test_debug_checks_clean_encode():
    pcm = short_pcm()
    assert (te.Engine(device="cpu", debug_checks=True).encode(pcm)
            == te.Engine(device="cpu").encode(pcm))


@pytest.mark.parametrize("rate", ["cbr", "reservoir"])
def test_last_observability_matches(rate):
    """last_savings, last_measure and last_extras after an encode equal
    pactpu's (last_measure only in reservoir mode)."""
    pcm = short_pcm()
    gold = je.Engine(rate_mode=rate)
    mine = te.Engine(device="cpu", rate_mode=rate)
    assert mine.last_savings is None and mine.last_extras is None
    assert gold.encode(pcm) == mine.encode(pcm)
    assert mine.last_savings == gold.last_savings
    np.testing.assert_array_equal(mine.last_extras, gold.last_extras)
    if rate == "reservoir":
        for a, b in zip(mine.last_measure, gold.last_measure):
            np.testing.assert_array_equal(a, b)
    else:
        assert mine.last_measure is None and gold.last_measure is None


# -- K6's float64 form (its plain version) ---------------------------------

@pytest.mark.parametrize("name", chip_smoke.K6_EDGES)
def test_spread_maskers_f64_edges_match_pactpu(name):
    """K6's plain version in float64 on the edge inputs against the
    one_chunk expression of pactpu.ops.psycho.masked_threshold in float64:
    rtol 1e-12 (the sum's order)."""
    args = [a.astype(np.float64) for a in chip_smoke.k6_edge(name)]
    mspl, lev, bark, valid, drop, zvec = args
    with jax.enable_x64(True):
        dz = jnp.asarray(zvec)[None, None, :] - jnp.asarray(bark)[:, :, None]
        onslope = jnp.where(jnp.abs(dz) > 0.5, jnp.abs(dz) - 0.5, 0.0)
        s_db = (jnp.asarray(mspl)[:, :, None]
                - jnp.asarray(drop)[:, None, None] - 27.0 * onslope
                + jnp.where(dz >= 0.0, jnp.asarray(lev)[:, :, None] * onslope,
                            0.0))
        log2_10_over_10 = jnp.asarray(np.log2(10.0) / 10.0, jnp.float64)
        gold = np.asarray(jnp.sum(jnp.exp2(log2_10_over_10 * (s_db - 96.0))
                                  * jnp.asarray(valid)[:, :, None], axis=1))
    mine = K.spread_maskers(*(torch.from_numpy(a) for a in args))
    assert mine.dtype == torch.float64
    np.testing.assert_allclose(mine.numpy(), gold, rtol=1e-12, atol=1e-300)


@pytest.fixture(scope="module")
def jax_f64_aidan():
    """pactpu's float64 analysis of one 16-block chunk in each aidan mode
    (the masker tuple in order), with the PCM it was made from."""
    pcm = chip_smoke.synth(15 * 1024 / FS, 3)
    glob = np.zeros((2, 17 * 1024), np.int16)
    glob[:, 1024:1024 + pcm.shape[0]] = pcm.T
    out = {}
    with pactpu_maskers_in_order(), jax.enable_x64(True):
        for mode in ("para", "weighted"):
            cfg = CodecConfig(peak_mode=mode)
            consts = je.Engine(cfg=cfg, precision="f64").consts()
            a = je._chunk_analyze_fn(cfg, "f64")(jnp.asarray(glob), consts)
            out[mode] = {k: np.array(v) for k, v in a.items()}
    return glob, out


@pytest.mark.parametrize("mode", ["para", "weighted"])
def test_f64_aidan_analysis_matches(jax_f64_aidan, mode):
    """The port's float64 aidan analysis (K6's float64 form's plain
    version) against pactpu's: integer decisions exact, MDCT lines within
    1e-13, SMRs within 1e-9 dB (tests/test_torch_f64.py's limits)."""
    glob, per_mode = jax_f64_aidan
    gold = per_mode[mode]
    cfg = TorchConfig(peak_mode=mode)
    dev = te.device_tables(cfg, "cpu", "f64")
    mine = te.analyze(cfg, te._overlap_frames(torch.from_numpy(glob), 1024),
                      dev)
    assert mine["smr"].dtype == torch.float64
    np.testing.assert_array_equal(mine["overall"].numpy(), gold["overall"])
    np.testing.assert_array_equal(mine["lrms"].numpy(), gold["lrms"])
    np.testing.assert_allclose(mine["mixed"].numpy(), gold["mixed"], rtol=0,
                               atol=1e-13)
    np.testing.assert_allclose(mine["smr"].numpy(), gold["smr"], rtol=0,
                               atol=1e-9)


def test_f64_compact_threshold_matches(jax_f64_aidan):
    """From pactpu's own float64 maskers, the port's compact threshold
    (K6's plain version in float64) against pactpu's float64 compact
    path: within 1e-9 dB."""
    glob, _ = jax_f64_aidan
    frames = te._overlap_frames(torch.from_numpy(glob), 1024)[:4, 0]
    dev = te.device_tables(TorchConfig(), "cpu", "f64")
    x = (frames.double() / 32768.0) * dev["win"]
    drop = np.asarray([15.0, 0.0, 15.0, 0.0])
    with jax.enable_x64(True):
        h, b, k = jpsy.aidan_peaks(jnp.asarray(x.numpy()), FS, "weighted")
        gold = np.asarray(jpsy.masked_threshold(
            jnp.asarray(x.numpy()), jnp.asarray(drop), FS,
            consts=je.engine_consts_np(CodecConfig(), "f64")["psy"],
            maskers=(h, k, b), up_coef=0.37))
    mine = tpsy.compact_threshold(
        *(torch.from_numpy(np.array(a)) for a in (h, k, b)),
        torch.from_numpy(drop), dev["psy"], 0.37)
    assert mine.dtype == torch.float64
    np.testing.assert_allclose(mine.numpy(), gold, rtol=0, atol=1e-9)


# -- pactpu's allocator streams --------------------------------------------

@pytest.mark.parametrize("rate", RATE_MODES)
@pytest.mark.parametrize("alloc", ALLOC_MODES)
def test_alloc_fixture_decodes(alloc, rate):
    """The port (both routes) and the float64 oracle decode pactpu's
    stream within 1 LSB of pactpu's decode; the SNR the fixture records is
    pactpu's."""
    with np.load(PATH_ALLOC) as z:
        stream = z[f"{alloc}_{rate}_stream"].tobytes()
        snr = float(z[f"{alloc}_{rate}_snr_db"])
    cfg = TorchConfig(alloc_mode=alloc)
    _, gold = je.Engine(cfg=CodecConfig(alloc_mode=alloc)).decode(stream)
    assert abs(chip_smoke.snr_db(fixture_pcm(), gold) - snr) < 1e-9
    _, oracle = refcodec.decode_file(stream)
    outs = [oracle] + [te.Engine(device="cpu", cfg=cfg, decode_parse=route)
                       .decode(stream)[1] for route in ("host", "device")]
    for out in outs:
        assert out.shape == gold.shape
        assert np.abs(out.astype(np.int32) - gold).max() <= 1
    np.testing.assert_array_equal(outs[1], outs[2])


def test_trained_fixture_stream(trained):
    """pactpu's cbr stream on its trained tables: the port decodes it by
    both routes within 1 LSB of pactpu's decode, and encodes the same
    input within 0.1 dB and 1% (from PCM the analysis, a float stage,
    parts; given pactpu's analysis the words are equal:
    test_trained_tables_finalize_bit_identical)."""
    with np.load(PATH_ALLOC) as z:
        stream = z["trained_cbr_stream"].tobytes()
    pcm = fixture_pcm()
    _, gold = je.Engine(rate_mode="cbr", tables=trained["tabs"]).decode(
        stream)
    engs = [te.Engine(device="cpu", rate_mode="cbr", tables=trained["tabs"],
                      decode_parse=route) for route in ("host", "device")]
    outs = [e.decode(stream)[1] for e in engs]
    np.testing.assert_array_equal(outs[0], outs[1])
    assert np.abs(outs[0].astype(np.int32) - gold).max() <= 1
    mine = engs[0].encode(pcm)
    assert abs(chip_smoke.snr_db(pcm, engs[0].decode(mine)[1])
               - chip_smoke.snr_db(pcm, gold)) <= 0.1
    assert abs(len(mine) - len(stream)) <= 0.01 * len(stream)
