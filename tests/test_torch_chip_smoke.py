"""chip_smoke.py's own logic on the CPU: with no CUDA device it refuses to
run; its main-path, fixture, throughput (one timing), device-parse, aidan,
modes, exact, allocator, stream, distribution and surface phases pass on
the CPU with the kernels' plain versions on short files (phase 1 needs the
card)."""

import json

import numpy as np
import pytest
import torch

import chip_smoke
from pactpu_torch import CodecConfig, Engine
from pactpu_torch.ops import bitpack
from torch_threads import torch_threads  # noqa: F401 (autouse)


def test_exits_nonzero_without_cuda(capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    assert chip_smoke.main() != 0
    assert '"ok"' not in capsys.readouterr().out


def test_synth_is_seeded():
    a, b = chip_smoke.synth(0.2, 3), chip_smoke.synth(0.2, 3)
    assert a.dtype == np.int16 and a.shape == (8820, 2)
    np.testing.assert_array_equal(a, b)
    assert not np.array_equal(a, chip_smoke.synth(0.2, 4))


KERNELS = {"extract_codes", "water_fill", "pack_words", "pack_payload",
           "spread_maskers_up", "huffman_walk", "spread_maskers",
           "exact_scan", "closed_form", "grant_fill", "cost_table",
           "reservoir_scan"}


def test_phases_on_cpu(monkeypatch, capsys):
    monkeypatch.setattr(chip_smoke, "DEV", "cpu")
    eng = Engine(device="cpu", chunk_blocks=16)
    eng_dev = Engine(device="cpu", chunk_blocks=16, decode_parse="device")
    files = [chip_smoke.synth(0.5, 1), chip_smoke.synth(0.25, 2)]
    launches, streams, host_pcm = chip_smoke.phase2(torch, eng, files)
    assert set(launches) == KERNELS
    assert len(streams) == len(host_pcm) == 2
    chip_smoke.phase3(eng)
    chip_smoke.phase4(torch, eng, eng_dev, files[1:], streams[1:], reps=1)
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    assert [x["phase"] for x in lines] == ["2-main-path", "3-fixture",
                                           "4-throughput"]
    assert lines[0]["blocks"] == [23, 12]
    assert lines[1]["max_lsb"] <= 1
    assert len(lines[2]["decode_device_parse_blocks_per_s"]) == 2


def test_modes_phase_on_cpu(monkeypatch, capsys):
    """Phase 7: every mode by both parse routes, roundtrip_many against
    serial, and the two JAX fixtures of the modes."""
    monkeypatch.setattr(chip_smoke, "DEV", "cpu")
    files = [chip_smoke.synth(0.3, 5), chip_smoke.synth(0.2, 6)]
    launches = chip_smoke.phase7(torch, lambda **kw: Engine(
        device="cpu", chunk_blocks=16, **kw), files)
    assert list(launches) == [m for m, _, _ in chip_smoke.MODES]
    assert all(set(n) == KERNELS for n in launches.values())
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    modes = [x for x in lines if x["phase"] == "7-modes"]
    assert [x["mode"] for x in modes] == list(launches)
    assert all(x["snr_db"] > chip_smoke.SNR_FLOOR_DB for x in modes)
    fixtures = [x for x in lines if x["phase"].startswith("7-modes-fixture")]
    assert len(fixtures) == 4 and all(x["max_lsb"] <= 1 for x in fixtures)
    assert all(x["rows_differing"] == 0 for x in fixtures if "rows" in x)


def test_mode_needs():
    """Phase 7's launch checks: K3 only on the .wak packer, K5 only on the
    .wak device-parse route, K1 on every decode."""
    wak, pac = chip_smoke.mode_needs("wak"), chip_smoke.mode_needs("pac")
    assert ("pack_payload" in wak["encode"]
            and "pack_payload" not in pac["encode"])
    assert "huffman_walk" in wak["decode-device"]
    assert pac["decode-device"] == pac["decode-host"] == ["extract_codes"]


def test_new_phases_on_cpu(monkeypatch, capsys):
    """Phase 5 (device-parse decode) and phase 6 (aidan modes, float32 and
    float64)."""
    monkeypatch.setattr(chip_smoke, "DEV", "cpu")
    eng = Engine(device="cpu", chunk_blocks=16)
    eng_dev = Engine(device="cpu", chunk_blocks=16, decode_parse="device")
    pcm = chip_smoke.synth(0.3, 3)
    stream = eng.encode(pcm)
    assert set(chip_smoke.phase5(torch, eng_dev, [stream],
                                 [eng.decode(stream)[1]])) == KERNELS
    chip_smoke.phase6(torch, lambda **kw: Engine(
        device="cpu", chunk_blocks=16, **kw), pcm)
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    assert [x["phase"] for x in lines] == [
        "5-device-parse", "6-aidan", "6-aidan", "6-aidan-fixture", "6-aidan",
        "6-aidan"]
    assert "channel-block 0" in lines[0]["corrupt"]
    assert lines[0]["fixture_max_lsb"] <= 1
    aidan = [x for x in lines if x["phase"] == "6-aidan"]
    assert [(x["mode"], x["precision"]) for x in aidan] == [
        ("para", "f32"), ("weighted", "f32"), ("para", "f64"),
        ("weighted", "f64")]
    assert lines[3]["max_lsb"] <= 1


def test_exact_phase_on_cpu(monkeypatch, capsys):
    """Phase 8 at a small size: the float32 exact mode with 16- and 32-block
    chunks (the same bytes) and its times beside the reservoir mode's, and
    the float64 exact mode on 8-block stereo and mono slices, byte-equal to
    the float64 oracle."""
    monkeypatch.setattr(chip_smoke, "DEV", "cpu")
    pcm = chip_smoke.synth(0.5, 9)
    launches = chip_smoke.phase8(torch, lambda **kw: Engine(
        device="cpu", **kw), pcm, chunks=(16, 32), slice_blocks=8, reps=1)
    assert set(launches) == KERNELS
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    assert [x["phase"] for x in lines] == ["8-exact-f32", "8-exact-f64",
                                           "8-exact-f64"]
    assert lines[0]["chunks"] == [16, 32] and lines[0]["blocks"] == 23
    assert len(lines[0]["encode_s_exact"]) == 2
    assert [x["slice"] for x in lines[1:]] == ["stereo", "mono"]
    assert all(x["identical"] and x["differing"] == 0 for x in lines[1:])


def test_alloc_phase_on_cpu(monkeypatch, capsys):
    """Phase 9 at a small size: each allocator in cbr and reservoir by both
    parse routes with roundtrip_many against serial, pactpu's streams of
    the allocator fixture, a trained table set, pactpu's trained-table
    stream, a table set outside the walk LUT (refused by device parse),
    device_pack=False and debug_checks=True."""
    monkeypatch.setattr(chip_smoke, "DEV", "cpu")
    files = [chip_smoke.synth(0.3, 5), chip_smoke.synth(0.2, 6)]
    launches = chip_smoke.phase9(torch, lambda **kw: Engine(
        device="cpu", chunk_blocks=16, **kw), files)
    assert list(launches) == [f"alloc-{a}" for a in chip_smoke.ALLOC_MODES]
    assert all(set(n) == KERNELS for n in launches.values())
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    alloc = [x for x in lines if x["phase"] == "9-alloc"]
    assert [(x["alloc"], x["rate_mode"]) for x in alloc] == [
        (a, r) for a in chip_smoke.ALLOC_MODES for r in ("cbr", "reservoir")]
    assert all(x["snr_db"] > chip_smoke.SNR_FLOOR_DB
               and x["fixture_max_lsb"] <= 1 for x in alloc)
    surface = [x for x in lines if x["phase"] == "9-surface"]
    assert len(surface) == 1
    assert "decode_parse='host'" in surface[0]["unfit_refusal"]
    assert surface[0]["host_pack_launches"]["pack_words"] == 0
    assert surface[0]["host_pack_launches"]["pack_payload"] == 0


def test_unfit_tables_break_the_walk_lut():
    """chip_smoke.unfit_tables: valid for the encoder and the host parser,
    outside K5's LUT."""
    from pactpu_torch.ops import huffman_walk as hw
    tabs = chip_smoke.unfit_tables()
    assert hw.build_walk_lut(tabs) is None
    assert hw.build_walk_lut(None) is not None


def test_first_difference_names_the_stage():
    """Phase 8's report on two streams that part: the channel-blocks that
    differ and the first field that does; and on two analyses."""
    from pactpu_torch import CodecConfig
    pcm = chip_smoke.synth(0.2, 4)
    a = Engine(device="cpu").encode(pcm)
    b = Engine(device="cpu", rate_mode="cbr").encode(pcm)
    same = chip_smoke.first_difference(a, a, CodecConfig())
    assert same == dict(channel_blocks=2 * chip_smoke.n_blocks(pcm),
                        differing=0)
    diff = chip_smoke.first_difference(a, b, CodecConfig())
    assert diff["differing"] > 0 and diff["stage"] in (
        "lrms", "overall", "ba", "sf", "table_id", "mant")
    # and the analyses of two engines that cut the file differently
    blocks, one = chip_smoke.file_analysis(
        torch, Engine(device="cpu", chunk_blocks=16), pcm)
    _, two = chip_smoke.file_analysis(
        torch, Engine(device="cpu", chunk_blocks=32), pcm)
    same = chip_smoke.analysis_difference(torch, one, two, blocks)
    assert same == dict(overall_equal=True, lrms_equal=True,
                        mixed_max_diff=0.0, smr_max_diff=0.0)
    two["smr"][3, 1, 4] += 0.5
    moved = chip_smoke.analysis_difference(torch, one, two, blocks)
    assert moved["smr_max_diff"] == 0.5 and moved["lrms_equal"]


def test_kernel_tables_agree():
    from pactpu_torch.ops import kernels as K
    # pack_words, K3's one-to-one form, is held and timed in phase 1 but
    # runs on no path: the kernels line names K3 by pack_payload
    assert (set(chip_smoke.REPLACES) == set(chip_smoke.PATH_OF)
            == KERNELS - {"pack_words"})
    assert set(K.LAUNCHES) == set(K._C_FUNCS) == KERNELS
    assert {src for src, _ in chip_smoke.REPLACES.values()} == set(K.SOURCES)


def test_main_path_inputs_on_cpu():
    """Phase 1's K1, K4, K2, K6 and K5 inputs at a small chunk: the shapes
    the wrappers take, K1's fields giving back the codes they were packed
    from, a peak in every row's reach, the edge rows of K2 (a zero budget
    spends nothing, a huge one reaches the 16-bit cap), K6's slots as a
    descending prefix, and K5's rows with their 64 corrupted copies."""
    from pactpu_torch.codec.engine import device_tables
    from pactpu_torch.ops import kernels as K
    eng = Engine(device="cpu")
    pcm = chip_smoke.synth(2.0, 4)
    chunk = chip_smoke.main_path_inputs(
        torch, device_tables(eng.cfg, "cpu"), pcm, blocks=80,
        stream=eng.encode(pcm))
    words1, off1, width1 = chunk["k1"]
    assert words1.shape == (160, 256) and off1.shape == width1.shape == (
        160, 1024)
    np.testing.assert_array_equal(
        K.extract_codes(*chunk["k1"]).numpy(), chunk["k1_mant"])
    iprime, mspl, bark, zvec = chunk["k4"]
    assert iprime.shape == mspl.shape == (480, 1024)
    assert bark.shape == zvec.shape == (1024,)
    out = K.spread_maskers_up(*chunk["k4"])
    assert out.shape == (480, 1024) and bool((out >= 0).all())
    assert bool((out > 0).any(1).all())
    total, cap, n_lines, smr, lrms = chunk["k2"]
    assert cap == 16 and smr.shape == lrms.shape == (80, 25)
    bits, left = K.water_fill(*chunk["k2"])
    assert not bits[:16].any() and int(bits[32:48].max()) == 16
    assert bool((left >= 0).all())
    m6, lev6, bark6, valid6, drop6, z6 = chunk["k6"]
    assert m6.shape == lev6.shape == bark6.shape == valid6.shape == (480, 513)
    assert drop6.shape == (480,) and z6.shape == (1024,)
    n_valid = valid6.sum(1).long()
    assert int(n_valid.min()) >= 1
    for r in (0, 100, 479):                    # a prefix, barks descending
        n = int(n_valid[r])
        assert bool(valid6[r, :n].all()) and not valid6[r, n:].any()
        assert bool((bark6[r, 1:n] <= bark6[r, :n - 1]).all())
    words5, lut5, lines5, *bits5 = chunk["k5"]
    assert words5.shape[0] == 160 + 64 and sum(lines5) == 1024
    assert chunk["k5_nbits"].shape == (224,) and bits5 == [4, 4, 4]
    rec = K.huffman_walk(*chunk["k5"])
    assert not rec[3][:160, 2].any()
    assert not torch.equal(rec[0][160:], rec[0][:64])    # the XORed copies
    fields = chunk["k3"]
    assert [tuple(f.shape) for f in fields] == [(160,)] * 2 + [(160, 25)] * 2 \
        + [(160, 1024)] * 3 + [(160, 25)]
    assert all(f.dtype == torch.int32 and f.is_contiguous() for f in fields)
    lay = (eng.cfg.band_layout.n_lines, 4, 4, 4)
    words, nbits = bitpack.pack_payload_bits(*fields, *lay, 256)
    assert bool((nbits <= 32 * 256).all()) and bool((nbits > 233).any())
    assert all(torch.equal(a, b) for a, b in zip(
        (words, nbits), chip_smoke.pack_prologue_and_k3(fields, eng.cfg, 256)))


def test_edge_inputs_are_seeded():
    """The card's tests and the CPU's see the same edge inputs."""
    for make, names in ((chip_smoke.k1_edge, chip_smoke.K1_EDGES),
                        (chip_smoke.k4_edge, chip_smoke.K4_EDGES),
                        (chip_smoke.k2_edge, chip_smoke.K2_EDGES),
                        (chip_smoke.k6_edge, chip_smoke.K6_EDGES),
                        (chip_smoke.k8_edge, chip_smoke.K8_EDGES),
                        (chip_smoke.k8_nonfinite, chip_smoke.K8_NONFINITE),
                        (chip_smoke.k8_wide, ("203-bands",)),
                        (chip_smoke.k9_edge, chip_smoke.K9_EDGES),
                        (chip_smoke.k11_edge, chip_smoke.K11_EDGES)):
        for name in names:
            for a, b in zip(make(name), make(name)):
                np.testing.assert_array_equal(a, b)
    for name in chip_smoke.K3_EDGES:
        n_lines = CodecConfig().band_layout.n_lines
        a, b = chip_smoke.k3_edge(name, n_lines), chip_smoke.k3_edge(
            name, n_lines)
        assert list(a) == list(chip_smoke.K3_KEYS)
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])
            assert a[k].dtype == np.int32
    for name in chip_smoke.K5_EDGES:
        a, b = chip_smoke.k5_edge(name), chip_smoke.k5_edge(name)
        np.testing.assert_array_equal(a["words"], b["words"])
        assert a["words"].dtype == np.uint32 and a["size_bits"] in (4, 5)


def test_stream_phase_on_cpu(monkeypatch, capsys):
    """Phase 10 at a small size: the four cuts of a 0.5 s file and a
    checkpoint, the streamed decodes, the exact stream, the faulted jobs
    and every CLI command."""
    from pactpu_torch.codec import cli
    monkeypatch.setattr(chip_smoke, "DEV", "cpu")
    monkeypatch.setattr(cli, "DEV", "cpu")
    pcm = chip_smoke.synth(0.5, 4)
    files = [chip_smoke.synth(s, k) for k, s in ((1, 0.3), (2, 0.25),
                                                (3, 0.2))]
    launches = chip_smoke.phase10(torch, lambda **kw: Engine(
        device="cpu", **kw), pcm, files, ckpt_block=10, segment_blocks=4,
        reps=1)
    assert set(launches) == KERNELS
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()
             if x.startswith("{")]
    assert [x["phase"] for x in lines] == ["10-stream", "10-cli"]
    assert list(lines[0]["splits"]) == ["700-1s", "1s", "10s", "mid-batch"]
    assert lines[0]["faults_injected"] == lines[0]["faults_absorbed"] == 6
    assert set(lines[1]["commands"]) == {
        "encode", "decode", "decode-range-device", "roundtrip-fleet",
        "stats", "debug", "bench", "batch", "train", "encode-tables",
        "decode-tables"}


def test_stream_splits_of_the_60s_file():
    """Phase 10's cuts of the 60 s file (2,585 blocks): 700-sample pieces
    over the first 40 blocks then 1 s pieces; 1 s pieces; 10 s pieces; and
    a boundary inside each of the Engine's five 512-block batches and its
    tail."""
    pcm = np.zeros((60 * chip_smoke.FS, 2), np.int16)
    cuts = chip_smoke.stream_splits(pcm)
    n = pcm.shape[0]
    assert all(c[0] == 0 and c[-1] == n for c in cuts.values())
    steps = np.diff(cuts["700-1s"])
    assert cuts["700-1s"][59] == 41300           # 59 pieces cover 40 blocks
    assert set(steps[:59]) == {700} and set(steps[59:-1]) == {chip_smoke.FS}
    assert len(steps) == 119
    assert len(cuts["1s"]) - 1 == 60
    assert len(cuts["10s"]) - 1 == 6
    assert [c // 1024 for c in cuts["mid-batch"][1:-1]] == [
        256, 768, 1280, 1792, 2304, 2572]


def test_distributed_phase_on_cpu(monkeypatch, capsys):
    """Phase 11 at a small size: a gloo group of one process with meshes
    of 1, 2 and 4 CPU shards, two spawned gloo processes of two shards, a
    1 s "long" file and devbench at 16 blocks."""
    monkeypatch.setattr(chip_smoke, "DEV", "cpu")
    launches = chip_smoke.phase11(
        torch, lambda **kw: Engine(device="cpu", **kw),
        chip_smoke.synth(0.5, 4), chip_smoke.synth(1.0, 5),
        bench_blocks=16, bench_iters=2, timeout_s=120)
    assert set(launches) == KERNELS
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()
             if x.startswith("{")]
    assert [x["phase"] for x in lines] == ["11-distributed", "11-devbench"]
    dist = lines[0]
    assert dist["shards"] == [1, 2, 4] and dist["backend"] == "gloo"
    assert len(dist["encode_s"]) == 9 and set(dist["decode"]) == {
        "1", "2", "4"}
    assert dist["long_cbr"]["shards_1_equal"]
    assert dist["long_cbr"]["shards_4_equal"]
    assert {k: len(v) for k, v in dist["cbr_turns_s"].items()} == {
        "engine": 2, "shards_1": 2, "shards_2": 2, "shards_4": 2}
    assert len(dist["long_cbr"]["engine"]) == 2
    assert dist["gloo"]["block_starts"] == [0, 12]
    assert set(dist["gloo"]["restart_cost"]) == {
        "engine_bytes", "two_process_bytes", "engine_snr_db",
        "two_process_snr_db"}
    assert lines[1]["blocks"] == 16 and lines[1]["device"] == "cpu"


def test_surface_phase_on_cpu(monkeypatch, capsys):
    """Phase 12 at a small size: the Engine's positional order, the
    chunked stream and its restore (4-block batches), the quantizers on
    4,096 values, the trainer and its table set's round trip, frame_blocks
    and stereo_smrs against the Engine's own first batch."""
    monkeypatch.setattr(chip_smoke, "DEV", "cpu")
    launches = chip_smoke.phase12(torch, chip_smoke.synth(0.5, 1),
                                  chip_smoke.synth(1.0, 4), n_values=4096,
                                  stream_chunk=4)
    assert set(launches) == KERNELS
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    assert [x["phase"] for x in lines] == ["12-surface"]
    out = lines[0]
    assert out["blocks"] == 23 and out["stream_pushes"] == 1
    assert set(out["quantizer_ulp"]) == {"dequantize_uniform"} | {
        f"fp_dequantize_{a}_{b}" for a, b in chip_smoke.FP_FORMATS}
    assert max(out["quantizer_ulp"].values()) == 0
    assert out["trained"]["symbols"] > 0
    assert out["trained"]["snr_db"] > chip_smoke.SNR_FLOOR_DB
    assert out["stereo_smrs_blocks"] == 64


def test_programs_phase_on_cpu(monkeypatch, capsys):
    """Phase 13 at a small size: on the CPU the stages run directly, so
    this holds the eager stage chain (eager_encode, eager_decode) to the
    Engine in both rate modes and parse routes, the dispatch half's bytes
    and the timing in turns; the program replays are the card's."""
    monkeypatch.setattr(chip_smoke, "DEV", "cpu")
    files = [chip_smoke.synth(0.5, 1), chip_smoke.synth(0.25, 2)]
    launches = chip_smoke.phase13(torch, lambda **kw: Engine(
        device="cpu", chunk_blocks=16, **kw), files, reps=1, buckets=(16,))
    assert set(launches) == KERNELS
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    assert [(x["phase"], x["rate"]) for x in lines] == [
        ("13-programs", "reservoir"), ("13-programs", "cbr")]
    res = lines[0]
    assert res["blocks"] == 23 + 12 and res["memory_mb"] is None
    assert res["captures"] == 0 and all(
        n == 0 for n in res["programs"].values())
    assert res["buckets_memory_mb"] is None and res["buckets_programs"] == 0
    for key in ("serial_programs", "serial_eager", "batch_programs",
                "batch_eager"):
        assert len(res[f"{key}_blocks_per_s"]) == 2
    assert res["sha256"] != lines[1]["sha256"]


def test_eager_chain_is_the_parents_engine():
    """eager_encode gives the Engine's bytes (the host replay's extras are
    K11's) on a file of two 16-block chunks and a tail."""
    pcm = chip_smoke.synth(1.0, 7)
    for rate in ("reservoir", "cbr"):
        eng = Engine(device="cpu", rate_mode=rate, chunk_blocks=16)
        assert chip_smoke.eager_encode(eng, pcm) == eng.encode(pcm)


def test_payload_helpers():
    """split_payload cuts a stream at a block; corrupt_table_id breaks one
    channel-block's table id and nothing else."""
    eng = Engine(device="cpu", rate_mode="cbr")
    stream = eng.encode(chip_smoke.synth(0.2, 3))
    header, a, b = chip_smoke.split_payload(stream, 2, 4)
    assert header + a + b == stream
    assert len(chip_smoke.rows_of(header + a)) == 8
    bad = chip_smoke.corrupt_table_id(stream, 3)
    diff = [i for i, (x, y) in enumerate(zip(bad, stream)) if x != y]
    assert len(bad) == len(stream) and len(diff) == 1
    assert bad[diff[0]] & 0x0F == 0x0F
    with pytest.raises(ValueError, match="corrupt"):
        Engine(device="cpu", decode_parse="device").decode(bad)
