"""chip_smoke.py's own logic on the CPU: with no CUDA device it refuses to
run; its main-path, fixture, throughput, device-parse and aidan phases pass
on the CPU with the kernels' plain versions on short files (phase 1 needs
the card)."""

import json

import numpy as np
import pytest
import torch

import chip_smoke
from pactpu_torch import Engine


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


KERNELS = {"extract_codes", "water_fill", "pack_words", "spread_maskers_up",
           "huffman_walk", "spread_maskers"}


def test_phases_on_cpu(monkeypatch, capsys):
    monkeypatch.setattr(chip_smoke, "DEV", "cpu")
    eng = Engine(device="cpu", chunk_blocks=16)
    eng_dev = Engine(device="cpu", chunk_blocks=16, decode_parse="device")
    files = [chip_smoke.synth(0.5, 1), chip_smoke.synth(0.25, 2)]
    launches, streams, host_pcm = chip_smoke.phase2(torch, eng, files)
    assert set(launches) == KERNELS
    assert len(streams) == len(host_pcm) == 2
    chip_smoke.phase3(eng)
    chip_smoke.phase4(torch, eng, eng_dev, files[1:], streams[1:])
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    assert [x["phase"] for x in lines] == ["2-main-path", "3-fixture",
                                           "4-throughput"]
    assert lines[0]["blocks"] == [23, 12]
    assert lines[1]["max_lsb"] <= 1
    assert len(lines[2]["decode_device_parse_blocks_per_s"]) == 6


def test_new_phases_on_cpu(monkeypatch, capsys):
    """Phase 5 (device-parse decode) and phase 6 (aidan modes)."""
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
        "5-device-parse", "6-aidan", "6-aidan", "6-aidan-fixture"]
    assert "channel-block 0" in lines[0]["corrupt"]
    assert lines[0]["fixture_max_lsb"] <= 1
    assert [x["mode"] for x in lines[1:3]] == ["para", "weighted"]
    assert lines[3]["max_lsb"] <= 1


def test_kernel_tables_agree():
    from pactpu_torch.ops import kernels as K
    assert set(chip_smoke.REPLACES) == set(chip_smoke.PATH_OF) == KERNELS
    assert set(K.LAUNCHES) == set(K._C_FUNCS) == KERNELS
    assert {src for src, _ in chip_smoke.REPLACES.values()} == set(K.SOURCES)


def test_main_path_inputs_on_cpu():
    """Phase 1's K4 and K2 inputs at a small chunk: the shapes the wrappers
    take, a peak in every row's reach, and the edge rows of K2 (a zero
    budget spends nothing, a huge one reaches the 16-bit cap)."""
    from pactpu_torch.codec.engine import device_tables
    from pactpu_torch.ops import kernels as K
    eng = Engine(device="cpu")
    chunk = chip_smoke.main_path_inputs(
        torch, device_tables(eng.cfg, "cpu"), chip_smoke.synth(2.0, 4),
        blocks=80)
    iprime, mspl, bark, zvec = chunk["k4"]
    assert iprime.shape == mspl.shape == (480, 1024)
    assert bark.shape == zvec.shape == (1024,)
    assert chunk["variants"].shape[0] == chunk["drops"].shape[0] == 480
    out = K.spread_maskers_up(*chunk["k4"])
    assert out.shape == (480, 1024) and bool((out >= 0).all())
    assert bool((out > 0).any(1).all())
    total, cap, n_lines, smr, lrms = chunk["k2"]
    assert cap == 16 and smr.shape == lrms.shape == (80, 25)
    bits, left = K.water_fill(*chunk["k2"])
    assert not bits[:16].any() and int(bits[32:48].max()) == 16
    assert bool((left >= 0).all())


def test_edge_inputs_are_seeded():
    """The card's tests and the CPU's see the same edge inputs."""
    for make, names in ((chip_smoke.k4_edge, chip_smoke.K4_EDGES),
                        (chip_smoke.k2_edge, chip_smoke.K2_EDGES)):
        for name in names:
            for a, b in zip(make(name), make(name)):
                np.testing.assert_array_equal(a, b)
