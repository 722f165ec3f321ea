"""The port's device-compute bench (pactpu_torch.utils.devbench) on the CPU
at a small size: pactpu's keys and stages (the reservoir scan among them;
the host replay the cluster keeps is timed under a key of its own), no
device metric from a CPU run,
and the GEMM FLOP count from shapes equal to what torch's FLOP counter
sees the stages run."""

import math

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from pactpu.utils import devbench as jdevbench
from pactpu_torch import CodecConfig, Engine
from pactpu_torch.codec import engine as E
from pactpu_torch.utils import devbench
from torch_threads import torch_threads  # noqa: F401 (autouse)

BLOCKS, ITERS = 16, 2


@pytest.fixture(scope="module")
def both():
    mine = devbench.measure_device_compute(
        blocks=BLOCKS, iters=ITERS,
        eng=Engine(device="cpu", rate_mode="reservoir"))
    gold = jdevbench.measure_device_compute(blocks=BLOCKS, iters=ITERS)
    return mine, gold


def test_keys_are_pactpus(both):
    mine, gold = both
    host_only = {"device", "reservoir_replay_host_ms", "peak_f32_flops",
                 "peak_of"}
    assert set(mine) == set(gold) | host_only
    assert set(mine["stage_ms"]) == set(gold["stage_ms"])
    assert set(mine["stage_gflops"]) == set(mine["stage_ms"])
    assert (mine["blocks"], mine["iters"], mine["device"]) == (
        BLOCKS, ITERS, "cpu")
    assert mine["method"].startswith("host clock")


def test_times_are_finite_and_consistent(both):
    mine = both[0]
    for name, ms in mine["stage_ms"].items():
        assert math.isfinite(ms) and ms > 0, name
    enc = sum(v for k, v in mine["stage_ms"].items()
              if not k.startswith("decode"))
    assert mine["encode_ms_per_chunk"] == pytest.approx(enc)
    assert mine["decode_ms_per_chunk"] == mine["stage_ms"]["decode"]
    assert mine["encode_blocks_per_s"] == pytest.approx(
        BLOCKS / enc * 1000)
    assert 0 < mine["reservoir_replay_host_ms"] < 1000
    # a CPU run names no device metric
    assert mine["encode_mfu_f32_pct"] is None
    assert mine["decode_mfu_f32_pct"] is None
    assert "spin_covered" not in mine


@pytest.mark.parametrize("fields", [{}, dict(n_channels=1),
                                    dict(peak_mode="para")])
def test_gemm_flops_from_shapes(fields):
    """gemm_flops equals the matrix-product FLOPs torch's counter records
    while analyze and decode_body run (stereo, mono, an aidan picker)."""
    cfg = CodecConfig(**fields)
    c, b = cfg.n_channels, BLOCKS
    dev = E.device_tables(cfg, "cpu")
    rng = np.random.default_rng(0)
    glob = (rng.standard_normal((c, (b + 1) * 1024)) * 3000).astype(np.int16)
    frames = E._overlap_frames(torch.from_numpy(glob), 1024)
    want = devbench.gemm_flops(cfg, b)
    with FlopCounterMode(display=False) as fc:
        E.analyze(cfg, frames, dev)
    assert fc.get_total_flops() == want["analyze"]
    i32 = dict(dtype=torch.int32)
    with FlopCounterMode(display=False) as fc:
        E.decode_body(cfg, torch.zeros((b, c, 25), **i32),
                      torch.zeros((b, c, 25), **i32),
                      torch.zeros((b, c, 1024), **i32),
                      torch.zeros((b, c), **i32),
                      torch.zeros((b, 25), dtype=torch.bool), dev)
    assert fc.get_total_flops() == want["decode"] == \
        want["decode_device_parse"]
    assert want["measure"] == want["reservoir_scan"] == want["finalize"] \
        == want["compact"] == 0
    # stereo with the reference picker: MDCT + the six-input masking product
    if not fields:
        assert want["analyze"] == 2 * b * 2 * 2048 * 1024 + \
            2 * 6 * b * 1024 * 1024
