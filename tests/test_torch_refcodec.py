"""The port's float64 oracle (pactpu_torch.compat.refcodec) against the JAX
package's (pactpu.compat.refcodec): the same bytes from encode_file and
the same samples from decode_file, stereo and mono, and the port's copy
reads the port's own config and Huffman tables."""

import numpy as np
import pytest

import chip_smoke
from pactpu.compat import refcodec as jrc
from pactpu.utils.config import CodecConfig
from pactpu_torch.compat import refcodec as trc
from pactpu_torch.ops.huffman import TABLES_PATH
from pactpu_torch.utils.config import CodecConfig as TorchConfig
from torch_threads import torch_threads  # noqa: F401 (autouse)


def mono_pcm() -> np.ndarray:
    """tests/test_exact_mode.py:146-153's mono signal."""
    rng = np.random.default_rng(9)
    n = 1024 * 12 + 333
    t = np.arange(n) / 44100.0
    sig = (np.sin(2 * np.pi * 440 * t) * 16000
           + rng.standard_normal(n) * 300)
    return np.clip(sig, -32768, 32767).astype(np.int16)[:, None]


@pytest.mark.parametrize("channels", [2, 1])
def test_encode_and_decode_equal(channels):
    if channels == 2:
        pcm = chip_smoke.synth(12 * 1024 / 44100, 5)
    else:
        pcm = mono_pcm()
    gold = jrc.encode_file(pcm, 44100, CodecConfig(n_channels=channels))
    mine = trc.encode_file(pcm, 44100, TorchConfig(n_channels=channels))
    assert mine == gold
    fs_j, out_j = jrc.decode_file(gold)
    fs_t, out_t = trc.decode_file(gold)
    assert fs_t == fs_j == 44100
    np.testing.assert_array_equal(out_t, out_j)


def test_reads_the_ports_own_tables_and_config():
    tables = trc.HuffmanTables()
    with np.load(TABLES_PATH) as z:
        np.testing.assert_array_equal(tables.lengths, z["lengths"])
        np.testing.assert_array_equal(tables.escape_codes, z["escape_codes"])
    cfg, n, _ = trc.read_header(trc.write_header(TorchConfig(), 5000)[0])
    assert isinstance(cfg, TorchConfig) and n == 5000
