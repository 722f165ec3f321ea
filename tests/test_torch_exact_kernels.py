"""The exact mode's kernels' plain versions on the CPU against pactpu:

- K10's plain version (kernels.cost_table_plain, and the wrapper on a CPU
  tensor) integer-equal to pactpu.codec.exact.cost_table_body on the same
  MDCT lines, made from a seed with numpy, in float64, mono, with a table
  set trained by pactpu_torch.ops.huffman_train (chip_smoke.
  trained_tables), on the 20-band layout
  and with 6 mantissa-size bits (the default, stereo float32, is
  tests/test_torch_exact.py's);
- the wrapper's refusals;
- K7's shorter chain (kernels.water_fill_row_jump_plain, the jump its
  kernel takes) giving water_fill_row_plain's bits and leftover on 2,000
  seeded rows at 25, 40 and 96 bands, budgets from 0 past the cap, with
  ties, -0.0, NaN, +inf, keys down to the retired bands' and zero-line
  bands, in both types, and on chip_smoke.k2_edge's rows; and
  exact_scan_plain with the jump giving the greedy steps' extras and
  carry on the committed fixture's PCM.

The kernels themselves run on the card: tests/test_torch_cuda.py and
chip_smoke.py phase 1."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from pactpu.codec import exact as jx
from pactpu.utils.config import CodecConfig
from pactpu_torch.codec import engine as te
from pactpu_torch.codec import exact as tx
from pactpu_torch.ops import huffman
from pactpu_torch.ops import kernels as K
from pactpu_torch.utils.config import CodecConfig as TorchConfig
from test_torch_generality import LIMITS_20
from torch_threads import torch_threads  # noqa: F401 (autouse)

BLOCKS = 6


def mdct_lines(cfg, dtype, seed: int = 5) -> np.ndarray:
    """[BLOCKS, C, half] lines spread over eight decades with random signs,
    one loud line a band in some blocks, and the edges the quantizers
    treat apart: exact zeros and -0.0 (a whole silent band in block 1),
    lines at and past 1.0 (overload), and subnormal-small lines."""
    rng = np.random.default_rng(seed)
    shape = (BLOCKS, cfg.n_channels, cfg.n_mdct_lines)
    mag = 10.0 ** rng.uniform(-8.0, -0.3, shape)
    x = np.where(rng.random(shape) < 0.5, -mag, mag)
    x[0, :, ::37] *= 40.0
    x[1, :, 40:80] = 0.0
    x[1, :, 41] = -0.0
    x[2, 0, 5] = 1.0
    x[2, -1, 300] = -1.7
    x[3, :, 7:9] = 1e-38
    return np.clip(x, -2.0, 2.0).astype(dtype)


VARIANTS = {
    "f64": (dict(), "f64", None),
    "mono": (dict(n_channels=1), "f32", None),
    "trained-tables": (dict(), "f32", "trained"),
    "20-bands": (dict(band_limits=LIMITS_20), "f32", None),
    "6-size-bits": (dict(n_mant_size_bits=6), "f32", None),
}


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_cost_table_plain_equals_pactpu(variant):
    fields, precision, tabs = VARIANTS[variant]
    cfg, jcfg = TorchConfig(**fields), CodecConfig(**fields)
    dtype = np.float64 if precision == "f64" else np.float32
    mixed = mdct_lines(cfg, dtype)
    tables = (chip_smoke.trained_tables() if tabs == "trained"
              else tuple(np.asarray(t, np.int32)
                         for t in huffman.load_tables()))
    with jax.enable_x64(precision == "f64"):
        gold = np.asarray(jx.cost_table_body(jcfg, precision)(
            dict(mixed=jnp.asarray(mixed)), dict(tabs=tables)))
    dev = te.device_tables(cfg, "cpu", precision)
    lens, esc = torch.from_numpy(tables[0]), torch.from_numpy(tables[2])
    args = (torch.from_numpy(mixed), dev["lay"], lens, esc,
            cfg.n_scale_bits, tx.max_mant(cfg))
    plain = K.cost_table_plain(*args)
    assert plain.dtype == torch.int32 and plain.shape == gold.shape
    np.testing.assert_array_equal(plain.numpy(), gold)
    # the wrapper takes the plain version for a CPU tensor
    assert torch.equal(K.cost_table(*args), plain)
    assert not plain[:, :, :, 0].any() and plain.sum() > 0
    assert K.LAUNCHES["cost_table"] == 0


def test_cost_table_refuses():
    cfg = TorchConfig()
    dev = te.device_tables(cfg, "cpu")
    lens, _, esc, _ = dev["tabs"]
    mixed = torch.zeros((2, 2, cfg.n_mdct_lines))
    with pytest.raises(TypeError):
        K.cost_table(mixed.half(), dev["lay"], lens, esc, 4, 16)
    with pytest.raises(TypeError):
        K.cost_table(mixed, dev["lay"], lens.long(), esc, 4, 16)
    with pytest.raises(ValueError, match="table shapes"):
        K.cost_table(mixed, dev["lay"], lens, esc[:3], 4, 16)
    with pytest.raises(ValueError, match="contiguous"):
        K.cost_table(mixed.transpose(0, 1), dev["lay"], lens, esc, 4, 16)


def jump_rows(n_bands: int, rows: int, seed: int):
    """Seeded rows for the fill: (total, n_lines, smr, ms, ms_stop,
    lr_stop).  SMRs around 10 dB, ties (a row of one value, pairs of
    equal values), -0.0 and +0.0, a NaN band, +inf, SMRs at which the keys
    reach the retired bands' -1e30, zero-line bands, budgets from 0 past
    the cap (16 bits on every line) and stop thresholds that bind."""
    rng = np.random.default_rng(seed)
    out = []
    for r in range(rows):
        nl = rng.integers(1, 3 * 1024 // n_bands, n_bands)
        if r % 7 == 0:
            nl[rng.integers(0, n_bands, 3)] = 0           # zero-line bands
        smr = rng.normal(10.0, 15.0, n_bands)
        kind = r % 11
        if kind == 1:
            smr[:] = 20.0                                 # all tied
        elif kind == 2:
            smr[::2] = smr[1::2][:len(smr[::2])] if n_bands % 2 == 0 \
                else smr[0]                               # pairs
        elif kind == 3:
            smr[rng.integers(0, n_bands, 4)] = 0.0
            smr[rng.integers(0, n_bands, 4)] = -0.0
        elif kind == 4:
            smr[rng.integers(0, n_bands)] = np.nan
        elif kind == 5:
            smr[rng.integers(0, n_bands)] = np.inf
        elif kind == 6:
            smr[rng.integers(0, n_bands)] = -1e30 + 60.0 * (r % 2)
        elif kind == 7:
            smr = np.round(smr / 6.0) * 6.0               # keys tie across
        total = int(rng.choice([0, 1, int(rng.integers(0, 18 * nl.sum() + 2)),
                                int(rng.integers(1500, 3000)),
                                17 * int(nl.sum())]))
        ms_stop, lr_stop = ((-5.0, -15.0) if r % 5 else
                            tuple(rng.uniform(-20.0, 30.0, 2)))
        out.append((total, [int(v) for v in nl], smr,
                    list(rng.random(n_bands) < 0.4), ms_stop, lr_stop))
    return out


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n_bands,rows", [(25, 600), (40, 300), (96, 100)])
def test_jump_equals_steps(n_bands, rows, dtype):
    """water_fill_row_jump_plain gives water_fill_row_plain's bits and
    leftover on 2,000 seeded rows (1,000 a type), and jumps on most."""
    stats = dict(steps=0)
    for total, nl, smr, ms, ms_stop, lr_stop in jump_rows(
            n_bands, rows, n_bands):
        s = torch.from_numpy(smr).to(dtype)
        want = K.water_fill_row_plain(total, 16, nl, s, ms, ms_stop, lr_stop)
        got = K.water_fill_row_jump_plain(total, 16, nl, s, ms, ms_stop,
                                          lr_stop, stats)
        assert got == want, (total, nl, smr.tolist(), ms, ms_stop, lr_stop)
    assert stats["jumped"] > 0 and stats["probes"] > 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("name", chip_smoke.K2_EDGES)
def test_jump_on_k2_edges(name, dtype):
    """Both fills on chip_smoke.k2_edge's rows (K2's edge inputs: ties,
    -0.0, one band, 32 and 40 bands, caps, zero budgets, ...)."""
    total, max_mant, n_lines, smr, lrms = chip_smoke.k2_edge(name)
    s = torch.from_numpy(np.asarray(smr)).to(dtype)
    nl = [int(v) for v in np.asarray(n_lines)]
    for r in range(s.shape[0]):
        ms = [bool(v) for v in np.asarray(lrms)[r]]
        args = (int(total[r]), int(max_mant), nl, s[r], ms, -5.0, -15.0)
        assert (K.water_fill_row_jump_plain(*args)
                == K.water_fill_row_plain(*args)), (name, r)


def test_exact_scan_jump_equals_steps_on_fixture():
    """exact_scan_plain with the jump (as K7 fills) gives the greedy
    steps' extras and carry on the committed fixture's PCM (a stereo
    chunk from a nonzero carry), in both types, with fewer steps."""
    with np.load(chip_smoke.FIXTURE) as z:
        pcm = z["pcm"]
    for precision in ("f32", "f64"):
        cfg = TorchConfig()
        dev = te.device_tables(cfg, "cpu", precision)
        blocks = min(24, chip_smoke.n_blocks(pcm))
        a7 = list(chip_smoke.k7_args(torch, cfg, dev, pcm, blocks))
        a7[4] = torch.tensor([5000, -37], dtype=torch.int32)
        steps, jumped = dict(steps=0, fills=0), dict(steps=0, fills=0)
        want = K.exact_scan_plain(*a7, stats=steps, jump=False)
        got = K.exact_scan_plain(*a7, stats=jumped)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
        assert jumped["steps"] < steps["steps"]
        assert jumped["fills"] == 2 * blocks
