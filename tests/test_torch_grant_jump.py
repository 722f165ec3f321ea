"""K9's shorter walk and K10's packed table set, on the CPU:

- kernels.grant_fill_jump_plain (the jump over the grants nothing can
  interrupt, then steps: the walk kernel K9 takes) bit-equal with
  grant_fill_plain (the steps alone) on seeded numpy rows at 25, 40 and 96
  bands, on every chip_smoke.k9_edge input, on zero-line bands whose
  budget runs out exactly and under step caps that cut the walk; and, at
  44.1 kHz (no zero-line band, so the `remaining > 0` guard never parts
  them: ROADMAP queue 3, fault (b)), both equal to pactpu's
  _greedy_noise_floor_batch;
- the constants K9 and K10 share with their plain versions and the pack
  (csrc/grant_fill.cu, csrc/cost_table.cu) read out of the sources;
- exact.packed_tables packs a device table set once and keeps it there;
- kernels.pack_tables: unpacking gives back every symbol's code length
  and the escape lengths, and the set covers the symbols up to the last
  one any table codes, for the shipped set, a trained one, one with codes
  on every symbol and random sets of 1 to 16 tables.

The kernels themselves run on the card: tests/test_torch_cuda.py and
chip_smoke.py phase 1."""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from pactpu.ops import bitalloc as jb
from pactpu_torch.codec import engine as E
from pactpu_torch.codec import exact
from pactpu_torch.ops import bitalloc as tb
from pactpu_torch.ops import kernels as K
from pactpu_torch.ops.huffman import load_tables
from pactpu_torch.utils.config import CodecConfig
from torch_threads import torch_threads  # noqa: F401 (autouse)

LAYOUTS = {25: CodecConfig().band_layout.n_lines,
           40: chip_smoke.BANDS_40, 96: chip_smoke.WIDE_BANDS}


def _rows(rng, n_lines, rows: int = 48):
    """(total, level) of `rows` rows: levels over 120 dB, a third of the
    rows on a 6 dB grid (ties across bands and, after the grants, across
    steps), budgets from negative past every line's cap."""
    n_bands = len(n_lines)
    lines = int(np.sum(n_lines))
    level = rng.uniform(-20.0, 100.0, (rows, n_bands)).astype(np.float32)
    level[::3] = np.round(level[::3] / 6.0) * 6.0
    total = rng.integers(-50, 17 * lines + 100, rows).astype(np.int32)
    total[:4] = (0, 1, 16 * lines, 16 * lines - 1)
    return total, level


def _both(total, level, n_lines, max_mant, cap):
    args = (torch.from_numpy(np.asarray(total, np.int32)),
            torch.from_numpy(np.asarray(level, np.float32)),
            torch.from_numpy(np.asarray(n_lines, np.int32)), max_mant, cap)
    plain_stats, jump_stats = {}, {}
    want = K.grant_fill_plain(*args, stats=plain_stats)
    got = K.grant_fill_jump_plain(*args, stats=jump_stats)
    return got, want, jump_stats, plain_stats


@pytest.mark.parametrize("n_bands", sorted(LAYOUTS))
def test_jump_equals_steps(n_bands):
    """Seeded rows: the jump's walk gives the steps' bits, every grant is
    either jumped or walked, and the jump takes most of them."""
    n_lines = np.asarray(LAYOUTS[n_bands], np.int32)
    total, level = _rows(np.random.default_rng(n_bands), n_lines)
    cap = tb._legacy_iter_bound(4 * int(total.max()), n_lines, n_bands)
    got, want, js, ps = _both(total, level, n_lines, 16, cap)
    assert torch.equal(got, want)
    assert js["jumped"] + js["steps"] == ps["steps"]
    assert js["jumped"] > 4 * js["steps"]
    # the most steps walked in a row, as the rows one at a time count them
    walked = []
    for r in range(total.shape[0]):
        one = {}
        K.grant_fill_jump_plain(torch.from_numpy(total[r:r + 1]),
                                torch.from_numpy(level[r:r + 1]),
                                torch.from_numpy(n_lines), 16, cap, one)
        walked.append(one["steps"])
    assert js["max_walked"] == max(walked) and sum(walked) == js["steps"]


@pytest.mark.parametrize("name", chip_smoke.K9_EDGES)
def test_jump_edges(name):
    """chip_smoke.k9_edge's inputs (zero and negative budgets, every line
    at its cap, ties, zero-line bands, NaN and infinite levels, a walk
    that stalls, 40 bands) as phase 1 gives them to K9."""
    total, level, n_lines, max_mant, bcap = chip_smoke.k9_edge(name)
    cap = tb._legacy_iter_bound(bcap, n_lines, n_lines.shape[0])
    got, want, _, _ = _both(total, level, n_lines, max_mant, cap)
    assert torch.equal(got, want)


@pytest.mark.parametrize("steps", [0, 1, 7, 40, None])
def test_jump_zero_lines_and_caps(steps):
    """Zero-line bands (free grants, which the `remaining > 0` guard stops
    once the budget is spent, exactly or not) and step caps that cut the
    walk before, inside and after the jump."""
    rng = np.random.default_rng(17)
    n_lines = rng.integers(1, 40, 25).astype(np.int32)
    n_lines[[0, 3, 11, 24]] = 0
    total, level = _rows(rng, n_lines, rows=40)
    # budgets the non-zero bands' lines spend exactly
    total[4:12] = [int(n_lines[1:9].sum()) * k for k in range(1, 9)]
    cap = (tb._legacy_iter_bound(4 * int(total.max()), n_lines, 25)
           if steps is None else steps)
    got, want, js, ps = _both(total, level, n_lines, 16, cap)
    assert torch.equal(got, want)
    assert js["jumped"] + js["steps"] == ps["steps"]


def test_jump_matches_pactpu():
    """At 44.1 kHz both walks equal pactpu's _greedy_noise_floor_batch."""
    n_lines = np.asarray(LAYOUTS[25], np.int32)
    total, level = _rows(np.random.default_rng(44), n_lines, rows=64)
    total = np.maximum(total, 0)
    budget_cap = 4 * int(total.max())
    cap = tb._legacy_iter_bound(budget_cap, n_lines, 25)
    got, want, _, _ = _both(total, level, n_lines, 16, cap)
    gold = np.asarray(jb._greedy_noise_floor_batch(
        jnp.asarray(total), 16, n_lines, jnp.asarray(level), budget_cap))
    np.testing.assert_array_equal(want.numpy(), gold)
    np.testing.assert_array_equal(got.numpy(), gold)


def _unpack(packed: np.ndarray, n_pack: int, n_tab: int, n_sym: int):
    """The packed set read back as csrc/cost_table.cu reads it: (lengths
    [T, n_sym], 0 for no code; escape lengths [T] from the escapes' entry,
    which every symbol past n_pack reads).  Table t's length (its escape
    length where it has no code) at word t // 6, bit 5 (t % 6); its escape
    flag at bit t of word 1 from bit 20 (two words a symbol) or of word 3
    (four)."""
    flag_word, flag_bit = (1, 20) if packed.shape[1] == 2 else (3, 0)
    words = packed.astype(np.int64)
    ent = words[np.minimum(np.arange(n_sym), n_pack)]
    length = np.stack([(ent[:, t // 6] >> (5 * (t % 6))) & 31
                       for t in range(n_tab)])
    flag = np.stack([(ent[:, flag_word] >> (flag_bit + t)) & 1
                     for t in range(n_tab)])
    esc = np.array([(words[n_pack, t // 6] >> (5 * (t % 6))) & 31
                    for t in range(n_tab)])
    return np.where(flag > 0, 0, length), esc


def _check_pack(lens: np.ndarray, esc: np.ndarray):
    packed, n_pack = K.pack_tables(torch.from_numpy(lens),
                                   torch.from_numpy(esc))
    coded = np.nonzero((lens > 0).any(0))[0]
    assert n_pack == (int(coded.max()) + 1 if coded.size else 0)
    assert packed.shape[1] == (2 if lens.shape[0] <= 10 else 4)
    assert (packed.shape[0] * packed.shape[1]) % 4 == 0  # 16-byte units
    got_lens, got_esc = _unpack(packed.numpy(), n_pack, *lens.shape)
    np.testing.assert_array_equal(got_lens, lens)
    np.testing.assert_array_equal(got_esc, esc)
    return n_pack


def test_pack_shipped_tables():
    """The shipped set: 10 tables in two words a symbol, codes up to symbol
    17,906 (table 4)."""
    lens, _, esc, _ = load_tables()
    assert _check_pack(lens, esc) == 17_907


def test_pack_trained_and_full_tables():
    """A trained set (chip_smoke.trained_tables: eight tables) and one
    with a code on every symbol (the kernel reads it from device memory)."""
    lens, _, esc, _ = chip_smoke.trained_tables()
    n_pack = _check_pack(lens, esc)
    assert n_pack == int(np.nonzero((lens > 0).any(0))[0].max()) + 1
    full = np.full((10, 1 << 15), 9, np.int32)
    full[:, ::7] = 31
    assert _check_pack(full, np.arange(1, 11, dtype=np.int32)) == 1 << 15


@pytest.mark.parametrize("n_tab", [1, 5, 10, 11, 13, 16])
def test_pack_random_tables(n_tab):
    """Random sets of 1 to 16 tables (two words a symbol up to 10 tables,
    four past), lengths 0..31, with and without codes near the end."""
    rng = np.random.default_rng(n_tab)
    lens = rng.integers(0, 32, (n_tab, 3000)).astype(np.int32)
    lens[rng.random(lens.shape) < 0.4] = 0
    lens[:, 2500:] = 0
    esc = rng.integers(0, 32, n_tab).astype(np.int32)
    assert _check_pack(lens, esc) <= 2500
    empty = np.zeros_like(lens)
    assert _check_pack(empty, esc) == 0


def test_pack_refuses_long_codes():
    """Lengths past 31 bits (the codec's limit) do not fit 5 bits."""
    lens, _, esc, _ = load_tables()
    lens = lens.copy()
    lens[2, 7] = 32
    with pytest.raises(ValueError, match="0..31"):
        K.pack_tables(torch.from_numpy(lens), torch.from_numpy(esc))
    with pytest.raises(ValueError, match="0..31"):
        K.pack_tables(torch.from_numpy(load_tables()[0]),
                      torch.from_numpy(np.full(10, 40, np.int32)))


CSRC = Path(K.__file__).resolve().parent.parent / "csrc"


@pytest.mark.parametrize("source,pattern,value", [
    ("grant_fill.cu", r"constexpr int kProbes = (\d+);", K.GRANT_PROBES),
    ("cost_table.cu", r"struct Pack<2> \{[^}]*kTables = (\d+);",
     K._PACK_NARROW_TABLES),
    ("cost_table.cu", r"struct Pack<4> \{[^}]*kTables = (\d+);",
     K.MAX_SCAN_TABLES),
    ("cost_table.cu", r"struct Pack<2> \{[^}]*kFlagBit = (\d+)", 20),
])
def test_kernel_constants(source, pattern, value):
    """A constant a kernel keeps in its source equals the one its plain
    version or the pack uses (K9's bisection probes, the tables of a
    two-word and a four-word packed symbol, the flag word's first bit)."""
    found = re.search(pattern, (CSRC / source).read_text())
    assert found is not None and int(found.group(1)) == value


def test_exact_packs_once():
    """exact.packed_tables packs a device table set at its first call,
    keeps it in the set and hands the same pack out after."""
    dev = E.device_tables(CodecConfig(), "cpu")
    packed, n_pack = exact.packed_tables(dev)
    assert exact.packed_tables(dev) is dev["packed"]
    assert dev["packed"][0] is packed
    want, n_want = K.pack_tables(dev["tabs"][0], dev["tabs"][2])
    assert n_pack == n_want == 17_907 and torch.equal(packed, want)
