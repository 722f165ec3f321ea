"""The port's payload pack (kernel K3 as the engine launches it) on the CPU:
its plain version bit for bit against pactpu's pack_payload_bits at three
band layouts, stereo and mono row counts and the engine's three word
buckets, and on the edge rows of chip_smoke.k3_edge; the device plan
(bitpack.device_plan, what the kernel reads) decoded back to _pack_plan;
the kernel wrapper's CPU route.  The kernel itself runs only on the card
(tests/test_torch_cuda.py, chip_smoke.py phase 1)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from pactpu.ops import bitpack as jbitpack
from pactpu_torch.ops import bitpack
from pactpu_torch.ops import kernels as K
from pactpu_torch.utils.config import CodecConfig
from torch_threads import torch_threads  # noqa: F401 (autouse)

RATES = (44100, 48000, 22050)
# pactpu's packer under jit (the layout and the word count static)
_JAX_PACK = jax.jit(jbitpack.pack_payload_bits,
                    static_argnums=(8, 9, 10, 11, 12))


def layout(fs: int = 44100) -> tuple:
    cfg = CodecConfig(sample_rate=fs)
    return (tuple(cfg.band_layout.n_lines), cfg.n_scale_bits,
            cfg.n_mant_size_bits, cfg.n_table_id_bits)


def both(fields: dict, lay: tuple, n_words: int):
    """(port words, port nbits, pactpu words, pactpu nbits) as numpy."""
    t = chip_smoke.k3_tensors(torch, fields, "cpu")
    words, nbits = bitpack.pack_payload_bits_plain(*t, *lay, n_words)
    jw, jn = _JAX_PACK(*(jnp.asarray(fields[k]) for k in chip_smoke.K3_KEYS),
                       *lay, n_words)
    return (words.numpy(), nbits.numpy(),
            np.asarray(jw).view(np.int32), np.asarray(jn))


@pytest.mark.parametrize("n_words", chip_smoke.K3_WORDS)
@pytest.mark.parametrize("channels", [2, 1])
@pytest.mark.parametrize("fs", RATES)
def test_plain_matches_pactpu(fs, channels, n_words):
    """Seeded fields as the final pass gives them, 4 blocks of 1 or 2
    channels."""
    lay = layout(fs)
    rng = np.random.default_rng(RATES.index(fs) * 10 + channels)
    fields = chip_smoke.k3_fields(rng, 4 * channels, lay[0])
    words, nbits, jw, jn = both(fields, lay, n_words)
    assert np.array_equal(nbits, jn)
    assert np.array_equal(words, jw)


@pytest.mark.parametrize("n_lines", [(7,) * 150, (64,) * 32, (3, 5, 40)])
def test_plain_matches_pactpu_other_layouts(n_lines):
    """Layouts of 150 narrow bands, 2,048 lines and 48 lines (those the
    card's tests run through the kernel's other forms)."""
    lay = (n_lines, 4, 4, 4)
    fields = chip_smoke.k3_fields(np.random.default_rng(len(n_lines)), 6,
                                  n_lines)
    words, nbits, jw, jn = both(fields, lay, 968)
    assert np.array_equal(nbits, jn)
    assert np.array_equal(words, jw)


@pytest.mark.parametrize("n_words", chip_smoke.K3_WORDS)
@pytest.mark.parametrize("name", chip_smoke.K3_EDGES)
def test_plain_edges_match_pactpu(name, n_words):
    lay = layout()
    words, nbits, jw, jn = both(chip_smoke.k3_edge(name, lay[0]), lay,
                                n_words)
    assert np.array_equal(nbits, jn)
    assert np.array_equal(words, jw)


@pytest.mark.parametrize("name", chip_smoke.K3_EDGES)
def test_edges_reach_their_cases(name):
    """Each edge is what it is named for: the header fields alone (233
    bits at 25 bands), every line at 29 bits (the 968-word bucket's case),
    values past their widths, rows past 256 words."""
    lay = layout()
    f = chip_smoke.k3_edge(name, lay[0])
    t = chip_smoke.k3_tensors(torch, f, "cpu")
    _, nbits = bitpack.pack_payload_bits_plain(*t, *lay, 256)
    nbits = nbits.numpy()
    if name == "all-off":
        assert (nbits == 8 + 25 * 8 + 25).all()
    elif name == "escape-29":
        assert (nbits == 8 + 25 * 8 + 1024 * 30 + 25).all()
        assert (nbits > 32 * 384).all() and (nbits <= 32 * 968).all()
    elif name == "wide-values":
        lens = f["lens"].astype(np.int64)
        codes = f["codes"].astype(np.int64) & 0xFFFFFFFF
        assert ((codes >> lens) > 0).any()
        assert (f["ba"] <= 0).any() and (f["sign"] > 1).any()
    elif name == "overflow":
        assert (nbits > 32 * 256).any() and (nbits <= 32 * 968).all()


@pytest.mark.parametrize("fs", RATES)
def test_device_plan_decodes_to_pack_plan(fs):
    """The kernel's packed plan holds _pack_plan's permutation, constant
    widths, kinds and sign groups, which are pactpu's own."""
    lay = layout(fs)
    items, groups = bitpack.device_plan(*lay, "cpu")
    assert items.dtype == groups.dtype == torch.int32
    got = bitpack.decode_device_plan(items.numpy(), groups.numpy())
    for want in (bitpack._pack_plan(*lay), jbitpack._pack_plan(*lay)):
        for a, b in zip(got[:3], want[:3]):
            assert np.array_equal(a, b)
        for a, b in zip(got[3], want[3]):
            assert np.array_equal(a, b)


@pytest.mark.parametrize("fs", RATES)
def test_wrapper_cpu_route(fs):
    """kernels.pack_payload on CPU tensors (its plain version, from the
    decoded device plan) and bitpack.pack_payload_bits give
    pack_payload_bits_plain's words and nbits."""
    lay = layout(fs)
    rng = np.random.default_rng(700 + RATES.index(fs))
    t = chip_smoke.k3_tensors(torch, chip_smoke.k3_fields(rng, 6, lay[0]),
                              "cpu")
    want = bitpack.pack_payload_bits_plain(*t, *lay, 384)
    plan = bitpack.device_plan(*lay, "cpu")
    for got in (K.pack_payload(*t, *plan, 384),
                bitpack.pack_payload_bits(*t, *lay, 384)):
        assert all(torch.equal(a, b) for a, b in zip(got, want))


def test_pack_payload_refuses_bad_input():
    lay = layout()
    t = list(chip_smoke.k3_tensors(torch, chip_smoke.k3_fields(
        np.random.default_rng(9), 2, lay[0]), "cpu"))
    plan = bitpack.device_plan(*lay, "cpu")
    with pytest.raises(TypeError):
        K.pack_payload(*t[:2], t[2].long(), *t[3:], *plan, 256)
    with pytest.raises(ValueError):
        K.pack_payload(*t[:4], t[4][:, :-1].contiguous(), *t[5:], *plan,
                       256)
    with pytest.raises(ValueError):
        K.pack_payload(*t[:7], t[7][:1], *plan, 256)
