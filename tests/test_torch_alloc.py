"""PyTorch port, the four other allocators (pactpu_torch.ops.bitalloc:
closed_form through kernel K8, uniform as a prefix compare, const_snr and
const_mnr through kernel K9; on the CPU their plain versions) against
pactpu's functions, bit for bit: on 1/8-dB grid SMRs, on the SMRs of a
real analysis, on the edge rows of chip_smoke.k8_edge / k9_edge, in
float32 and float64; and the port's finalize on pactpu's analysis against
pactpu's payload for each allocator, rate mode and channel count.

pactpu's closed form is called as its engine calls it, under jit with the
band layout a constant: there XLA's CPU dot sums the SMRs in its own order
(reproduced by kernels.closed_form_r), divides by the line count as a
product with its reciprocal and fuses (smr - avg) / 6 + budget / lines
into one multiply-add; pactpu's eager call divides.

The one sanctioned departure (ROADMAP queue 3, fault (b)): the port's
grant walk stops once the budget is spent (`remaining > 0`), where
pactpu's goes on granting free bits to bands of zero lines.  The tests
hold the two equal everywhere else and record where they part."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from make_torch_port_fixture import short_pcm
from pactpu.codec import engine as je
from pactpu.ops import bitalloc as jb
from pactpu.utils.config import CodecConfig
from pactpu_torch import native
from pactpu_torch.codec import engine as te
from pactpu_torch.ops import bitalloc as tb
from pactpu_torch.utils.config import CodecConfig as TorchConfig
from torch_threads import torch_threads  # noqa: F401 (autouse)

ALLOCS = ("closed_form", "uniform", "const_snr", "const_mnr")
N_LINES = np.asarray(CodecConfig().band_layout.n_lines, np.int32)
DTYPES = {"f32": np.float32, "f64": np.float64}
CHUNK = 16


def x64(prec: str):
    """jax's float64 mode for pactpu's float64 calls."""
    return jax.enable_x64(prec == "f64")


def jax_closed_form(budget, smr, n_lines, max_mant: int = 16):
    """pactpu's alloc_closed_form as its engine runs it (jit, the layout a
    constant)."""
    fn = jax.jit(lambda b, s: jb.alloc_closed_form(b, max_mant, n_lines, s))
    return np.asarray(fn(jnp.asarray(budget), jnp.asarray(smr)))


def port_closed_form(budget, smr, n_lines, max_mant: int = 16):
    return tb.alloc_closed_form(torch.from_numpy(np.asarray(budget)),
                                max_mant, n_lines,
                                torch.from_numpy(smr)).numpy()


@pytest.mark.parametrize("prec", ["f32", "f64"])
def test_closed_form_grid_smrs(prec):
    """SMRs on the 1/8-dB grid of tests/test_variants.py:59-64: every
    product and sum is exact, so no row is masked."""
    rng = np.random.default_rng(0)
    rows = 64
    smr = (rng.integers(-320, 480, (rows, 25)) / 8.0).astype(DTYPES[prec])
    budget = rng.integers(0, 4000, rows).astype(np.int32)
    budget[0] = 0
    budget[1] = 16 * 1024 + 7
    with x64(prec):
        gold = jax_closed_form(budget, smr, N_LINES)
    np.testing.assert_array_equal(port_closed_form(budget, smr, N_LINES),
                                  gold)


@pytest.fixture(scope="module")
def jax_analysis():
    """pactpu's analysis of short_pcm in float32 and float64: SMR rows of
    both channels, and its raw closed-form r at the budgets used below."""
    out = {}
    for prec in ("f32", "f64"):
        with x64(prec):
            cfg = CodecConfig()
            eng = je.Engine(precision=prec)
            half, pcm = cfg.n_mdct_lines, short_pcm()
            glob = np.zeros((2, 9 * half), np.int16)
            glob[:, half:half + pcm.shape[0]] = pcm.T
            a = je._chunk_analyze_fn(cfg, prec)(jnp.asarray(glob),
                                                eng.consts())
            # each channel-block's SMRs at eight budgets
            smr = np.repeat(np.asarray(a["smr"]).reshape(-1, cfg.n_bands), 8,
                            axis=0)
            rng = np.random.default_rng(1)
            budget = (2116 + rng.integers(-600, 2500, smr.shape[0])).astype(
                np.int32)
            _, r = jax.jit(lambda b, s: jb.closed_form_init(
                b, 16, N_LINES, s))(jnp.asarray(budget), jnp.asarray(smr))
            out[prec] = dict(smr=smr, budget=budget, r=np.asarray(r),
                             gold=jax_closed_form(budget, smr, N_LINES))
    return out


@pytest.mark.parametrize("prec", ["f32", "f64"])
def test_closed_form_real_smrs(jax_analysis, prec):
    """On a real analysis, rows whose r lies within 1e-3 of an integer >= 2
    may round either way (the sum's order: the port reproduces XLA's CPU
    dot in float32, not in float64) and are masked, as pactpu's own test
    masks them (tests/test_variants.py:83-94); every other row is equal."""
    d = jax_analysis[prec]
    mine = port_closed_form(d["budget"], d["smr"], N_LINES)
    r = d["r"]
    near = (np.abs(r - np.round(r)) < 1e-3) & (r > 2.0 - 1e-3)
    comparable = ~near.any(axis=1)
    assert comparable.sum() >= 0.75 * len(comparable)
    np.testing.assert_array_equal(mine[comparable], d["gold"][comparable])
    assert (mine > 0).any() and (mine != 1).all()


def test_closed_form_init_float32_is_pactpus(jax_analysis):
    """In float32 closed_form_init reproduces the arithmetic of pactpu's
    jitted init: bits and the raw r bit for bit, no row masked, on the
    real rows and on random ones, at row counts the engine's chunks give
    (multiples of 16; at some other counts, 5 or 500 rows, XLA's CPU dot
    sums a few rows in another order, an ulp apart)."""
    rng = np.random.default_rng(5)
    d = jax_analysis["f32"]
    rows = [(d["budget"], d["smr"]),
            (rng.integers(-100, 5000, 512).astype(np.int32),
             rng.uniform(-30, 60, (512, 25)).astype(np.float32))]
    for budget, smr in rows:
        gold_bits, gold_r = jax.jit(lambda b, s: jb.closed_form_init(
            b, 16, N_LINES, s))(jnp.asarray(budget), jnp.asarray(smr))
        bits, r = tb.closed_form_init(torch.from_numpy(budget), 16, N_LINES,
                                      torch.from_numpy(smr))
        np.testing.assert_array_equal(r.numpy(), np.asarray(gold_r))
        np.testing.assert_array_equal(bits.numpy(), np.asarray(gold_bits))


@pytest.mark.parametrize("name", chip_smoke.K8_EDGES)
@pytest.mark.parametrize("prec", ["f32", "f64"])
def test_closed_form_edges(name, prec):
    """k8_edge: zero and negative budgets, budgets at and past 16 bits on
    every line, ties across lanes and trips, zero-line bands, grid SMRs,
    40 bands."""
    budget, smr, n_lines, max_mant = chip_smoke.k8_edge(name)
    smr = smr.astype(DTYPES[prec])
    with x64(prec):
        gold = jax_closed_form(budget, smr, n_lines, max_mant)
    np.testing.assert_array_equal(
        port_closed_form(budget, smr, n_lines, max_mant), gold)


def _takeback_trips(budget, smr, n_lines, max_mant):
    """The take-back of each row, trip by trip, as pactpu's loop runs it
    (bitalloc.py:183-243, stopping where spent < budget): per row a list
    of (candidate, its SMR before the trip, spent after the trip, live
    bands left), and the final bits."""
    bits0, _ = tb.closed_form_init(torch.from_numpy(budget), max_mant,
                                   n_lines, torch.from_numpy(smr))
    rows, out = [], []
    for i, bits in enumerate(bits0.numpy().astype(np.int64)):
        m, live = smr[i].copy(), np.ones(len(bits), bool)
        spent, trips = int((bits * n_lines).sum()), []
        while live.any() and spent >= budget[i]:
            key = np.where(live, m, np.inf)
            nan = np.isnan(key)
            c = int(np.argmax(nan) if nan.any() else np.argmin(key))
            dec = bits[c] - 1 if bits[c] > 2 else 0
            spent -= int((bits[c] - dec) * n_lines[c])
            bits[c], live[c] = dec, dec != 0
            trips.append((c, m[c], spent, int(live.sum())))
            m[c] += 6.0
        rows.append(trips)
        out.append(bits)
    return rows, np.stack(out)


@pytest.mark.parametrize("name", ["exact-hit", "last-band", "signed-zero",
                                  "96-bands"])
def test_closed_form_edges_reach_their_cases(name):
    """The take-back's edge inputs take the trips they are named for:
    spent lands on the budget and one more trip follows; the trip that
    retires the last live band brings spent under the budget; candidates
    of SMR -0.0 and +0.0 tied in both orders of sign; 96 bands with a
    candidate tied with a band of the same lane in another slot."""
    budget, smr, n_lines, max_mant = chip_smoke.k8_edge(name)
    rows, bits = _takeback_trips(budget, smr, n_lines, max_mant)
    np.testing.assert_array_equal(bits, tb.alloc_closed_form(
        torch.from_numpy(budget), max_mant, n_lines,
        torch.from_numpy(smr)).numpy())
    if name == "exact-hit":
        for trips, bud in zip(rows, budget):
            assert any(t[2] == bud for t in trips[:-1])
            assert trips[-1][2] < bud
    elif name == "last-band":
        for trips, bud in zip(rows, budget):
            assert trips[-1][3] == 0 and trips[-1][2] < bud <= trips[-2][2]
    elif name == "signed-zero":
        orders = set()
        for i, trips in enumerate(rows):
            for (c, v, _, _), (c2, v2, _, _) in zip(trips, trips[1:]):
                if v == 0.0 and v2 == 0.0:
                    orders.add((np.signbit(smr[i, c]),
                                np.signbit(smr[i, c2])))
        assert {(True, False), (False, True)} <= orders
    else:
        assert any(c2 - c in (32, 64) and v == v2 for trips in rows
                   for (c, v, _, _), (c2, v2, _, _) in zip(trips, trips[1:]))


def test_closed_form_takeback_alone():
    """closed_form_takeback from any bits0 (here the init's, and a row
    over its budget at the cap) equals pactpu's."""
    budget, smr, n_lines, _ = chip_smoke.k8_edge("zero-lines")
    bits0 = np.array(jb.closed_form_init(jnp.asarray(budget), 16,
                                         jnp.asarray(n_lines),
                                         jnp.asarray(smr))[0])
    bits0[0] = 16
    gold = np.asarray(jb.closed_form_takeback(
        jnp.asarray(bits0), jnp.asarray(budget), jnp.asarray(n_lines),
        jnp.asarray(smr), 16))
    mine = tb.closed_form_takeback(torch.from_numpy(bits0),
                                   torch.from_numpy(budget), n_lines,
                                   torch.from_numpy(smr), 16)
    np.testing.assert_array_equal(mine.numpy(), gold)


def _grant_rows(fn_j, fn_t, total, level, n_lines, max_mant, cap):
    gold = np.asarray(fn_j(jnp.asarray(total), max_mant, n_lines,
                           jnp.asarray(level), cap))
    mine = fn_t(torch.from_numpy(total), max_mant, n_lines,
                torch.from_numpy(level), cap).numpy()
    return mine, gold


@pytest.mark.parametrize("name", chip_smoke.K9_EDGES)
@pytest.mark.parametrize("alloc", ["const_snr", "const_mnr"])
def test_grant_walk_edges(name, alloc):
    """k9_edge: the port's walk equals pactpu's but in the bands of zero
    lines of the rows whose budget ran out (fault (b)); the edges without
    zero-line bands are equal throughout."""
    total, level, n_lines, max_mant, cap = chip_smoke.k9_edge(name)
    mine, gold = _grant_rows(getattr(jb, f"alloc_{alloc}_batch"),
                             getattr(tb, f"alloc_{alloc}_batch"), total,
                             level, n_lines, max_mant, cap)
    zero = n_lines == 0
    np.testing.assert_array_equal(mine[:, ~zero], gold[:, ~zero])
    if not zero.any():
        return
    assert (mine[:, zero] <= gold[:, zero]).all()


@pytest.mark.parametrize("prec", ["f32", "f64"])
def test_grant_walk_real_levels(jax_analysis, prec):
    """const_mnr on a real analysis's SMRs (float64 SMRs are taken in
    float32, as pactpu takes them): bit for bit (no zero-line band at
    44.1 kHz)."""
    d = jax_analysis[prec]
    with x64(prec):
        mine, gold = _grant_rows(jb.alloc_const_mnr_batch,
                                 tb.alloc_const_mnr_batch, d["budget"],
                                 d["smr"], N_LINES, 16, 4 * 2116)
    np.testing.assert_array_equal(mine, gold)


@pytest.mark.parametrize("n_lines", [
    N_LINES, np.asarray([5, 0, 7, 0, 0, 12, 3, 0], np.int32),
    np.asarray(chip_smoke.WIDE_BANDS, np.int32), np.asarray([9], np.int32)],
    ids=["default", "zero-lines", "96-bands", "one-band"])
def test_uniform_prefix_form(n_lines):
    """The prefix form of the round-robin equals alloc_uniform_batch's
    loop, on totals from negative to past the cap (floor division of a
    negative total, the cap gating the extra bit)."""
    rng = np.random.default_rng(int(n_lines.sum()))
    lines = int(n_lines.sum())
    total = np.concatenate([
        rng.integers(-5 * lines, 20 * lines, 200),
        np.arange(-2 * lines, 2 * lines + 1, max(1, lines // 40)),
        [0, -1, 1, 16 * lines, 16 * lines + lines - 1, 17 * lines]]
    ).astype(np.int32)
    gold = np.asarray(jb.alloc_uniform_batch(jnp.asarray(total), 16,
                                             n_lines, 4 * int(total.max())))
    mine = tb.alloc_uniform_batch(torch.from_numpy(total), 16, n_lines,
                                  4 * int(total.max())).numpy()
    np.testing.assert_array_equal(mine, gold)


def test_single_row_forms():
    """alloc_uniform / alloc_const_snr / alloc_const_mnr (one row) equal
    pactpu's single-row allocators."""
    rng = np.random.default_rng(3)
    for budget in (0, 700, 2116, 9000):
        level = rng.uniform(-20, 90, 25).astype(np.float32)
        np.testing.assert_array_equal(
            tb.alloc_uniform(budget, 16, N_LINES).numpy(),
            np.asarray(jb.alloc_uniform(budget, 16, N_LINES)))
        for name in ("alloc_const_snr", "alloc_const_mnr"):
            np.testing.assert_array_equal(
                getattr(tb, name)(budget, 16, N_LINES,
                                  torch.from_numpy(level)).numpy(),
                np.asarray(getattr(jb, name)(budget, 16, N_LINES,
                                             jnp.asarray(level))))


def _jax_chunks(cfg, rate: str, pcm: np.ndarray, prec: str = "f32"):
    """pactpu's encode of pcm chunk by chunk (CHUNK blocks), stage by
    stage, in `prec` (call under x64(prec)): each chunk's analysis, extras
    and final outputs."""
    half, c = cfg.n_mdct_lines, cfg.n_channels
    b = -(-pcm.shape[0] // half) + 1
    sizes = je._chunk_sizes(b, CHUNK)
    offs = je._offsets(sizes)
    glob = np.zeros((c, (offs[-1] + 1) * half), np.int16)
    glob[:, half:half + pcm.shape[0]] = pcm.T
    consts = je.Engine(cfg=cfg, precision=prec).consts()
    analyze = je._chunk_analyze_fn(cfg, prec)
    measure = je._finalize_fn(cfg, measure_only=True, precision=prec)
    scan = je._reservoir_scan_fn(cfg)
    final = je._finalize_fn(cfg, pack_words=je.PACK_WORDS, precision=prec)
    carry = jnp.zeros(2, jnp.int32)
    chunks = []
    for k, sz in enumerate(sizes):
        a = analyze(jnp.asarray(glob[:, offs[k] * half:
                                     (offs[k + 1] + 1) * half]), consts)
        ex = jnp.zeros(sz, jnp.float32)
        if rate == "reservoir":
            m = measure(a, ex, consts)
            ex, carry = scan(m["savings"], m["leftover"],
                             jnp.arange(sz) < max(0, b - offs[k]), carry)
        out = final(a, ex, consts)
        chunks.append(({k2: np.array(v) for k2, v in a.items()},
                       np.array(ex), {k2: np.array(v)
                                      for k2, v in out.items()}))
    return b, chunks


@pytest.mark.parametrize("chans,rate,prec", [
    (2, "cbr", "f32"), (2, "reservoir", "f32"), (1, "cbr", "f32"),
    (1, "reservoir", "f32"), (2, "reservoir", "f64")])
@pytest.mark.parametrize("alloc", ALLOCS)
def test_finalize_on_pactpu_analysis(alloc, chans, rate, prec):
    """Given pactpu's analysis and extra bits, the port's finalize gives
    pactpu's bits, scale factors, table ids, savings, leftovers and packed
    payload words, chunk by chunk: stereo and mono, cbr and reservoir, and
    stereo reservoir in float64 (pactpu under x64)."""
    cfg = CodecConfig(alloc_mode=alloc, n_channels=chans)
    tcfg = TorchConfig(alloc_mode=alloc, n_channels=chans)
    dev = te.device_tables(tcfg, "cpu", prec)
    with x64(prec):
        _, chunks = _jax_chunks(cfg, rate, short_pcm(chans), prec)
    for a, ex, gold in chunks:
        ta = dict(mixed=torch.from_numpy(a["mixed"]),
                  smr=torch.from_numpy(a["smr"]),
                  lrms=torch.from_numpy(a["lrms"]),
                  overall=torch.from_numpy(a["overall"].astype(np.int32)))
        out = te.finalize(tcfg, ta, torch.from_numpy(ex), dev)
        for key in ("bits", "sf", "tid", "savings", "leftover", "nbits"):
            np.testing.assert_array_equal(out[key].numpy(),
                                          gold[key].astype(np.int64), key)
        np.testing.assert_array_equal(out["words"].numpy().view(np.uint32),
                                      gold["words"])


@pytest.mark.parametrize("rate", ["cbr", "reservoir"])
@pytest.mark.parametrize("alloc", ALLOCS)
def test_encode_from_pcm(alloc, rate):
    """From PCM the port's stream is within 0.1 dB and 1% of pactpu's (the
    analysis is a float stage), and the port decodes pactpu's stream
    within 1 LSB of pactpu's decode."""
    pcm = short_pcm()
    je_ = je.Engine(cfg=CodecConfig(alloc_mode=alloc), rate_mode=rate)
    te_ = te.Engine(device="cpu", cfg=TorchConfig(alloc_mode=alloc),
                    rate_mode=rate)
    gold, mine = je_.encode(pcm), te_.encode(pcm)
    _, out_j = je_.decode(gold)
    _, out_t = te_.decode(mine)
    assert abs(chip_smoke.snr_db(pcm, out_t)
               - chip_smoke.snr_db(pcm, out_j)) <= 0.1
    assert abs(len(mine) - len(gold)) <= 0.01 * len(gold)
    _, port_of_gold = te_.decode(gold)
    assert np.abs(port_of_gold.astype(np.int32) - out_j).max() <= 1


@pytest.mark.parametrize("alloc", ["const_snr", "const_mnr"])
def test_guard_departure_at_22k(alloc):
    """At 22.05 kHz the layout's last two bands have no lines.  Given
    pactpu's analysis, the port's finalize parts from pactpu's only in the
    allocation and scale factor of those bands (pactpu grants them free
    bits once the budget is spent, fault (b)), and the two payloads decode
    to the same samples.  Records the channel-blocks that part."""
    cfg = CodecConfig(alloc_mode=alloc, sample_rate=22050)
    tcfg = TorchConfig(alloc_mode=alloc, sample_rate=22050)
    zero = np.asarray(cfg.band_layout.n_lines) == 0
    assert zero.sum() == 2
    dev = te.device_tables(tcfg, "cpu")
    pcm = short_pcm(fs=22050)
    b, chunks = _jax_chunks(cfg, "cbr", pcm)
    parted, payloads = [], ([], [])
    for a, ex, gold in chunks:
        ta = dict(mixed=torch.from_numpy(a["mixed"]),
                  smr=torch.from_numpy(a["smr"]),
                  lrms=torch.from_numpy(a["lrms"]),
                  overall=torch.from_numpy(a["overall"].astype(np.int32)))
        out = te.finalize(tcfg, ta, torch.from_numpy(ex), dev)
        for key in ("bits", "sf"):
            mine, ref = out[key].numpy(), gold[key].astype(np.int64)
            np.testing.assert_array_equal(mine[..., ~zero], ref[..., ~zero])
        for key in ("tid", "savings", "leftover"):
            np.testing.assert_array_equal(out[key].numpy(),
                                          gold[key].astype(np.int64), key)
        parted.append((out["bits"].numpy() != gold["bits"]).any(-1))
        payloads[0].append((out["words"].numpy().view(np.uint32),
                            out["nbits"].numpy()))
        payloads[1].append((gold["words"], gold["nbits"]))
    parted = int(np.concatenate(parted)[:b].sum())
    print(f"{alloc} at 22.05 kHz: {parted} of {2 * b} channel-blocks part "
          "in their zero-line bands")
    assert parted > 0
    header = te.write_header(tcfg, pcm.shape[0])[0]
    eng = te.Engine(device="cpu", cfg=tcfg)
    pcm_out = []
    for rows in payloads:
        words = np.concatenate([w for w, _ in rows])[:2 * b]
        nbits = np.concatenate([n for _, n in rows])[:2 * b]
        pcm_out.append(eng.decode(header + native.assemble_rows(words,
                                                                nbits))[1])
    np.testing.assert_array_equal(pcm_out[0], pcm_out[1])


def test_wrappers_refuse_bad_inputs():
    """K8's and K9's wrappers check types and shapes: K9's levels are
    float32 only, K8's SMRs float32 or float64."""
    from pactpu_torch.ops import kernels as K
    budget = torch.zeros(3, dtype=torch.int32)
    nl = torch.ones(25, dtype=torch.int32)
    smr = torch.zeros((3, 25))
    K.closed_form(budget, smr.double(), nl, 16)
    with pytest.raises(TypeError):
        K.closed_form(budget.long(), smr, nl, 16)
    with pytest.raises(ValueError, match="shapes"):
        K.closed_form(budget[:2], smr, nl, 16)
    with pytest.raises(TypeError):
        K.grant_fill(budget, smr.double(), nl, 16, 100)
    with pytest.raises(ValueError, match="shapes"):
        K.grant_fill(budget, smr, nl[:24], 16, 100)
