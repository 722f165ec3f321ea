"""The reservoir scan (kernel K11's plain version) and the program layer
(pactpu_torch.codec.programs) on the CPU.

- kernels.reservoir_scan_plain against pactpu's _reservoir_scan_fn, bit
  for bit (extras as float32 bit patterns, the int32 carry): on real
  measurements chained chunk by chunk over a padded tail, and on seeded
  edge inputs;
- the Engine's CPU route: last_measure, last_extras and a stream's carry
  as pactpu has them, bit for bit;
- the program cache's keys and bound, and the Engine's program plumbing
  (which stages, which sizes, the clones that keep one chunk's outputs
  from the next replay) with a stand-in for the CUDA graph that reruns the
  stage into its static outputs: the same bytes and samples as the direct
  route, bit for bit;
- a capture's launches counted apart for its own thread only, and the
  device-table caches that a graph reads by address never evicting.

The CUDA graphs themselves and K11 on the card: tests/test_torch_cuda.py.
"""

import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._pytree import tree_flatten

import chip_smoke
from make_torch_port_fixture import fixture_pcm
from pactpu.codec import engine as je
from pactpu.codec import stream as jstream
from pactpu.utils.config import CodecConfig as JaxConfig
from pactpu_torch import CodecConfig, Engine
from pactpu_torch.codec import engine as te
from pactpu_torch.codec import programs
from pactpu_torch.codec import stream as tstream
from pactpu_torch.ops import kernels as K
from torch_threads import torch_threads  # noqa: F401 (autouse)

CHUNK = 16


def jax_scan(savings, leftover, valid, carry, divisor):
    cfg = JaxConfig(reservoir_withdraw_divisor=divisor)
    ex, c = je._reservoir_scan_fn(cfg)(
        jnp.asarray(savings), jnp.asarray(leftover), jnp.asarray(valid),
        jnp.asarray(carry))
    return np.asarray(ex), np.asarray(c)


def port_scan(savings, leftover, valid, carry, divisor):
    ex, c = K.reservoir_scan_plain(
        torch.from_numpy(savings), torch.from_numpy(leftover),
        torch.from_numpy(valid), torch.from_numpy(carry), divisor)
    return ex.numpy(), c.numpy()


def assert_same(mine, gold):
    """Extras as float32 bit patterns and the carry, exactly."""
    assert mine[0].dtype == np.float32 and gold[0].dtype == np.float32
    np.testing.assert_array_equal(mine[0].view(np.int32),
                                  gold[0].view(np.int32))
    np.testing.assert_array_equal(mine[1], gold[1])


@pytest.fixture(scope="module")
def measured():
    """pactpu's measurement pass of the fixture's 1 s file (45 blocks) in
    16-block chunks: savings i32[45, 2], leftover i32[45]."""
    eng = je.Engine(rate_mode="reservoir", chunk_blocks=CHUNK)
    eng.encode(fixture_pcm())
    sav, left = eng.last_measure
    return np.asarray(sav, np.int32), np.asarray(left, np.int32)


def test_scan_on_real_measurements(measured):
    """Chunk by chunk with the carry chained, the last chunk padded with
    garbage rows that its valid mask turns off: every chunk's extras and
    carry equal pactpu's, and the extras are the host replay's."""
    sav, left = measured
    b = sav.shape[0]
    rng = np.random.default_rng(3)
    pad = -b % CHUNK
    sav_p = np.concatenate([sav, rng.integers(-5000, 5000, (pad, 2))
                            .astype(np.int32)])
    left_p = np.concatenate([left, rng.integers(-500, 500, pad)
                             .astype(np.int32)])
    carry_j = carry_t = np.zeros(2, np.int32)
    extras = []
    for lo in range(0, b + pad, CHUNK):
        s, lf = sav_p[lo:lo + CHUNK], left_p[lo:lo + CHUNK]
        valid = np.arange(CHUNK) < b - lo
        gold = jax_scan(s, lf, valid, carry_j, 100)
        mine = port_scan(s, lf, valid, carry_t, 100)
        assert_same(mine, gold)
        carry_j, carry_t = gold[1], mine[1]
        extras.append(mine[0])
    extras = np.concatenate(extras)
    assert not extras[b:].any() and extras.max() > 0
    host, carry = je._reservoir_extras(sav, left, 100)
    np.testing.assert_array_equal(extras[:b], host.astype(np.float32))
    assert tuple(carry_t) == carry


@pytest.mark.parametrize("name", chip_smoke.K11_EDGES)
def test_scan_edges(name):
    """chip_smoke.k11_edge's inputs, which phase 1 holds K11 to its plain
    version on."""
    args = chip_smoke.k11_edge(name)
    assert_same(port_scan(*args), jax_scan(*args))


def test_scan_edge_semantics():
    """The policy's thresholds as the reference states them: a deposit of
    exactly 10 is kept whole, 11 gives 11 // divisor; a negative deposit
    is folded into the first grant; an invalid block is granted 0 and
    leaves the carry alone."""
    z = np.zeros((1, 2), np.int32)
    one = np.ones(1, bool)
    for dep, want_grant, want_dep in ((10, 5, 10), (11, 5 + 3, 8),
                                      (-7, 5 - 7, 0)):
        ex, c = port_scan(z, np.zeros(1, np.int32), one,
                          np.asarray([dep, 5], np.int32), 3)
        assert ex[0] == want_grant and c[0] == want_dep and c[1] == 0
    ex, c = port_scan(z + 50, np.full(1, 9, np.int32), ~one,
                      np.asarray([11, 5], np.int32), 3)
    assert ex[0] == 0 and list(c) == [11, 5]


def test_scan_wrapper_checks():
    s, lf, v, c, _ = chip_smoke.k11_edge("mono")
    with pytest.raises(ValueError, match="divisor"):
        K.reservoir_scan(torch.from_numpy(s), torch.from_numpy(lf),
                         torch.from_numpy(v), torch.from_numpy(c), 0)
    with pytest.raises(TypeError):
        K.reservoir_scan(torch.from_numpy(s).long(), torch.from_numpy(lf),
                         torch.from_numpy(v), torch.from_numpy(c), 100)
    # a count of valid blocks is the prefix mask
    a = K.reservoir_scan(torch.from_numpy(s), torch.from_numpy(lf), 10,
                         torch.from_numpy(c), 100)
    mask = torch.arange(s.shape[0]) < 10
    b = K.reservoir_scan(torch.from_numpy(s), torch.from_numpy(lf), mask,
                         torch.from_numpy(c), 100)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert K.LAUNCHES["reservoir_scan"] == 0        # the CPU launches none


@pytest.fixture
def pactpu_analysis(monkeypatch):
    """The port's analysis swapped for pactpu's (analyze_body, jitted, on
    the same frames), in the Engine and in the stream encoder, so that
    everything after it is held to pactpu bit for bit: without the swap
    the two part by float rounding in a borderline allocation (FFT and
    GEMM sums in another order; tests/test_torch_cluster.py)."""
    jcfg = JaxConfig()
    fn, consts = jax.jit(je.analyze_body(jcfg)), je.engine_consts_np(jcfg)

    def analyze(cfg, frames, dev):
        out = fn(jnp.asarray(frames.contiguous().numpy()), consts)
        return {k: torch.from_numpy(np.array(v)) for k, v in out.items()}

    monkeypatch.setattr(te, "analyze", analyze)
    monkeypatch.setattr(tstream, "analyze", analyze)


def test_engine_cpu_route_keeps_pactpus_observability(pactpu_analysis):
    """A reservoir encode of 45 blocks in 16-block chunks (two full chunks
    and a padded tail) on the CPU route, given pactpu's analysis: the
    stream, last_measure and last_extras are pactpu's, bit for bit, and
    last_extras is the float32 of the host replay over last_measure."""
    pcm = fixture_pcm()
    gold = je.Engine(rate_mode="reservoir", chunk_blocks=CHUNK)
    mine = Engine(device="cpu", rate_mode="reservoir", chunk_blocks=CHUNK)
    assert mine.encode(pcm) == gold.encode(pcm)
    for a, b in zip(mine.last_measure, gold.last_measure):
        assert a.dtype == np.asarray(b).dtype
        np.testing.assert_array_equal(a, b)
    assert mine.last_extras.dtype == np.float32
    np.testing.assert_array_equal(mine.last_extras.view(np.int32),
                                  np.asarray(gold.last_extras).view(np.int32))
    host, _ = je._reservoir_extras(*mine.last_measure, 100)
    np.testing.assert_array_equal(mine.last_extras, host.astype(np.float32))


def test_stream_carry_is_pactpus(pactpu_analysis):
    """A stream's (bitDeposit, extraBits) after each push, now taken from
    K11's device carry, equals pactpu's stream encoder's, and so do the
    bytes."""
    pcm = fixture_pcm()[:30000]
    mine = tstream.StreamingEncoder(device="cpu")
    gold = jstream.StreamingEncoder()
    out_m, out_g = [], []
    for lo in range(0, pcm.shape[0], 7000):
        out_m.append(mine.push(pcm[lo:lo + 7000]))
        out_g.append(gold.push(pcm[lo:lo + 7000]))
        assert (mine._deposit, mine._extra) == (gold._deposit, gold._extra)
        assert isinstance(mine._deposit, int)
    out_m.append(mine.flush())
    out_g.append(gold.flush())
    assert (mine._deposit, mine._extra) == (gold._deposit, gold._extra)
    assert b"".join(out_m) == b"".join(out_g)


# -- the program cache -----------------------------------------------------

class CpuProgram(programs.Program):
    """A program whose graph is the stage rerun: replay() writes fn's
    outputs into the static outputs, as a graph's replay overwrites them,
    so that an output the Engine kept without a clone would change."""

    @classmethod
    def build(cls, stage, fn, args, device, pool=None):
        static_in = [a.clone().to(device) for a in args]
        warm = programs._unaliased(fn(*static_in), static_in)
        prog = cls(stage, None, static_in, fn(*static_in), {})
        prog.fn = fn
        return prog, warm

    def replay(self):
        leaves, _ = tree_flatten(self.fn(*self.static_in))
        for s, t in zip(self.static_out, leaves):
            if torch.is_tensor(s):
                s.copy_(t)


@pytest.fixture
def cpu_programs(monkeypatch):
    """Every Engine routes its stages through programs, built by
    CpuProgram."""
    monkeypatch.setattr(programs, "Program", CpuProgram)
    monkeypatch.setattr(programs, "_card", lambda eng: eng.use_programs)


def test_cache_keys_and_bound(cpu_programs, monkeypatch):
    """A program a (stage, key, input shapes and types); the least
    recently used dropped past the bound; a hit replays, a miss builds."""
    monkeypatch.setattr(programs, "MAX_PROGRAMS", 3)
    cache = programs.Programs("cpu")
    calls = []

    def fn(x):
        calls.append(x.shape)
        return {"y": x * 2, "n": None}

    for n in (1, 2, 3, 1, 4):
        out = cache.run("stage", ("cfg",), fn, (torch.ones(n),))
        assert torch.equal(out["y"], torch.full((n,), 2.0))
        assert out["n"] is None
    keys = [k for k, _ in cache.items("stage")]
    assert keys == [programs.Programs.key(("cfg",), (torch.ones(n),))
                    for n in (3, 1, 4)]
    assert keys[0] == (("cfg",), (((3,), torch.float32),))
    assert cache.captures == 4 and cache.capture_s > 0
    assert [p.replays for _, p in cache.items("stage")] == [0, 1, 0]
    assert calls.count((1,)) == 3       # warm-up, capture, one replay
    cache.run("stage", ("cfg",), fn, (torch.ones(3, dtype=torch.int32),))
    cache.run("stage", ("other",), fn, (torch.ones(3),))
    assert cache.captures == 6 and len(cache.items("stage")) == 3
    assert cache.items("none") == []


def test_route_from_the_config():
    """Which configurations take programs, decided before any capture."""
    class Eng:
        def __init__(self, device="cuda", **kw):
            self.device = torch.device(device)
            self.fmt, self.rate_mode = kw.get("fmt", "wak"), kw.get(
                "rate_mode", "reservoir")
            self.device_pack = kw.get("device_pack", True)
            self.debug_checks = kw.get("debug_checks", False)
            self.use_programs = kw.get("use_programs", True)
            self.cfg = CodecConfig(alloc_mode=kw.get("alloc", "water_fill"),
                                   peak_mode=kw.get("peak", "ref"))

    P, L = True, False

    def on(*stages):         # encode_programs' answer, stage by stage
        return {s: s in stages for s in ("analyze", "measure", "cost",
                                         "exact_scan", "final", "baseline")}

    res, exact = on("analyze", "measure", "final"), on(
        "analyze", "cost", "exact_scan", "final")
    cases = [({}, res, P), (dict(rate_mode="cbr"), on("analyze", "final"), P),
             (dict(peak="weighted"), res, P),
             (dict(rate_mode="exact"), exact, P),
             (dict(fmt="pac", rate_mode="cbr"), on("baseline"), P),
             (dict(device_pack=False), res, P),
             (dict(debug_checks=True), on(), P),
             (dict(alloc="closed_form"), res, P), (dict(device="cpu"), on(), L),
             (dict(use_programs=False), on(), L)]
    for kw, enc, dec in cases:
        eng = Eng(**kw)
        assert (programs.encode_programs(eng),
                programs.decode_programs(eng)) == (enc, dec), kw


@pytest.mark.parametrize("rate_mode", ["reservoir", "cbr"])
def test_engine_through_programs(cpu_programs, rate_mode):
    """The Engine's stages through programs (CpuProgram's replays) on a
    file of two full 16-block chunks and a tail, encoded and decoded
    twice: the same bytes, last_measure and last_extras as the direct
    route and the same samples by both parse routes, each stage a program
    at each chunk size, the second run all replays."""
    pcm = fixture_pcm()
    direct = Engine(device="cpu", rate_mode=rate_mode, chunk_blocks=CHUNK)
    direct.use_programs = False
    want = direct.encode(pcm)
    _, want_pcm = direct.decode(want)
    eng = Engine(device="cpu", rate_mode=rate_mode, chunk_blocks=CHUNK)
    dev = Engine(device="cpu", rate_mode=rate_mode, chunk_blocks=CHUNK,
                 decode_parse="device")
    for _ in range(2):
        assert eng.encode(pcm) == want
        np.testing.assert_array_equal(eng.decode(want)[1], want_pcm)
        np.testing.assert_array_equal(dev.decode(want)[1], want_pcm)
        np.testing.assert_array_equal(eng.last_extras, direct.last_extras)
    if rate_mode == "reservoir":
        for a, b in zip(eng.last_measure, direct.last_measure):
            np.testing.assert_array_equal(a, b)
    # the analysis runs in the default chunking's one 64-block batch
    stages = {"analyze": [64], "final": [CHUNK], "decode": [CHUNK],
              "measure": [CHUNK] if rate_mode == "reservoir" else []}
    for stage, sizes in stages.items():
        items = eng.programs.items(stage)
        assert len(items) == len(sizes), stage
        for (key, prog), size in zip(items, sizes):
            assert key[0][0] == "f32" and prog.replays > 0
            shape = key[1][0][0]          # the first input's
            # the PCM [C, (n + 1) N] of the analysis, else blocks first
            assert (shape[1] // 1024 - 1 if stage == "analyze"
                    else shape[0]) == size, stage
    (key, prog), = dev.programs.items("decode_device_parse")
    assert key[1][0][0][0] == 2 * CHUNK and prog.replays > 0  # rows


def test_odd_sizes_run_directly(cpu_programs):
    """A stream's pushes whose sizes are no tail bucket (8 blocks here)
    run padded to the next bucket: only bucket sizes get programs (the
    size of the chunk's rows, the first input's first dimension), and the
    stream is the Engine's bytes."""
    pcm = fixture_pcm()[:20000]
    enc = tstream.StreamingEncoder(device="cpu")
    data = (enc.header(pcm.shape[0]) + enc.push(pcm[:9000])
            + enc.push(pcm[9000:]) + enc.flush())
    direct = Engine(device="cpu")
    direct.use_programs = False
    assert data == direct.encode(pcm)
    built = [k[1][0][0][0] for stage in ("measure", "final")
             for k, _ in enc._eng.programs.items(stage)]
    assert built and 8 not in built
    assert all(s in (16, 32, 64, 96, 128, 192, 256, 384, 512) for s in built)


def test_capture_counts_its_own_thread_only():
    """Launches inside captured_launches go to its counter, and only the
    capturing thread's: another thread launching meanwhile still counts
    into LAUNCHES, and LAUNCHES keeps what it had."""
    K.reset_launches()
    K.LAUNCHES["water_fill"] = 7
    inside, go = threading.Event(), threading.Event()

    def other():
        inside.wait()
        for _ in range(5):
            K._count("water_fill")
        go.set()

    t = threading.Thread(target=other)
    t.start()
    with K.captured_launches() as counts:
        K._count("water_fill")
        inside.set()
        go.wait()
        K._count("reservoir_scan")
        K._count("water_fill")
    t.join()
    K._count("water_fill")                     # counted again after it
    assert counts == {"water_fill": 2, "reservoir_scan": 1}
    assert K.LAUNCHES["water_fill"] == 7 + 5 + 1
    assert K.LAUNCHES["reservoir_scan"] == 0
    K.reset_launches()


def test_tables_a_graph_reads_never_evict():
    """The module caches of device tables that a captured graph reads by
    address keep every entry: a first entry is still the same tensors
    after more keys than any bound the caches had."""
    from pactpu_torch.ops import bitpack
    from pactpu_torch.ops import quantize as q
    layouts = [(4 + k, 8, 12) for k in range(20)]
    first = bitpack.device_plan(layouts[0], 4, 4, 4, "cpu")
    tens = bitpack._plan_tensors(layouts[0], 4, 4, 4, "cpu")
    band = K._band_tensor(layouts[0], torch.device("cpu"))
    ks = K._exp2_ks(torch.device("cpu"), torch.float32, 8, 15)
    for lay in layouts[1:]:
        bitpack.device_plan(lay, 4, 4, 4, "cpu")
        bitpack._plan_tensors(lay, 4, 4, 4, "cpu")
        K._band_tensor(lay, torch.device("cpu"))
    for largest in range(9, 30):
        K._exp2_ks(torch.device("cpu"), torch.float32, largest, 15)
    assert bitpack.device_plan(layouts[0], 4, 4, 4, "cpu") is first
    assert bitpack._plan_tensors(layouts[0], 4, 4, 4, "cpu") is tens
    assert K._band_tensor(layouts[0], torch.device("cpu")) is band
    assert K._exp2_ks(torch.device("cpu"), torch.float32, 8, 15) is ks
    for cache in (bitpack.device_plan, bitpack._plan_tensors,
                  K._band_tensor, K._exp2_ks, q._exp2_table_f64):
        assert cache.cache_info().maxsize is None
