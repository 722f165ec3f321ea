"""The paths that run as programs since streams, the shard paths and the
.pac coder took them (pactpu_torch.codec.programs), on the CPU with
test_torch_programs.CpuProgram's stand-in graph (it reruns the stage into
its static outputs, so an output kept without a clone would change):

- StreamingEncoder pushes inside and outside the buckets, across a batch
  boundary and after restore, the exact stream, and the streamed decode:
  the bytes of Engine.encode and the bytes and samples of the same
  streams launch by launch (programs.launch_by_launch), each push's
  stages at bucket sizes;
- the shard devices' owners (parallel.shard.owner): their tables and
  programs held across two encode_distributed calls (the second replays
  and captures nothing), dropped together past the bound of 8, and
  tables that are not an owner's never read by a program; shard_put
  cutting by slices;
- the .pac coder: the encode and both decode routes through programs
  equal to launch by launch, the parse of its rows (the device route's
  stage) equal to pactpu's parse_rows_body(cfg, huff=False), and
  parse_rows_raw making no tensor from host values;
- encode_programs, decode_programs and shard_programs, stage by stage for
  every path;
- chip_smoke.py's phase 13c rehearsed.

The CUDA graphs themselves: tests/test_torch_cuda.py and chip_smoke.py
phase 13c."""

import gc
import json
import weakref

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from make_torch_port_fixture import fixture_pcm
from pactpu.ops import huffman_decode as jhd
from pactpu.utils.config import CodecConfig as JaxConfig
from pactpu_torch import CodecConfig, Engine
from pactpu_torch.codec import engine as te
from pactpu_torch.codec import programs
from pactpu_torch.codec import stream as tstream
from pactpu_torch.codec.header import read_header
from pactpu_torch.ops import huffman_decode as hd
from pactpu_torch.ops import kernels as K
from pactpu_torch.parallel import cluster, shard
from test_torch_programs import CpuProgram
from torch_threads import torch_threads  # noqa: F401 (autouse)

BUCKETS = te._TAIL_BUCKETS


@pytest.fixture
def cpu_programs(monkeypatch):
    """Every Engine routes its stages as on the card, through programs
    built by CpuProgram, except inside programs.launch_by_launch(); the
    shard owners start empty."""
    monkeypatch.setattr(programs, "Program", CpuProgram)
    monkeypatch.setattr(programs, "_card", lambda eng: (
        eng.use_programs and not programs._all_launch_by_launch))
    shard.owner.cache_clear()
    yield
    shard.owner.cache_clear()


def stream_encode(pcm, cuts, **kw):
    engines = []
    data = chip_smoke.stream_encode(pcm, cuts, engines=engines, **kw)
    return data, engines


def sizes_built(eng, stage):
    """The chunk sizes (rows of the first input) of a stage's programs;
    the analysis's from its PCM window."""
    return sorted({k[1][0][0][1] // 1024 - 1
                   if stage in ("analyze", "baseline")
                   else k[1][0][0][0] for k, _ in eng.programs.items(stage)})


# -- streams ----------------------------------------------------------------

@pytest.fixture(scope="module")
def long_pcm():
    """A 70-block file: one 96-block batch in the Engine's default
    chunking."""
    return chip_smoke.synth(69 * 1024 / chip_smoke.FS, 21)


# (file's samples, push cuts, the restore's cut) of each stream case: a
# 530-block file (a 512-block batch and a 32-block tail batch) whose
# fourth push crosses the batch boundary; a 70-block file
STREAMS = {
    "reservoir-530": (529 * 1024, [0, 9 * 1024, 25 * 1024, 25 * 1024 + 7,
                                   520 * 1024 + 300], 25 * 1024 + 7),
    "cbr-70": (69 * 1024, [0, 9 * 1024, 25 * 1024, 25 * 1024 + 7,
                           65 * 1024 + 300], 25 * 1024 + 7)}


@pytest.mark.parametrize("name", list(STREAMS))
def test_stream_pushes_through_programs(cpu_programs, monkeypatch, name):
    """Pushes of 9 (outside the buckets), 16, 0 and 495 (across the
    512-block batch boundary) or 40 blocks, a restore after the third and
    the flush: the Engine's bytes and the same stream's launch by launch;
    every stage a program at a bucket size that replayed, the analysis at
    the Engine's batch sizes."""
    monkeypatch.setattr(chip_smoke, "DEV", "cpu")
    rate_mode = name.split("-")[0]
    n, cuts, resume = STREAMS[name]
    pcm = chip_smoke.synth(n / chip_smoke.FS, 21)
    cuts = cuts + [n]
    gold = Engine(device="cpu", rate_mode=rate_mode).encode(pcm)
    got, engines = stream_encode(pcm, cuts, rate_mode=rate_mode,
                                 resume_at=resume)
    with programs.launch_by_launch():
        ref, _ = stream_encode(pcm, cuts, rate_mode=rate_mode,
                               resume_at=resume)
    assert got == ref == gold
    assert len(engines) == 2                      # restored: a new Engine
    stages = ["analyze", "final"] + (["measure"] if rate_mode == "reservoir"
                                     else [])
    batches = set(te._default_batches(tstream.file_blocks(n, 1024)))
    for eng in engines:
        for stage in stages:
            assert set(sizes_built(eng, stage)) <= set(BUCKETS), stage
        assert set(sizes_built(eng, "analyze")) <= batches
    replays = engines[1].programs.replays()
    assert all(replays.get(st, 0) > 0 for st in stages), replays
    # the 9-block push ran at 16 rows
    assert 16 in sizes_built(engines[0], "final")
    if rate_mode == "reservoir":
        assert sizes_built(engines[1], "analyze") == [32, 512]
        assert 512 in sizes_built(engines[1], "final")


def test_exact_stream_through_programs(cpu_programs, monkeypatch):
    """The exact stream (K10 and K7's programs) in three pushes: the
    exact Engine's bytes and the launch-by-launch stream's."""
    monkeypatch.setattr(chip_smoke, "DEV", "cpu")
    pcm = chip_smoke.synth(20 * 1024 / chip_smoke.FS, 22)
    cuts = [0, 5000, 12000, pcm.shape[0]]
    gold = Engine(device="cpu", rate_mode="exact").encode(pcm)
    got, (eng,) = stream_encode(pcm, cuts, rate_mode="exact")
    with programs.launch_by_launch():
        ref, _ = stream_encode(pcm, cuts, rate_mode="exact")
    assert got == ref == gold
    replays = eng.programs.replays()
    assert replays["cost"] > 0 and replays["exact_scan"] > 0


def test_stream_push_dispatch_is_the_pushs(cpu_programs, long_pcm):
    """A push split as the card test runs it (_upload, _dispatch, _finish)
    is the push: the stream is the Engine's."""
    pcm = long_pcm
    gold = Engine(device="cpu").encode(pcm)
    enc = tstream.StreamingEncoder(device="cpu")
    parts = [enc.header(pcm.shape[0]), enc.push(pcm[:20 * 1024])]
    host, seq = enc._upload([pcm[20 * 1024:50 * 1024]])
    assert seq.shape == (2, 31 * 1024) and seq.dtype == torch.int16
    parts.append(enc._finish(enc._dispatch(seq), host))
    enc._n_samples += 30 * 1024
    parts += [enc.push(pcm[50 * 1024:]), enc.flush()]
    assert b"".join(parts) == gold


@pytest.mark.parametrize("chunk", [5, 16])
def test_streamed_decode_through_programs(cpu_programs, monkeypatch,
                                          long_pcm, chunk):
    """The streamed decode of a 70-block stream in 5- and 16-block chunks,
    across a restored state: Engine.decode's samples, the launch-by-launch
    decode's, the synthesis a program at the batch's size (96)."""
    monkeypatch.setattr(chip_smoke, "DEV", "cpu")
    eng = Engine(device="cpu")
    stream = eng.encode(long_pcm)
    _, want = eng.decode(stream)
    decoders = []
    got = chip_smoke.stream_decode(stream, chunk, step=3001,
                                   resume_at=3001 * 8, engines=decoders)
    with programs.launch_by_launch():
        ref = chip_smoke.stream_decode(stream, chunk, step=3001,
                                       resume_at=3001 * 8)
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(got, want)
    built = set()
    for dec in decoders:
        built |= set(sizes_built(dec, "synthesize"))
    assert built == {96}
    assert decoders[-1].programs.replays()["synthesize"] > 0


def test_analysis_window_is_the_engines(long_pcm):
    """analyze_blocks hands the stream Engine's "analyze" stage the PCM
    window of the batch (the samples of the blocks at their rows, zeros
    elsewhere): the rows of the blocks equal the Engine's analysis of the
    whole file, bit for bit."""
    eng = Engine(device="cpu")
    b, sizes, whole = eng._analyze(long_pcm)
    whole = {k: torch.cat([a[k] for a in whole]) for k in whole[0]}
    half = 1024
    glob = np.zeros((2, (b + 1) * half), np.int16)
    glob[:, half:half + long_pcm.shape[0]] = long_pcm.T
    for k0, k1 in ((0, 9), (9, 70), (60, 66), (3, 4)):
        seq = torch.from_numpy(glob[:, k0 * half:(k1 + 1) * half].copy())
        parts = tstream.analyze_blocks(eng.cfg, seq, k0, b, eng)
        got = {k: torch.cat([p[k] for p in parts]) for k in parts[0]}
        for key, v in got.items():
            assert torch.equal(v, whole[key][k0:k1]), (k0, k1, key)


# -- the shard owners -------------------------------------------------------

@pytest.fixture(scope="module")
def pcm13():
    return fixture_pcm()[:13 * 1024 - 500]


def test_owner_holds_its_programs_across_calls(cpu_programs, pcm13):
    """Two encode_distributed calls on a mesh of two shards of one device
    and a decode_distributed: one owner, whose tables are mesh_tables';
    the second encode captures nothing and replays; the bytes are the
    launch-by-launch encode's and the cbr Engine's."""
    mesh = shard.make_mesh(["cpu", "cpu"])
    gold = Engine(device="cpu", rate_mode="cbr").encode(pcm13)

    def dist():
        res = cluster.encode_distributed(pcm13, mesh=mesh, rate_mode="cbr")
        return cluster.assemble_stream(res.header, [(0, res.payload)])

    with programs.launch_by_launch():
        ref = dist()
    own, own2 = shard.mesh_owners(CodecConfig(), mesh)
    assert own is own2
    assert all(t is own.consts() for t in shard.mesh_tables(CodecConfig(),
                                                            mesh))
    assert own.programs.captures == 0          # launch by launch: none
    assert dist() == ref == gold
    captured = own.programs.captures
    replayed = own.programs.replays()
    assert captured >= 2 and set(replayed) == {"analyze", "shard_final"}
    assert dist() == gold
    assert own.programs.captures == captured
    assert all(own.programs.replays()[st] > replayed[st] for st in replayed)
    res = cluster.decode_distributed(gold, mesh=mesh)
    with programs.launch_by_launch():
        ref_dec = cluster.decode_distributed(gold, mesh=mesh)
    np.testing.assert_array_equal(res.pcm, ref_dec.pcm)
    dec_owner = shard.mesh_owners(read_header(gold)[0], mesh)[0]
    assert sizes_built(dec_owner, "shard_decode") == [16]
    assert dec_owner.programs.replays()["shard_decode"] > 0


def test_reservoir_and_dense_decode_shards(cpu_programs, pcm13):
    """The measurement pass ("shard_measure") and the host-parse decode's
    synthesis ("shard_synthesize") of four shards through programs: the
    launch-by-launch bytes and samples."""
    mesh = shard.make_mesh(["cpu"] * 4)
    with programs.launch_by_launch():
        ref = cluster.encode_distributed(pcm13, mesh=mesh)
    got = cluster.encode_distributed(pcm13, mesh=mesh)
    assert got.payload == ref.payload and got.savings == ref.savings
    stream = cluster.assemble_stream(got.header, [(0, got.payload)])
    cfg, _, off = read_header(stream)
    with programs.launch_by_launch():
        want = cluster._decode_distributed_dense(stream, off, cfg, mesh)
    res = cluster._decode_distributed_dense(stream, off, cfg, mesh)
    np.testing.assert_array_equal(res.pcm, want.pcm)
    enc_owner = shard.mesh_owners(CodecConfig(), mesh)[0]
    dec_owner = shard.mesh_owners(cfg, mesh)[0]
    assert enc_owner.programs.replays()["shard_measure"] > 0
    assert dec_owner.programs.replays()["shard_synthesize"] > 0


def test_owners_drop_with_their_tables(cpu_programs, pcm13):
    """Past 8 other configurations an owner drops out of the cache with
    its programs and its tables (nothing else holds them, so no program
    outlives the tables it reads); the next call makes a new owner that
    captures anew.  Tables that are not an owner's run launch by launch:
    no program is built on them."""
    mesh = shard.make_mesh(["cpu"])
    cfg = CodecConfig()
    x = shard.shard_put(np.ascontiguousarray(pcm13[:4 * 1024].T), mesh,
                        axis=1)
    ex = [torch.zeros(4)]
    shard.sharded_encode(cfg, mesh, x, ex, 256)
    own = shard.owner(cfg, "f32", torch.device("cpu"))
    assert own.programs.captures > 0
    refs = [weakref.ref(own), weakref.ref(own.consts()["basis"]),
            weakref.ref(own.programs.items("shard_final")[0][1])]
    del own
    for k in range(8):
        shard.owner(CodecConfig(target_bits_per_sample=3.0 + k), "f32",
                    torch.device("cpu"))
    gc.collect()
    assert all(r() is None for r in refs)
    new = shard.owner(cfg, "f32", torch.device("cpu"))
    assert new.programs.captures == 0
    foreign = [te.device_tables(cfg, "cpu")]
    a, hist_a = shard.sharded_encode(cfg, mesh, x, ex, 256, consts=foreign)
    assert new.programs.items("shard_final") == []
    b, hist_b = shard.sharded_encode(cfg, mesh, x, ex, 256)
    assert new.programs.items("shard_final") != []
    assert torch.equal(hist_a, hist_b)
    assert all(torch.equal(a[0][k], b[0][k]) for k in a[0])


def test_shard_put_slices(monkeypatch):
    """shard_put cuts the array by slices (np.take of an index array
    copies element by element through an index as long as the file):
    each shard's run on either axis, no np.take."""
    mesh = shard.make_mesh(["cpu"] * 4)
    a = np.arange(2 * 48, dtype=np.int16).reshape(2, 48)

    def refuse(*args, **kw):
        raise AssertionError("np.take")

    monkeypatch.setattr(np, "take", refuse)
    for axis, arr in ((1, a), (0, a.T.copy())):
        parts = shard.shard_put(arr, mesh, axis=axis)
        for k, p in enumerate(parts):
            want = np.split(arr, 4, axis=axis)[k]
            assert p.is_contiguous()
            np.testing.assert_array_equal(p.numpy(), want)


# -- .pac -------------------------------------------------------------------

@pytest.mark.parametrize("channels", [2, 1])
def test_pac_through_programs(cpu_programs, channels):
    """The .pac encode ("baseline") and its decode by host and device
    parse, twice through programs: the bytes and samples of the same
    Engines launch by launch."""
    cfg = CodecConfig(n_channels=channels)
    pcm = np.ascontiguousarray(fixture_pcm()[:, :channels])
    eng = Engine(device="cpu", cfg=cfg, fmt="pac", chunk_blocks=16)
    dev = Engine(device="cpu", cfg=cfg, fmt="pac", chunk_blocks=16,
                 decode_parse="device")
    with programs.launch_by_launch():
        want = eng.encode(pcm)
        want_pcm = eng.decode(want)[1]
    for _ in range(2):
        assert eng.encode(pcm) == want
        np.testing.assert_array_equal(eng.decode(want)[1], want_pcm)
        np.testing.assert_array_equal(dev.decode(want)[1], want_pcm)
    assert eng.programs.replays()["baseline"] > 0
    assert sizes_built(eng, "baseline") == [64]
    assert dev.programs.replays()["decode_device_parse"] > 0
    assert eng.programs.replays()["decode"] > 0


def test_pac_parse_through_a_program_is_pactpus(cpu_programs):
    """The rows of a .pac stream parsed by parse_rows_raw through a
    program (its stand-in graph, replayed) equal pactpu's
    parse_rows_body(cfg, huff=False) on the same rows, field for field."""
    pcm = fixture_pcm()[:20000]
    eng = Engine(device="cpu", fmt="pac")
    stream = eng.encode(pcm)
    words, nbits = hd.frame_rows(stream[read_header(stream)[2]:])
    cfg = CodecConfig()
    lay = eng.consts()["lay"]
    cache = programs.Programs("cpu")
    t = (torch.from_numpy(words.view(np.int32).copy()),
         torch.from_numpy(nbits.astype(np.int32)))

    def stage(w, n):
        return hd.parse_rows_raw(cfg, w, n, lay)

    cache.run("parse", (), stage, t)                    # builds
    got = cache.run("parse", (), stage, t)              # replays
    assert cache.items("parse")[0][1].replays == 1
    want = jax.jit(jhd.parse_rows_body(JaxConfig(), huff=False))(
        jnp.asarray(words), jnp.asarray(nbits, jnp.int32))
    for key in ("overall", "tid", "ba", "sf", "mant", "lrms", "bad"):
        np.testing.assert_array_equal(got[key].numpy(),
                                      np.asarray(want[key]), err_msg=key)


def test_parse_rows_raw_makes_no_tensor_from_host_values(monkeypatch):
    """parse_rows_raw makes its side-field offsets and widths on the
    device (a capture cannot hold a copy from the host): no torch.tensor,
    torch.as_tensor or torch.from_numpy inside it."""
    pcm = fixture_pcm()[:8000]
    eng = Engine(device="cpu", fmt="pac")
    stream = eng.encode(pcm)
    words, nbits = hd.frame_rows(stream[read_header(stream)[2]:])
    w = torch.from_numpy(words.view(np.int32).copy())
    n = torch.from_numpy(nbits.astype(np.int32))
    lay = eng.consts()["lay"]
    want = hd.parse_rows_raw(CodecConfig(), w, n, lay)
    made = []
    for name in ("tensor", "as_tensor", "from_numpy"):
        real = getattr(torch, name)
        monkeypatch.setattr(torch, name, lambda *a, _r=real, _n=name, **k: (
            made.append(_n), _r(*a, **k))[1])
    got = hd.parse_rows_raw(CodecConfig(), w, n, lay)
    monkeypatch.undo()
    assert made == []
    assert all(torch.equal(got[k], want[k]) for k in want)


# -- the routes ---------------------------------------------------------------

def test_routes_of_every_path(monkeypatch):
    """encode_programs stage by stage, decode_programs and shard_programs
    for .wak and .pac in every rate mode, with debug_checks, with
    use_programs off, on the CPU and inside launch_by_launch: on the card
    every path's stages are programs but debug_checks' encode."""
    P = set()

    def answer(eng):
        return ({s for s, on in programs.encode_programs(eng).items() if on},
                programs.decode_programs(eng),
                {s for s, on in programs.shard_programs(eng).items() if on})

    shards = set(programs.SHARD_STAGES)
    cases = [
        (dict(), {"analyze", "measure", "final"}, True, shards),
        (dict(rate_mode="cbr"), {"analyze", "final"}, True, shards),
        (dict(rate_mode="exact"),
         {"analyze", "cost", "exact_scan", "final"}, True, shards),
        (dict(fmt="pac"), {"baseline"}, True, shards),
        (dict(fmt="pac", rate_mode="cbr"), {"baseline"}, True, shards),
        (dict(debug_checks=True), P, True, shards),
        (dict(fmt="pac", debug_checks=True), P, True, shards),
    ]
    for kw, enc, dec, sh in cases:
        eng = Engine(device="cpu", **kw)
        assert answer(eng) == (P, False, P), kw
        eng.device = torch.device("cuda", 0)       # the route alone
        assert answer(eng) == (enc, dec, sh), kw
        with programs.launch_by_launch():
            assert answer(eng) == (P, False, P), kw
        assert answer(eng) == (enc, dec, sh), kw
        eng.use_programs = False
        assert answer(eng) == (P, False, P), kw
    # a stream's Engine and a shard owner answer as any Engine
    enc = tstream.StreamingEncoder(device="cpu")
    enc._eng.device = torch.device("cuda", 0)
    assert answer(enc._eng)[0] == {"analyze", "measure", "final"}
    own = shard.owner(CodecConfig(), "f32", torch.device("cpu"))
    assert own.rate_mode == "cbr" and own.fmt == "wak"


# -- chip_smoke.py phase 13c --------------------------------------------------

def test_program_paths_phase_on_cpu(cpu_programs, monkeypatch, capsys):
    """chip_smoke.phase13_paths on files of 1.2, 0.3 and 0.8 s with the
    stand-in programs and meshes of 1 and 2 shards: every gate holds, each
    path's stages replayed, and the timings come in turns (the card's
    numbers, its sync debug mode and its pools are the card's)."""
    monkeypatch.setattr(chip_smoke, "DEV", "cpu")
    launches = chip_smoke.phase13_paths(
        torch, lambda **kw: Engine(device="cpu", **kw),
        chip_smoke.synth(1.2, 23), chip_smoke.synth(0.3, 24),
        chip_smoke.synth(0.8, 25), shards=(1, 2), ckpt_block=30)
    assert set(launches) == set(K.LAUNCHES)        # the CPU launches none
    line, = [json.loads(x) for x in capsys.readouterr().out.splitlines()
             if "13c-program-paths" in x]
    for path, stages in chip_smoke.PATH_STAGES.items():
        assert all(line[path]["replays"][s] > 0 for s in stages), path
        assert line[path]["captures"] > 0 and line[path]["pools_mb"] is None
    for key in ("stream_1s_encode_s", "stream_16_decode_s",
                "shards_1_cbr_long_s", "shards_2_cbr_long_s",
                "pac_encode_s", "pac_device_decode_s"):
        assert [len(v) for v in line[key].values()] == [2, 2], key
    assert line["memory_mb"] is None
