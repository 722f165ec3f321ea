"""The program layer for every .wak configuration (pactpu_torch.codec.
programs), on the CPU:

- a capture runs on a capture stream of the Engine's device and under its
  device context, never on torch's process-wide default capture stream,
  and a replay runs under the same context (a stand-in for torch.cuda's
  graph API records what it receives); the exact mode's cost programs
  take a memory pool apart from the rest;
- engine.resolve_device("cuda") names the current device by its index;
- which stages run as programs, stage by stage, for the exact mode in
  both precisions, the four other allocators and device_pack=False;
- the Engine through programs (test_torch_programs.CpuProgram's stand-in
  graph, which reruns the stage into its static outputs) gives the bytes
  and last_extras of use_programs=False, bit for bit, in each of those
  configurations over a padded tail;
- K7's plain version with a valid mask equals its count form and
  pactpu's extras_scan_body, the carry chained over a padded tail;
- chip_smoke.py's phase 13b rehearsed with the stand-in programs.

The CUDA graphs themselves: tests/test_torch_cuda.py and chip_smoke.py
phase 13."""

import contextlib
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from make_torch_port_fixture import fixture_pcm
from pactpu.codec import exact as jx
from pactpu.utils.config import CodecConfig as JaxConfig
from pactpu_torch import CodecConfig, Engine
from pactpu_torch.codec import engine as te
from pactpu_torch.codec import exact as tx
from pactpu_torch.codec import programs
from pactpu_torch.ops import kernels as K
from test_torch_programs import CpuProgram
from torch_threads import torch_threads  # noqa: F401 (autouse)

CHUNK = 16
STAGES = ("analyze", "measure", "cost", "exact_scan", "final", "baseline")

# the configurations that took programs in this slice: Engine keywords
CONFIGS = {
    "exact-f32": dict(rate_mode="exact"),
    "exact-f64": dict(rate_mode="exact", precision="f64"),
    **{mode: dict(cfg=CodecConfig(alloc_mode=mode))
       for mode in ("closed_form", "uniform", "const_snr", "const_mnr")},
    "host-pack": dict(device_pack=False),
}


# -- the capture's device and stream ----------------------------------------

class FakeStream:
    def __init__(self, device=None):
        self.device = None if device is None else torch.device(device)

    def wait_stream(self, other):
        pass


@pytest.fixture
def fake_cuda(monkeypatch):
    """torch.cuda's device, stream and graph API on the CPU, recording
    the device contexts entered (ctx: the open ones), each capture's
    arguments and context, and each replay's context."""
    rec = dict(ctx=[], graphs=[], replays=[])

    @contextlib.contextmanager
    def device(d):
        rec["ctx"].append(torch.device(d))
        try:
            yield
        finally:
            rec["ctx"].pop()

    class Graph:
        def __init__(self, graph, pool=None, stream=None,
                     capture_error_mode="global"):
            rec["graphs"].append(dict(pool=pool, stream=stream,
                                      mode=capture_error_mode,
                                      ctx=list(rec["ctx"])))

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

    class CUDAGraph:
        def replay(self):
            rec["replays"].append(list(rec["ctx"]))

    handles = iter(range(1000))
    for name, value in (("device", device), ("Stream", FakeStream),
                        ("stream", lambda s: contextlib.nullcontext()),
                        ("current_stream", lambda d=None: FakeStream(d)),
                        ("graph", Graph), ("CUDAGraph", CUDAGraph),
                        ("current_device", lambda: 3),
                        ("is_available", lambda: True),
                        ("graph_pool_handle", lambda: (next(handles), 0))):
        monkeypatch.setattr(torch.cuda, name, value)
    monkeypatch.setattr(programs, "_static_inputs",
                        lambda args, dev: [a.clone() for a in args])
    programs.stream.cache_clear()
    yield rec
    programs.stream.cache_clear()


def test_capture_on_the_devices_capture_stream(fake_cuda):
    """Program.build captures on the device's own capture stream (never
    None, which would take torch's process-wide default capture stream),
    inside the device's context, in thread-local mode, into the pool
    given; the replay runs inside the same device's context."""
    dev = torch.device("cuda", 1)
    prog, warm = programs.Program.build(
        "stage", lambda x: {"y": x * 2}, (torch.ones(3),), dev, pool="P")
    assert torch.equal(warm["y"], torch.full((3,), 2.0))
    (g,) = fake_cuda["graphs"]
    assert g["stream"] is not None
    assert g["stream"] is programs.stream(dev, "capture")
    assert g["stream"].device == dev
    assert g["stream"] is not programs.stream(dev, "warm")
    assert programs.stream(torch.device("cuda", 0), "capture") \
        is not g["stream"]
    assert g["ctx"] == [dev] and g["pool"] == "P"
    assert g["mode"] == "thread_local"
    prog(torch.full((3,), 5.0))
    assert fake_cuda["replays"] == [[dev]] and prog.replays == 1
    assert fake_cuda["ctx"] == []


def test_first_outputs_that_alias_an_input_survive_the_next_call(fake_cuda):
    """A stage that hands an input on as an output (the final pass's
    overall and lrms): the first call's outputs, the warm-up's, are not
    the static inputs that the next call copies its own into (with
    device_pack=False a first chunk's overall and lrms took the second
    chunk's)."""
    prog, warm = programs.Program.build(
        "stage", lambda x, y: {"x": x, "view": x[1:], "y2": y * 2},
        (torch.ones(3), torch.ones(2)), torch.device("cuda", 0))
    prog(torch.full((3,), 7.0), torch.zeros(2))
    assert torch.equal(warm["x"], torch.ones(3))
    assert torch.equal(warm["view"], torch.ones(2))
    assert torch.equal(warm["y2"], torch.full((2,), 2.0))


def test_engine_off_the_current_device_captures_on_its_own(fake_cuda):
    """An Engine of cuda:1 while cuda:3 is current: every capture of its
    programs runs on cuda:1's capture stream under cuda:1; the exact
    mode's cost stage (replayed on a second stream beside K7's) takes a
    pool of its own, every other stage the Engine's one main pool."""
    eng = Engine(device="cuda:1", rate_mode="exact")
    assert eng.device == torch.device("cuda", 1)
    for stage in ("analyze", "cost", "exact_scan", "final", "cost"):
        eng.programs.run(stage, (stage,), lambda x: x + 1,
                         (torch.ones(2 + len(fake_cuda["graphs"])),))
    graphs = fake_cuda["graphs"]
    capture = programs.stream(eng.device, "capture")
    assert all(g["stream"] is capture and g["ctx"] == [eng.device]
               for g in graphs)
    pools = [g["pool"] for g in graphs]
    assert pools[0] == pools[2] == pools[3] != pools[1] == pools[4]
    assert programs.Programs.pool_of("cost") == "side"
    assert programs.Programs.pool_of("exact_scan") == "main"


def test_resolve_device_indexes_cuda(monkeypatch):
    """"cuda" is the current device by its index when the Engine is made
    (its tables, streams, pools and programs then stay there); an index
    given is kept, the CPU stays the CPU, and without a card CUDA
    raises."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 2)
    assert te.resolve_device("cuda") == torch.device("cuda", 2)
    assert te.resolve_device(torch.device("cuda")).index == 2
    assert te.resolve_device("cuda:1") == torch.device("cuda", 1)
    assert te.resolve_device("cpu") == torch.device("cpu")
    assert Engine(device="cuda").device == torch.device("cuda", 2)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        te.resolve_device("cuda")


# -- the routes, stage by stage ---------------------------------------------

@pytest.mark.parametrize("name", list(CONFIGS))
def test_stage_routes(name):
    """On the card every stage of the configuration's encode runs as a
    program (pactpu's jit factories), and its decode too; on the CPU,
    with use_programs off or with debug_checks, none does."""
    kw = CONFIGS[name]
    eng = Engine(device="cpu", **kw)
    assert programs.encode_programs(eng) == dict.fromkeys(STAGES, False)
    assert not programs.decode_programs(eng)
    eng.device = torch.device("cuda", 0)           # the route alone
    want = chip_smoke.program_stages(kw)
    assert programs.encode_programs(eng) == {s: s in want for s in STAGES}
    assert programs.decode_programs(eng)
    eng.use_programs = False
    assert not any(programs.encode_programs(eng).values())
    eng.use_programs, eng.debug_checks = True, True
    assert not any(programs.encode_programs(eng).values())


# -- the Engine through programs --------------------------------------------

@pytest.fixture
def cpu_programs(monkeypatch):
    """Every Engine with use_programs routes its stages as on the card,
    through programs built by CpuProgram."""
    monkeypatch.setattr(programs, "Program", CpuProgram)
    monkeypatch.setattr(programs, "_card", lambda eng: eng.use_programs)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_programs_equal_launch_by_launch(cpu_programs, name):
    """A file of two full 16-block chunks and a padded tail, encoded twice
    through programs: the bytes and last_extras of the same configuration
    with use_programs=False, bit for bit; each of the configuration's
    stages a program at each chunk size (the analysis at the default
    chunking's 64-block batch) and replayed, the others never built."""
    kw = CONFIGS[name]
    pcm = fixture_pcm()
    direct = Engine(device="cpu", chunk_blocks=CHUNK, **kw)
    direct.use_programs = False
    want = direct.encode(pcm)
    eng = Engine(device="cpu", chunk_blocks=CHUNK, **kw)
    for _ in range(2):
        assert eng.encode(pcm) == want
        np.testing.assert_array_equal(eng.last_extras.view(np.int32),
                                      direct.last_extras.view(np.int32))
    built = {s for s in STAGES if eng.programs.items(s)}
    assert built == chip_smoke.program_stages(kw)
    for stage in built:
        sizes = sorted(k[1][0][0][1] // 1024 - 1 if stage == "analyze"
                       else k[1][0][0][0] for k, _ in eng.programs.items(stage))
        assert sizes == ([64] if stage == "analyze" else [CHUNK]), stage
        assert all(p.replays > 0 for _, p in eng.programs.items(stage))
    if kw.get("rate_mode") == "exact":
        (key, _), = eng.programs.items("exact_scan")
        # smr, lrms, cost, valid, carry: valid is a device mask
        assert key[1][3] == ((CHUNK,), torch.bool)
        assert key[0][0] == kw.get("precision", "f32")


def test_program_modes_phase_on_cpu(cpu_programs, monkeypatch, capsys):
    """chip_smoke.phase13_modes on files of 0.3 and 0.1 s with the
    stand-in programs, every chunk of 16 blocks: every configuration's routes, bytes, samples and
    dispatch hold, each built its stages' programs and replayed them, and
    the exact timing runs in both precisions (the card's numbers, the
    sync debug mode and the launch counts are the card's)."""
    monkeypatch.setattr(chip_smoke, "DEV", "cpu")
    total = chip_smoke.phase13_modes(
        torch, lambda **kw: Engine(device="cpu",
                                   **{**kw, "chunk_blocks": CHUNK}),
        chip_smoke.synth(0.3, 1), chip_smoke.synth(0.1, 2), reps=1)
    assert set(total) == set(K.LAUNCHES)
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    modes = [x for x in lines if x["phase"] == "13b-program-modes"]
    assert [x["mode"] for x in modes] == [m for m, _ in
                                          chip_smoke.PROGRAM_MODES]
    for x in modes:
        want = chip_smoke.program_stages(
            dict(chip_smoke.PROGRAM_MODES)[x["mode"]])
        assert {s for s, on in x["routes"].items() if on} == want
        assert set(x["replays"]) == want and all(
            n > 0 for n in x["replays"].values()), x["mode"]
        assert x["captures"] >= len(want) and x["memory_mb"] is None
    timing = [x for x in lines if x["phase"] == "13b-exact-timing"]
    assert [x["precision"] for x in timing] == ["f32", "f64"]
    assert all(len(x["serial_encode_programs_blocks_per_s"]) == 2
               for x in timing)


# -- K7's valid mask --------------------------------------------------------

@pytest.mark.parametrize("channels", [2, 1], ids=["stereo", "mono"])
def test_scan_valid_mask_equals_count_and_pactpu(channels):
    """exact_scan_plain with pactpu's valid mask (and through the wrapper
    on a CPU tensor) equals its count form and pactpu's extras_scan_body
    bit for bit (extras as float32, the int32 carry) over two 16-block
    chunks, the second with 4 real blocks, from a carry that settles a
    negative deposit, the carry chained from chunk to chunk."""
    cfg, jcfg = CodecConfig(n_channels=channels), JaxConfig(
        n_channels=channels)
    pcm = np.ascontiguousarray(fixture_pcm()[:19 * 1024, :channels])
    eng = Engine(cfg, "exact", chunk_blocks=CHUNK, device="cpu")
    b, sizes, analyses = eng._analyze(pcm)
    assert b == 20 and sizes == [CHUNK, CHUNK]
    dev = eng.consts()
    scan = jx.extras_scan_body(jcfg)
    carry = torch.tensor([-700, 35], dtype=torch.int32)
    gold_carry = jnp.asarray(carry.numpy())
    done = 0
    for a in analyses:
        cost = tx.cost_table(cfg, a, dev)
        valid = torch.arange(CHUNK) < b - done
        args = (a["smr"], a["lrms"], cost)
        rest = (float(cfg.bit_budget()), dev["lay"]["n_lines"],
                tx.max_mant(cfg), cfg.ms_stop_threshold_db,
                cfg.lr_stop_threshold_db, cfg.n_table_id_bits,
                cfg.reservoir_withdraw_divisor)
        ex, out = K.exact_scan_plain(*args, valid, carry, *rest)
        by_count = K.exact_scan_plain(*args, int(valid.sum()), carry, *rest)
        wrapped = K.exact_scan(*args, valid, carry, *rest)
        for other in (by_count, wrapped):
            assert torch.equal(other[0], ex) and torch.equal(other[1], out)
        gold_ex, gold_carry = scan(*(jnp.asarray(t.numpy()) for t in (
            a["smr"], a["lrms"], cost, valid)), gold_carry)
        np.testing.assert_array_equal(
            ex.to(torch.float32).numpy().view(np.int32),
            np.asarray(gold_ex).view(np.int32))
        np.testing.assert_array_equal(out.numpy(), np.asarray(gold_carry))
        assert not ex[max(0, b - done):].any()
        carry, done = out, done + CHUNK
    assert K.LAUNCHES["exact_scan"] == 0


def test_scan_refuses_a_mask_of_another_shape():
    cfg = CodecConfig()
    dev = te.device_tables(cfg, "cpu")
    smr = torch.zeros((4, 2, cfg.n_bands))
    args = (smr, torch.zeros((4, cfg.n_bands), dtype=torch.bool),
            torch.zeros((4, 2, cfg.n_bands, 17, 10), dtype=torch.int32))
    rest = (torch.zeros(2, dtype=torch.int32), 100.0,
            dev["lay"]["n_lines"], 16, -5.0, -15.0, 4, 100)
    with pytest.raises(ValueError, match="shapes disagree"):
        K.exact_scan(*args, torch.ones(5, dtype=torch.bool), *rest)
    with pytest.raises(TypeError, match="valid"):
        K.exact_scan(*args, torch.ones(4, dtype=torch.int32), *rest)
    ex, carry = K.exact_scan(*args, torch.zeros(4, dtype=torch.bool), *rest)
    assert not ex.any() and carry.tolist() == [0, 0]
