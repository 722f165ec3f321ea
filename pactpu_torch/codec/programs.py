"""The program layer (pactpu's cached jax.jit chunk programs) on PyTorch.

pactpu runs each stage of a chunk as one compiled XLA program, cached by
`lru_cache` on its configuration.  Eager PyTorch runs a stage as a few
hundred launches, each a wrapper and a few microseconds of host time.  On
the card a stage function here is captured once a key into a
`torch.cuda.CUDAGraph` and then replayed: one launch of the host's.

- Key: the stage's name, what the Engine says decides the stage (config,
  precision, flags such as a word width) and the shapes and types of its
  tensor inputs.  A bounded cache (MAX_PROGRAMS a stage, as pactpu's
  `lru_cache(maxsize=16)`) holds the programs of one Engine: a graph reads
  the Engine's constant tables where it was captured, so programs are not
  shared between Engines.  A graph also reads, by address, the device
  tables that module caches hold (the pack plan, the band and exp2
  tables): those caches never evict, so what a graph reads stays alive.
- Capture: the stage runs once on a warm-up stream (the warm-up fills the
  caches that would break a capture, such as the pack plan, the walk LUT
  and K10's packed table set, and its launches are real and counted),
  then once under capture, into a memory pool of the Engine's.  Every
  step runs under `torch.cuda.device(device)`, and the capture runs on a
  capture stream of the Engine's device (one a device, never torch's
  process-wide default capture stream, which lives on whichever device
  was current at the first capture): the kernel wrappers and torch ops
  launch on the current stream of their tensors' device, so a capture on
  a stream of another device would leave the graph empty.  The first call
  returns the warm-up's outputs.  A capture that fails raises
  CaptureError naming the stage: nothing runs eagerly in its place.
- Replay: under the Engine's device, the call's tensors are copied into
  the graph's static inputs (host arrays are uploaded into them), the
  graph is replayed on the caller's stream, and the outputs are returned
  as clones: a later replay of the same graph, or of another graph of the
  pool, overwrites its static outputs, and a chunk's analysis,
  measurement and words live past the next chunk's replay.
- Pools: replays on one stream run one at a time, each cloned out before
  the next, so those graphs share one pool ("main").  The exact mode
  replays chunk k + 1's cost program (K10) on a second stream while chunk
  k's exact_scan program (K7) replays on the caller's: the stages of
  SIDE_STAGES take a pool of their own ("side"), so that two graphs
  running at once never share intermediates or static outputs.
- Spans (pactpu_torch.utils.metrics.span): a replay is the span
  "replay:<stage>" (the inputs copied in, the graph launched, the
  outputs cloned out), a first call "capture:<stage>" (the warm-up and
  the capture), and a stage the Engine runs directly "direct:<stage>";
  each counts the chunk's blocks.
- Launches: `kernels.LAUNCHES` counts wrapper calls, and a replay calls
  none.  The capturing thread's launches are counted apart
  (kernels.captured_launches: a capture launches nothing, and other
  threads go on counting theirs); a program adds them on each replay, so
  a programmed run counts what the same run launch by launch counts.

Which of an Engine's stages run as programs is decided stage by stage
from its configuration alone, before any capture (encode_programs,
decode_programs, shard_programs), as pactpu compiles a jit program for
each stage of every configuration: on the CPU, or with
`Engine.use_programs` False, every stage function runs directly, launch
by launch; on the card every stage of every configuration runs as a
program, the .pac coder's and a stream's included, except with
debug_checks (host checks between the passes, by design).  The shard
paths (pactpu_torch.parallel.shard) run theirs through an Engine that
owns a shard device's tables and programs (shard.owner).  Whatever the
stage, a chunk whose block count is none of the Engine's buckets runs
directly (Engine._run_stage).
"""

from __future__ import annotations

import collections
import contextlib
import threading
import time
from functools import lru_cache

import torch
from torch.utils._pytree import tree_flatten, tree_unflatten

from pactpu_torch.ops import kernels
from pactpu_torch.utils.metrics import span

# programs a stage keeps per Engine, least recently used dropped first
MAX_PROGRAMS = 16

# one capture at a time in the process (a capture synchronizes the device
# and empties the allocator's cache first: DeviceFleet runs an Engine a
# thread)
_capture_lock = threading.Lock()


class CaptureError(RuntimeError):
    """A stage that could not be captured into a CUDA graph (a host sync,
    a pageable copy, a cache filled inside the stage)."""


# stages whose programs replay on a second stream beside another
# program's replay (the exact mode's cost tables beside K7): a memory
# pool of their own
SIDE_STAGES = frozenset({"cost"})


# set inside launch_by_launch(): every stage of every Engine runs directly
_all_launch_by_launch = False


@contextlib.contextmanager
def launch_by_launch():
    """Inside it every stage of every Engine runs launch by launch, as with
    Engine.use_programs False: the Engines that streams and the shard
    owners hold too (the eager chain that chip_smoke.py and the card
    tests hold the programs to).  Not thread-safe: it is process-wide."""
    global _all_launch_by_launch
    saved, _all_launch_by_launch = _all_launch_by_launch, True
    try:
        yield
    finally:
        _all_launch_by_launch = saved


def _card(eng) -> bool:
    """Whether any of eng's stages may run as a program: on the card, with
    eng.use_programs, outside launch_by_launch()."""
    return (eng.device.type == "cuda" and eng.use_programs
            and not _all_launch_by_launch)


def encode_programs(eng) -> dict:
    """Which of an Engine's encode stages run as programs, stage by stage,
    as pactpu compiles one for each (_chunk_analyze_fn, _reservoir_scan_fn,
    _finalize_fn for every allocator and pack width, _cost_fn, _extras_fn
    and _encode_baseline_fn): on the card with eng.use_programs, for .wak,
    "analyze" and "final" in every rate mode, allocator and packing
    (device_pack=False: pack width 0); "measure" (the measurement pass
    with K11) in the reservoir mode; "cost" (K10) and "exact_scan" (K7) in
    the exact mode; for .pac, "baseline" (the whole baseline encode of a
    batch).  A stream's pushes run the same stages.  debug_checks (host
    checks between the passes, by design) runs every stage launch by
    launch."""
    on = _card(eng) and not eng.debug_checks
    wak = on and eng.fmt == "wak"
    exact = wak and eng.rate_mode == "exact"
    return dict(analyze=wak, measure=wak and eng.rate_mode == "reservoir",
                cost=exact, exact_scan=exact, final=wak,
                baseline=on and eng.fmt == "pac")


def decode_programs(eng) -> bool:
    """Whether an Engine's decode stages run as programs: on the card,
    with eng.use_programs, for .wak and .pac on either parse route
    ("decode", "decode_device_parse") and a stream's synthesis
    ("synthesize")."""
    return _card(eng)


# the stages of a shard device's owner (pactpu's sharded_*_fn): the
# analysis is the Engine's own stage
SHARD_STAGES = ("analyze", "shard_measure", "shard_final", "shard_decode",
                "shard_synthesize")


def shard_programs(eng) -> dict:
    """Which stages of the shard paths run as programs on a shard device's
    owner (pactpu_torch.parallel.shard.owner), stage by stage, as pactpu
    compiles sharded_encode_fn, sharded_measure_fn, sharded_decode_fn and
    sharded_decode_payload_fn: all of them on the card with
    eng.use_programs.  The collectives run between the replays."""
    return dict.fromkeys(SHARD_STAGES, _card(eng))


@lru_cache(maxsize=None)
def stream(device: torch.device, role: str) -> torch.cuda.Stream:
    """The stream of one role on an indexed CUDA device (an Engine's:
    engine.resolve_device), made once: "warm" (the warm-ups), "capture"
    (every capture of the device) or "cost" (the exact mode's cost tables
    beside K7)."""
    with torch.cuda.device(device):
        return torch.cuda.Stream(device)


def _static_inputs(args, device) -> list:
    """The graph's static inputs: a copy of each argument on device."""
    static_in = [torch.empty(a.shape, dtype=a.dtype, device=device)
                 for a in args]
    for s, a in zip(static_in, args):
        s.copy_(a)
    return static_in


def _unaliased(out, static_in: list):
    """out with each tensor that shares memory with a static input cloned
    (a stage may hand an input on as an output: the final pass's overall
    and lrms): the next call copies its inputs into the static inputs, and
    the first call's outputs live past it."""
    ins = {s.untyped_storage().data_ptr() for s in static_in}
    leaves, spec = tree_flatten(out)
    return tree_unflatten(
        [t.clone() if torch.is_tensor(t)
         and t.untyped_storage().data_ptr() in ins else t for t in leaves],
        spec)


class Program:
    """One stage function captured into a CUDA graph at the shapes of its
    first call.  Program.build(...) returns (program, the warm-up's
    outputs); program(*args) replays it on args."""

    def __init__(self, stage: str, graph, static_in: list, out,
                 launches: dict, device=None):
        self.stage = stage
        self.span_name = "replay:" + stage     # its replays' span
        self.graph = graph
        self.static_in = static_in
        self.static_out, self.spec = tree_flatten(out)
        self.launches = launches
        self.device = device
        self.replays = 0

    @classmethod
    def build(cls, stage: str, fn, args, device: torch.device, pool=None):
        """Warm fn up on static copies of args on the device's warm-up
        stream, then capture it on the device's capture stream (into the
        memory pool `pool`, None = a pool of its own), all under the
        device's context."""
        with torch.cuda.device(device):
            static_in = _static_inputs(args, device)
            main = torch.cuda.current_stream(device)
            warm_stream = stream(device, "warm")
            warm_stream.wait_stream(main)
            with torch.cuda.stream(warm_stream):
                warm = _unaliased(fn(*static_in), static_in)
            main.wait_stream(warm_stream)
            graph = torch.cuda.CUDAGraph()
            try:
                with kernels.captured_launches() as launches, \
                        torch.cuda.graph(graph, pool=pool,
                                         stream=stream(device, "capture"),
                                         capture_error_mode="thread_local"):
                    out = fn(*static_in)
            except Exception as e:
                raise CaptureError(
                    f"program {stage!r}: the stage could not be captured "
                    f"into a CUDA graph ({e})") from e
        return cls(stage, graph, static_in, out, dict(launches),
                   device), warm

    def replay(self) -> None:
        """Run the captured stage on the static inputs into the static
        outputs."""
        self.graph.replay()

    def __call__(self, *args):
        # device None: the tests' CPU stand-in graphs
        with (contextlib.nullcontext() if self.device is None
              else torch.cuda.device(self.device)):
            for s, a in zip(self.static_in, args):
                s.copy_(a)
            self.replay()
            out = [t.clone() if torch.is_tensor(t) else t
                   for t in self.static_out]
        self.replays += 1
        for k, n in self.launches.items():
            kernels.LAUNCHES[k] += n
        return tree_unflatten(out, self.spec)


class Programs:
    """The programs of one Engine: per stage an LRU cache of at most
    MAX_PROGRAMS programs by key, captured into the Engine's memory pool
    of the stage ("side" for SIDE_STAGES, else "main").  capture_s sums
    the host seconds spent building them (warm-up and capture), captures
    counts them."""

    def __init__(self, device):
        self.device = torch.device(device)
        self._stages = {}
        self._pools = {}
        self.capture_s = 0.0
        self.captures = 0

    @staticmethod
    def key(key: tuple, args) -> tuple:
        """A program's full key: the caller's and its inputs' shapes and
        types."""
        return (key, tuple((tuple(a.shape), a.dtype) for a in args))

    @staticmethod
    def pool_of(stage: str) -> str:
        return "side" if stage in SIDE_STAGES else "main"

    def run(self, stage: str, key: tuple, fn, args, blocks: int = 0):
        """fn(*args) through the stage's program for key (built at the
        first call), a span "replay:<stage>" or "capture:<stage>" of
        `blocks` blocks.  fn must depend on nothing but its tensor
        arguments and what key names."""
        cache = self._stages.setdefault(stage, collections.OrderedDict())
        full = self.key(key, args)
        prog = cache.get(full)
        if prog is not None:
            cache.move_to_end(full)
            with span(prog.span_name, blocks=blocks):
                return prog(*args)
        with span("capture:" + stage, blocks=blocks):
            return self._capture(stage, cache, full, fn, args)

    def _capture(self, stage: str, cache, full: tuple, fn, args):
        pool = self.pool_of(stage)
        if pool not in self._pools and self.device.type == "cuda":
            self._pools[pool] = torch.cuda.graph_pool_handle()
        with _capture_lock:
            t0 = time.perf_counter()
            try:
                prog, warm = Program.build(stage, fn, args, self.device,
                                           self._pools.get(pool))
            except CaptureError:
                # the next capture takes a new pool
                self._pools.pop(pool, None)
                raise
            self.capture_s += time.perf_counter() - t0
        self.captures += 1
        cache[full] = prog
        if len(cache) > MAX_PROGRAMS:
            cache.popitem(last=False)
        return warm

    def replays(self) -> dict:
        """Replays of each stage's programs, by stage."""
        return {stage: sum(p.replays for p in cache.values())
                for stage, cache in self._stages.items()}

    def items(self, stage: str) -> list:
        """(key, program) of each of a stage's programs, least recently
        used first."""
        return list(self._stages.get(stage, {}).items())

    def reserved(self) -> dict:
        """Bytes the device's caching allocator holds in each of the
        Engine's graph pools, by pool name (torch.cuda.memory_snapshot's
        segments of each pool)."""
        if not self._pools:
            return {}
        owner = {tuple(h): name for name, h in self._pools.items()}
        out = dict.fromkeys(self._pools, 0)
        for seg in torch.cuda.memory_snapshot():
            name = owner.get(tuple(seg.get("segment_pool_id", ())))
            if name is not None and seg.get("device") == self.device.index:
                out[name] += seg["total_size"]
        return out

    def clear(self) -> None:
        self._stages.clear()
        self._pools.clear()
