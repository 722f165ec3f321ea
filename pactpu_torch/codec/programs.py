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
- Capture: the stage runs once on a side stream (the warm-up fills the
  caches that would break a capture, such as the pack plan and the walk
  LUT, and its launches are real and counted), then once under capture,
  into the one memory pool of the Engine's graphs.  The first call returns
  the warm-up's outputs.  A capture that fails raises CaptureError naming
  the stage: nothing runs eagerly in its place.
- Replay: the call's tensors are copied into the graph's static inputs
  (host arrays are uploaded into them), the graph is replayed, and the
  outputs are returned as clones: a later replay of the same graph, or of
  another graph of the pool, overwrites its static outputs, and a chunk's
  analysis, measurement and words live past the next chunk's replay.
  Replays run one at a time on the caller's stream, each cloned out
  before the next, so the Engine's graphs can share one pool.
- Launches: `kernels.LAUNCHES` counts wrapper calls, and a replay calls
  none.  The capturing thread's launches are counted apart
  (kernels.captured_launches: a capture launches nothing, and other
  threads go on counting theirs); a program adds them on each replay, so
  a programmed run counts what the same run launch by launch counts.

Whether an Engine's stages run as programs is decided from its
configuration alone, before any capture (encode_programs,
decode_programs): on the CPU, or with `Engine.use_programs` False, the
stage functions run directly, launch by launch; on the card the
configurations listed there stay launch by launch, the rest are programs.
"""

from __future__ import annotations

import collections
import threading
import time
from functools import lru_cache

import torch
from torch.utils._pytree import tree_flatten, tree_unflatten

from pactpu_torch.ops import kernels

# programs a stage keeps per Engine, least recently used dropped first
MAX_PROGRAMS = 16

# one capture at a time in the process (a capture synchronizes the device
# and empties the allocator's cache first: DeviceFleet runs an Engine a
# thread)
_capture_lock = threading.Lock()


class CaptureError(RuntimeError):
    """A stage that could not be captured into a CUDA graph (a host sync,
    a pageable copy, a cache filled inside the stage)."""


def encode_programs(eng) -> bool:
    """Whether an Engine's encode stages run as programs: on the card,
    with eng.use_programs, but for the configurations that stay launch by
    launch: the .pac coder, the exact rate mode (K10 on a second stream
    beside K7), device_pack=False, the allocators other than water-filling
    (their host budgets), and debug_checks (host checks of every pass)."""
    return (eng.device.type == "cuda" and eng.use_programs
            and eng.fmt == "wak" and eng.rate_mode != "exact"
            and eng.device_pack and not eng.debug_checks
            and eng.cfg.alloc_mode == "water_fill")


def decode_programs(eng) -> bool:
    """Whether an Engine's decode chunks run as programs: on the card,
    with eng.use_programs, for .wak on either parse route (.pac's device
    parse syncs)."""
    return (eng.device.type == "cuda" and eng.use_programs
            and eng.fmt == "wak")


@lru_cache(maxsize=8)
def _side_stream(device: torch.device) -> torch.cuda.Stream:
    """The stream the warm-ups run on (one a device)."""
    return torch.cuda.Stream(device)


class Program:
    """One stage function captured into a CUDA graph at the shapes of its
    first call.  Program.build(...) returns (program, the warm-up's
    outputs); program(*args) replays it on args."""

    def __init__(self, stage: str, graph, static_in: list, out,
                 launches: dict):
        self.stage = stage
        self.graph = graph
        self.static_in = static_in
        self.static_out, self.spec = tree_flatten(out)
        self.launches = launches
        self.replays = 0

    @classmethod
    def build(cls, stage: str, fn, args, device: torch.device, pool=None):
        """Warm fn up on static copies of args on a side stream, then
        capture it (into the memory pool `pool`, None = a pool of its
        own)."""
        static_in = [torch.empty(a.shape, dtype=a.dtype, device=device)
                     for a in args]
        for s, a in zip(static_in, args):
            s.copy_(a)
        main = torch.cuda.current_stream(device)
        side = _side_stream(device)
        side.wait_stream(main)
        with torch.cuda.stream(side):
            warm = fn(*static_in)
        main.wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        try:
            with kernels.captured_launches() as launches, torch.cuda.graph(
                    graph, pool=pool, capture_error_mode="thread_local"):
                out = fn(*static_in)
        except Exception as e:
            raise CaptureError(f"program {stage!r}: the stage could not be "
                               f"captured into a CUDA graph ({e})") from e
        return cls(stage, graph, static_in, out, dict(launches)), warm

    def replay(self) -> None:
        """Run the captured stage on the static inputs into the static
        outputs."""
        self.graph.replay()

    def __call__(self, *args):
        for s, a in zip(self.static_in, args):
            s.copy_(a)
        self.replay()
        self.replays += 1
        for k, n in self.launches.items():
            kernels.LAUNCHES[k] += n
        return tree_unflatten([t.clone() if torch.is_tensor(t) else t
                               for t in self.static_out], self.spec)


class Programs:
    """The programs of one Engine: per stage an LRU cache of at most
    MAX_PROGRAMS programs by key, all captured into one memory pool.
    capture_s sums the host seconds spent building them (warm-up and
    capture), captures counts them."""

    def __init__(self, device):
        self.device = torch.device(device)
        self._stages = {}
        self._pool = None
        self.capture_s = 0.0
        self.captures = 0

    @staticmethod
    def key(key: tuple, args) -> tuple:
        """A program's full key: the caller's and its inputs' shapes and
        types."""
        return (key, tuple((tuple(a.shape), a.dtype) for a in args))

    def run(self, stage: str, key: tuple, fn, args):
        """fn(*args) through the stage's program for key (built at the
        first call).  fn must depend on nothing but its tensor arguments
        and what key names."""
        cache = self._stages.setdefault(stage, collections.OrderedDict())
        full = self.key(key, args)
        prog = cache.get(full)
        if prog is not None:
            cache.move_to_end(full)
            return prog(*args)
        if self._pool is None and self.device.type == "cuda":
            self._pool = torch.cuda.graph_pool_handle()
        with _capture_lock:
            t0 = time.perf_counter()
            try:
                prog, warm = Program.build(stage, fn, args, self.device,
                                           self._pool)
            except CaptureError:
                self._pool = None      # the next capture takes a new pool
                raise
            self.capture_s += time.perf_counter() - t0
        self.captures += 1
        cache[full] = prog
        if len(cache) > MAX_PROGRAMS:
            cache.popitem(last=False)
        return warm

    def items(self, stage: str) -> list:
        """(key, program) of each of a stage's programs, least recently
        used first."""
        return list(self._stages.get(stage, {}).items())

    def clear(self) -> None:
        self._stages.clear()
        self._pool = None
