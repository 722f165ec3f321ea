"""Block-stream sharding across torch devices and processes
(pactpu.parallel.shard) on torch.distributed.

The reference processes blocks serially in one Python process (reference
codec/pacfile.py:475-495).  The only sequential couplings are the
1024-sample MDCT framing overlap (pacfile.py:264-282) and the bit
reservoir; everything else is independent per block.  So the multi-card
decomposition is block-stream sharding: each shard owns a contiguous run
of blocks, and the 50%-overlap framing needs exactly one half-block left
halo from its neighbour (ppermute_right).

A `Mesh` is the counterpart of pactpu's 1-D `jax.sharding.Mesh` over the
"blocks" axis.  A process owns a list of local shard devices (one a card
by default, or several on one device: `["cuda:0"] * 4`, `["cpu"] * 4`);
with a process group initialized (pactpu_torch.parallel.cluster) the
global shards are ordered rank-major, so each process holds a contiguous
block range.  The collectives (ppermute_right, all_reduce) are copies
between local shards and `torch.distributed` calls between processes:
device tensors on NCCL, host tensors on gloo (chosen by the group's
backend, never by a silent switch).

A shard's encode is the Engine's analysis and finalize (kernels K4, K2 and,
with pack_words > 0, K3); the Huffman symbol histogram reduces over the
mesh.  The float32 analysis of a block depends on the size and layout of
the batch it runs in (cuBLAS and cuFFT pick their kernels by batch size),
so each block is analysed at its own row of a batch of the Engine's
default chunking of the whole file (pactpu_torch.codec.stream.
analyze_blocks): the bytes are the Engine's, whatever the shard count.
The payload decode runs the device parse (K5, then K1 for signs and LRMS
flags) before synthesis and the overlap-add carry.

pactpu compiles each shard function once (`jax.jit(shard_map(...))`, an
`lru_cache(maxsize=8)` of them).  Here each shard device has an owner
(`owner`: an Engine of the config on that device, an LRU of 8), which
holds the device tables and the CUDA-graph programs that read them by
address, so that the two live and go together and a second call replays
what the first captured.  A shard holds any number of blocks, so no
program is captured for a shard's length: each stage runs on the shard's
pieces (the analysis batches' pieces on the encode, chunks of at most
DEFAULT_CHUNK_BLOCKS on the decode), each padded with zero rows to the
next bucket size and replayed there (programs.shard_programs; a size past
the buckets runs launch by launch).  The collectives (the halo, the
histogram's all-reduce) run between the replays, never inside one.

Rate control under sharding is the caller's (cluster.encode_distributed):
these functions take each block's extra bits.
"""

from __future__ import annotations

import dataclasses
import os
from functools import lru_cache
from typing import List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from pactpu_torch.codec import programs
from pactpu_torch.codec.engine import (
    DEFAULT_CHUNK_BLOCKS, Engine, _chunk_sizes, _offsets, _TAIL_BUCKETS,
    decode_body, finalize, payload_synthesize, resolve_device)
from pactpu_torch.codec.stream import analyze_blocks, padded_rows
from pactpu_torch.ops import bitpack
from pactpu_torch.ops import huffman_walk as hw
from pactpu_torch.utils.config import CodecConfig

BLOCK_AXIS = "blocks"
HIST_BINS = 1 << 15


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This process's shards of a 1-D block mesh.

    devices: the local shard devices in shard order; rank, world: the
    process's place in the process group (0, 1 without one); distributed:
    whether a process group carries the collectives.  Global shard
    rank * len(devices) + i is local shard i."""

    devices: tuple
    rank: int = 0
    world: int = 1
    distributed: bool = False

    @property
    def n_local(self) -> int:
        return len(self.devices)

    @property
    def size(self) -> int:
        """The global shard count."""
        return self.world * self.n_local

    def shard_index(self, i: int) -> int:
        return self.rank * self.n_local + i


def make_mesh(devices: Optional[Sequence] = None) -> Mesh:
    """The mesh of this process's shard devices (default one shard on
    cuda:{LOCAL_RANK or 0}, raising without a card).  With a process group
    initialized, every process must hold as many shards (checked with one
    all_gather) and global shards are ordered rank-major."""
    if devices is None:
        devices = [f"cuda:{int(os.environ.get('LOCAL_RANK', 0))}"]
    devs = tuple(resolve_device(d, "make_mesh") for d in devices)
    if not devs:
        raise ValueError("make_mesh needs at least one device")
    if not (dist.is_available() and dist.is_initialized()):
        return Mesh(devs)
    mesh = Mesh(devs, dist.get_rank(), dist.get_world_size(), True)
    comm = _comm_device(mesh)
    counts = [torch.zeros(1, dtype=torch.int64, device=comm)
              for _ in range(mesh.world)]
    dist.all_gather(counts, torch.tensor([len(devs)], device=comm))
    if any(int(n) != len(devs) for n in counts):
        raise ValueError("every process must hold as many shards: "
                         f"{[int(n) for n in counts]}")
    return mesh


# -- collectives -----------------------------------------------------------

def _comm_device(mesh: Mesh) -> torch.device:
    """Where tensors cross processes: the first shard's card on NCCL, the
    host on gloo."""
    backend = dist.get_backend()
    if backend == "nccl":
        if mesh.devices[0].type != "cuda":
            raise ValueError("the nccl backend carries CUDA tensors; this "
                             f"mesh's shards are on {mesh.devices[0]}")
        return mesh.devices[0]
    if backend == "gloo":
        return torch.device("cpu")
    raise ValueError(f"unsupported torch.distributed backend {backend!r}")


def ppermute_right(mesh: Mesh, xs: List[torch.Tensor]) -> List[torch.Tensor]:
    """Each shard's tensor to its right neighbour; global shard 0 receives
    zeros (the reference's leading zero priorBlock and the decoder's empty
    overlap carry).  xs: one tensor a local shard, all of one shape."""
    out = [torch.zeros_like(xs[0], device=mesh.devices[0])]
    out += [x.to(d) for x, d in zip(xs[:-1], mesh.devices[1:])]
    if mesh.world > 1:
        comm = _comm_device(mesh)
        ops, recv = [], None
        if mesh.rank + 1 < mesh.world:
            ops.append(dist.P2POp(dist.isend, xs[-1].to(comm).contiguous(),
                                  mesh.rank + 1))
        if mesh.rank > 0:
            recv = torch.empty(xs[0].shape, dtype=xs[0].dtype, device=comm)
            ops.append(dist.P2POp(dist.irecv, recv, mesh.rank - 1))
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        if recv is not None:
            out[0] = recv.to(mesh.devices[0])
    return out


def all_reduce(mesh: Mesh, xs: List[torch.Tensor], op: str = "sum"
               ) -> torch.Tensor:
    """The sum ("sum") or maximum ("max") of the local shards' tensors over
    the whole mesh, on the first local shard's device (every process gets
    the same value)."""
    if op not in ("sum", "max"):
        raise ValueError(f"unknown reduction {op!r}")
    acc = xs[0]
    for x in xs[1:]:
        x = x.to(acc.device)
        acc = acc + x if op == "sum" else torch.maximum(acc, x)
    if mesh.distributed:
        t = acc.to(_comm_device(mesh), copy=True)
        dist.all_reduce(t, dist.ReduceOp.SUM if op == "sum"
                        else dist.ReduceOp.MAX)
        acc = t.to(mesh.devices[0])
    return acc


# -- placement -------------------------------------------------------------

def shard_put(arr: np.ndarray, mesh: Mesh, axis: int = 0
              ) -> List[torch.Tensor]:
    """This process's shards of a whole host array (the same on every
    process): `axis` cut into mesh.size equal runs, local shard i's run
    uploaded to its device."""
    n = arr.shape[axis]
    if n % mesh.size:
        raise ValueError(f"axis {axis} of length {n} does not divide into "
                         f"{mesh.size} shards")
    per = n // mesh.size
    out = []
    for i, d in enumerate(mesh.devices):
        lo = mesh.shard_index(i) * per
        # a slice (a copy of whole rows), not np.take of an index array,
        # which gathers element by element
        part = arr[(slice(None),) * axis + (slice(lo, lo + per),)]
        out.append(torch.from_numpy(np.ascontiguousarray(part)).to(d))
    return out


@lru_cache(maxsize=8)
def owner(cfg: CodecConfig, precision: str, device: torch.device) -> Engine:
    """The owner of a shard device's tables and programs for cfg: an
    Engine on `device` (an indexed torch.device, as make_mesh gives),
    whose constant tables (Engine.consts) the shard stages read and whose
    Programs hold their CUDA graphs, which read those tables by address.
    Bounded as pactpu bounds its sharded_*_fn programs (the 8 most
    recently used); one that drops out takes its programs and tables with
    it.  Local shards on one device share its owner: their replays run one
    at a time on that device's stream, each cloned out."""
    return Engine(cfg, "cbr", device=device, precision=precision)


def mesh_owners(cfg: CodecConfig, mesh: Mesh) -> list:
    """Each local shard's owner (float32, as the shard functions run)."""
    return [owner(cfg, "f32", d) for d in mesh.devices]


def mesh_tables(cfg: CodecConfig, mesh: Mesh) -> list:
    """The engine's device tables (engine.device_tables) for each local
    shard: its owner's, uploaded once a distinct device and kept with the
    programs that read them."""
    return [eng.consts() for eng in mesh_owners(cfg, mesh)]


def _bucket(n: int) -> int:
    """The rows a piece of n blocks runs at: the next of the Engine's
    bucket sizes (n itself past the largest)."""
    return next((s for s in _TAIL_BUCKETS if s >= n), n)


def _run(eng: Engine, dev: dict, stage: str, n: int, key: tuple, fn,
         args):
    """fn(*args), a shard stage on a piece of n blocks: a replay of the
    owner's program where shard_programs says so and fn reads the owner's
    own tables (a program reads the tables it was captured with: tables
    of another make run launch by launch)."""
    programmed = (programs.shard_programs(eng)[stage]
                  and dev is eng.consts())
    return eng._run_stage(stage, programmed, n, key, fn, args)


def _joined(parts: list, rows: list, c: int) -> dict:
    """Per-piece output dicts (each padded to its bucket) joined over a
    shard's real rows: rows[j] blocks of piece j, the row-major payload
    fields (words, nbits: a row a channel-block) c rows a block."""
    def real(k, v, n):
        return v[:n * c] if k in ("words", "nbits") else v[:n]
    out = {}
    for k in parts[0]:
        vs = [real(k, p[k], n) for p, n in zip(parts, rows)]
        out[k] = vs[0] if len(vs) == 1 else torch.cat(vs)
    return out


# -- encode ----------------------------------------------------------------

def _shard_analyses(cfg: CodecConfig, mesh: Mesh, x_local, engs: list,
                    n_blocks_total: Optional[int]) -> list:
    """Each local shard's analysis pieces: the left halo (ppermute_right),
    then analyze_blocks through the shard's owner at the Engine's batch
    rows of a file of n_blocks_total blocks (None: the mesh's).  Returns
    per shard the list of its pieces' analysis dicts, in block order."""
    half = cfg.n_mdct_lines
    b_local = x_local[0].shape[1] // half
    total = n_blocks_total or mesh.size * b_local
    halos = ppermute_right(mesh, [x[:, -half:] for x in x_local])
    return [analyze_blocks(cfg, torch.cat([h, x], dim=1),
                           mesh.shard_index(i) * b_local, total, eng)
            for i, (h, x, eng) in enumerate(zip(halos, x_local, engs))]


def _pieces(parts: list):
    """(analysis padded to its bucket, real blocks, bucket, first block in
    the shard) of each analysis piece of a shard."""
    lo = 0
    for a in parts:
        n = a["smr"].shape[0]
        size = _bucket(n)
        yield padded_rows(a, size), n, size, lo
        lo += n


def _final_pieces(cfg: CodecConfig, eng: Engine, dev: dict, parts: list,
                 extras: torch.Tensor, pack_words: int):
    """The final pass of one shard's (or range's) analysis pieces: each
    piece's finalize (with the pack when pack_words > 0) and the histogram
    of its real rows' transmitted symbols (a valid prefix), one stage
    ("shard_final") replayed at the piece's bucket size.  extras: f32[B]
    of the pieces' blocks.  Returns (the finalize dict of the B blocks,
    the int32 [HIST_BINS] histogram)."""
    def stage(mixed, smr, lrms, overall, ex, valid):
        out = finalize(cfg, dict(mixed=mixed, smr=smr, lrms=lrms,
                                 overall=overall), ex, dev,
                       pack_words=pack_words, return_syms=True)
        syms = out.pop("syms")
        ok = (syms >= 0) & valid[:, None, None]
        out["hist"] = torch.zeros(
            HIST_BINS, dtype=torch.int32, device=syms.device
        ).index_add_(0, torch.where(ok, syms, 0).reshape(-1),
                     ok.to(torch.int32).reshape(-1))
        return out

    done, rows = [], []
    for a, n, size, lo in _pieces(parts):
        ex = padded_rows(dict(e=extras[lo:lo + n]), size)["e"]
        valid = torch.arange(size, device=ex.device) < n
        done.append(_run(eng, dev, "shard_final", size, (cfg, pack_words),
                         stage, (a["mixed"], a["smr"], a["lrms"],
                                 a["overall"], ex, valid)))
        rows.append(n)
    hists = [p.pop("hist") for p in done]
    hist = (hists[0] if len(hists) == 1
            else torch.stack(hists).sum(0, dtype=torch.int32))
    return _joined(done, rows, cfg.n_channels), hist


def _measure_pieces(cfg: CodecConfig, eng: Engine, dev: dict,
                   parts: list) -> dict:
    """The reservoir measurement pass of one shard's (or range's) analysis
    pieces with no extra bits, one stage ("shard_measure") a piece; no
    K11: the cluster replays the reservoir on the host, as pactpu's does.
    Returns dict(savings i32[B, C], leftover i32[B])."""
    def stage(mixed, smr, lrms, overall):
        m = finalize(cfg, dict(mixed=mixed, smr=smr, lrms=lrms,
                               overall=overall),
                     torch.zeros(mixed.shape[0], device=mixed.device),
                     dev, measure_only=True)
        return dict(savings=m["savings"], leftover=m["leftover"])

    done, rows = [], []
    for a, n, size, _ in _pieces(parts):
        done.append(_run(eng, dev, "shard_measure", size, (cfg,), stage,
                         tuple(a[k] for k in ("mixed", "smr", "lrms",
                                              "overall"))))
        rows.append(n)
    return _joined(done, rows, cfg.n_channels)


def sharded_encode(cfg: CodecConfig, mesh: Mesh, x_local, extras_local,
                   pack_words: int = 0, dense_cap: int = 0,
                   consts: Optional[list] = None,
                   n_blocks_total: Optional[int] = None):
    """The encode of every local shard (pactpu sharded_encode_fn).

    x_local: each local shard's int16 PCM [C, B_local * half] (shard_put of
    the block-aligned file, zero-padded to a whole number of blocks a
    shard); extras_local: each shard's f32[B_local] reservoir extra bits of
    channel 0; consts: mesh_tables (None: the owners'; tables of another
    make run launch by launch); n_blocks_total: the file's block count,
    whose default chunking places each block's analysis (None: the
    mesh's).  Returns (outs, hist): each shard's finalize dict (with
    pack_words > 0 the packed `words` i32[C B_local, pack_words] and
    `nbits`; else sign, codes and lens), and the int32 [1 << 15] histogram
    of the transmitted unsigned mantissa symbols over the whole mesh.
    dense_cap > 0 also compacts each shard's rows into `dense`
    i32[dense_cap] (bitpack.compact_rows) and drops `words`: the caller
    checks each shard's word total against the cap (from `nbits`) and
    encodes again without it where one overflows.  Each analysis piece's
    final pass is one program (_final_pieces); the shard's compaction
    joins its pieces."""
    engs = mesh_owners(cfg, mesh)
    consts = consts or [e.consts() for e in engs]
    outs, counts = [], []
    for parts, ex, dev, eng in zip(
            _shard_analyses(cfg, mesh, x_local, engs, n_blocks_total),
            extras_local, consts, engs):
        out, hist = _final_pieces(cfg, eng, dev, parts, ex, pack_words)
        counts.append(hist)
        if dense_cap > 0:
            out["dense"] = bitpack.compact_rows(
                out.pop("words"), out["nbits"], dense_cap)[:dense_cap]
        outs.append(out)
    return outs, all_reduce(mesh, counts, "sum")


def sharded_measure(cfg: CodecConfig, mesh: Mesh, x_local,
                    consts: Optional[list] = None,
                    n_blocks_total: Optional[int] = None) -> list:
    """The reservoir measurement pass of every local shard (pactpu
    sharded_measure_fn): the same analysis with no extra bits, each
    shard's dict(savings i32[B_local, C], leftover i32[B_local])
    (_measure_pieces)."""
    engs = mesh_owners(cfg, mesh)
    consts = consts or [e.consts() for e in engs]
    return [_measure_pieces(cfg, eng, dev, parts)
            for parts, dev, eng in zip(
                _shard_analyses(cfg, mesh, x_local, engs, n_blocks_total),
                consts, engs)]


# -- decode ----------------------------------------------------------------

def _overlap_add_halo(mesh: Mesh, tds: list) -> list:
    """Overlap-add of each shard's pre-overlap blocks f32[B_local, C, 2N]
    with the right-halo carry: the left neighbour's last second half
    (zeros for global shard 0).  Output block t = second half of frame
    t - 1 + first half of frame t."""
    half = tds[0].shape[-1] // 2
    carries = ppermute_right(mesh, [td[-1, :, half:] for td in tds])
    return [torch.cat([cy[None], td[:-1, :, half:]]) + td[:, :, :half]
            for cy, td in zip(carries, tds)]


def _decode_chunks(eng: Engine, dev: dict, stage: str, key: tuple, fn,
                   arrays: tuple) -> list:
    """fn's outputs over a shard's blocks in chunks of the Engine's sizes
    (at most DEFAULT_CHUNK_BLOCKS, the last padded with zero blocks to the
    next bucket), each a replay of the owner's program for `stage`:
    arrays are the shard's per-block tensors [B_local, ...].  Returns
    [(output, real blocks)] of each chunk."""
    b = arrays[0].shape[0]
    sizes = _chunk_sizes(b, DEFAULT_CHUNK_BLOCKS)
    out = []
    for lo, size in zip(_offsets(sizes), sizes):
        n = min(size, b - lo)
        args = padded_rows(dict(enumerate(a[lo:lo + n] for a in arrays)),
                           size)
        out.append((_run(eng, dev, stage, size, key, fn,
                         tuple(args[k] for k in range(len(arrays)))), n))
    return out


def sharded_decode(cfg: CodecConfig, mesh: Mesh, ba, sf, mant, overall,
                   lrms, consts: Optional[list] = None) -> list:
    """Synthesis and overlap-add of every local shard from dense quantized
    arrays (pactpu sharded_decode_fn): ba/sf i32[B_local, C, bands], mant
    i32[B_local, C, N], overall i32[B_local, C], lrms bool[B_local, bands],
    one tensor a local shard.  Returns each shard's f32[B_local, C, N]
    output blocks (block t the overlap-add of frames t - 1 and t).  The
    synthesis runs in chunks, each one stage ("shard_synthesize")."""
    engs = mesh_owners(cfg, mesh)
    consts = consts or [e.consts() for e in engs]
    tds = []
    for *arrays, dev, eng in zip(ba, sf, mant, overall, lrms, consts, engs):
        def stage(*args, dev=dev):
            return decode_body(cfg, *args, dev)
        done = _decode_chunks(eng, dev, "shard_synthesize", (cfg,), stage,
                              tuple(arrays))
        tds.append(torch.cat([td[:n] for td, n in done]))
    return _overlap_add_halo(mesh, tds)


def sharded_decode_payload(cfg: CodecConfig, mesh: Mesh, words, nbits,
                           consts: Optional[list] = None):
    """Decode of every local shard from the raw .wak payload (pactpu
    sharded_decode_payload_fn): words i32[B_local, C, W] (u32 bit
    patterns, MSB-first rows) and nbits i32[B_local, C], one a local
    shard.  The parse is the Huffman bit-walk through the shipped tables'
    LUT (kernel K5, then K1 for signs and LRMS flags), then synthesis and
    the overlap-add carry (engine.payload_synthesize).  Returns (each
    shard's f32[B_local, C, N] output blocks, each shard's corruption
    flags bool[B_local, C]).  The parse and synthesis run in chunks, each
    one stage ("shard_decode"; a padding block has nbits 0 and is never
    flagged)."""
    engs = mesh_owners(cfg, mesh)
    consts = consts or [e.consts() for e in engs]
    tds, bads = [], []
    for w, nb, dev, eng, d in zip(words, nbits, consts, engs, mesh.devices):
        lut = hw.device_walk_lut(device=d)
        c = w.shape[1]

        def stage(w_k, nb_k, dev=dev, lut=lut):
            return payload_synthesize(
                cfg, w_k.reshape(-1, w_k.shape[-1]).contiguous(),
                nb_k.reshape(-1), dev, lut)

        done = _decode_chunks(eng, dev, "shard_decode", (cfg,), stage,
                              (w, nb))
        tds.append(torch.cat([td[:n] for (td, _), n in done]))
        bads.append(torch.cat([bad[:n * c] for (_, bad), n in done])
                    .reshape(-1, c))
    return _overlap_add_halo(mesh, tds), bads
