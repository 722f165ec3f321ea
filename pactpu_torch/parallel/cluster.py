"""Multi-process distribution on torch.distributed (pactpu.parallel.cluster).

The reference is one Python process iterating blocks serially (reference
codec/pacfile.py:475-495).  Here every process calls `initialize()` (a
`torch.distributed.init_process_group` wrapper) and builds a mesh
(pactpu_torch.parallel.shard.make_mesh); the shards of all processes then
encode a file's block-stream together: the half-block framing halo
crosses process boundaries as a point-to-point send and the Huffman
histogram reduces over the whole mesh.

Host-side responsibilities stay local: each process downloads only its own
block range and frames only that range's payload bytes (`ShardResult`);
the caller concatenates ranges in block order (`assemble_stream`), so
bitstream bytes never cross processes through torch.distributed.

Rate control under distribution: "cbr" gives the same bytes for any
layout, and those of `Engine(rate_mode="cbr")`.  "reservoir" runs the
Engine's two-pass policy per process over its own contiguous block range,
from a zero carry at the range's start: one process gives the Engine's
bytes, several the per-range relaxation of the reference's file-serial
reservoir (which would serialize the cluster).  rate_mode="exact" is
serial by nature and offered only by the single-process Engine.

Every decision that re-runs a program with collectives in it (the packer
overflow, the dense-download cap) or raises (a corrupt payload) is taken
from a reduction over the whole mesh, so every process takes it alike: a
process-local decision would leave the others waiting at their next
collective.
"""

from __future__ import annotations

import dataclasses
import os
from typing import List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from pactpu_torch import native
from pactpu_torch.codec import engine as E
from pactpu_torch.codec.engine import reservoir_extras
from pactpu_torch.codec.header import read_header, write_header
from pactpu_torch.codec.stream import analyze_blocks
from pactpu_torch.ops import huffman_decode as hd
from pactpu_torch.ops import huffman_walk as hw
from pactpu_torch.ops import quantize as q
from pactpu_torch.parallel import shard
from pactpu_torch.utils.config import CodecConfig

# whether initialize() started the process group (shutdown() ends only that)
_initialized = False


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               local_device_ids=None, backend: Optional[str] = None) -> bool:
    """Join (or start) the process group.

    Arguments default to the PACTPU_COORDINATOR ("host:port") /
    PACTPU_NUM_PROCESSES / PACTPU_PROCESS_ID environment variables, and
    past those to torchrun's (MASTER_ADDR, MASTER_PORT, WORLD_SIZE, RANK:
    the env:// method).  backend: "nccl" (the default: the card) or "gloo"
    (host tensors; CPU shards, or several processes sharing one card).
    local_device_ids: the CUDA devices of this process; under NCCL the
    first (default LOCAL_RANK or 0) becomes the current device.  Returns
    True when a group of more than one process was joined, False for a
    single process: with nothing configured no group is started, and
    every other function here works the same without one."""
    global _initialized
    if dist.is_initialized():
        return dist.get_world_size() > 1
    coordinator_address = coordinator_address or os.environ.get(
        "PACTPU_COORDINATOR")
    if num_processes is None and "PACTPU_NUM_PROCESSES" in os.environ:
        num_processes = int(os.environ["PACTPU_NUM_PROCESSES"])
    if process_id is None and "PACTPU_PROCESS_ID" in os.environ:
        process_id = int(os.environ["PACTPU_PROCESS_ID"])
    if coordinator_address is None and num_processes is None:
        if not all(k in os.environ for k in ("MASTER_ADDR", "MASTER_PORT",
                                             "WORLD_SIZE", "RANK")):
            return False
        init_method = "env://"
        num_processes = int(os.environ["WORLD_SIZE"])
        process_id = int(os.environ["RANK"])
    else:
        if coordinator_address is None or num_processes is None:
            raise ValueError("a process group needs both the coordinator "
                             "address and the number of processes")
        if process_id is None:
            if num_processes != 1:
                raise ValueError("process_id is required for more than one "
                                 "process")
            process_id = 0
        init_method = (coordinator_address if "://" in coordinator_address
                       else f"tcp://{coordinator_address}")
    backend = backend or "nccl"
    if backend == "nccl":
        if not torch.cuda.is_available():
            raise RuntimeError("initialize(backend='nccl'): no CUDA device")
        ids = local_device_ids or [int(os.environ.get("LOCAL_RANK", 0))]
        torch.cuda.set_device(int(ids[0]))
    dist.init_process_group(backend, init_method=init_method,
                            world_size=int(num_processes),
                            rank=int(process_id))
    _initialized = True
    return dist.get_world_size() > 1


def shutdown() -> None:
    """End the process group that initialize() started."""
    global _initialized
    if _initialized:
        dist.destroy_process_group()
        _initialized = False


@dataclasses.dataclass
class ShardResult:
    """One process's share of a distributed encode."""

    header: bytes          # stream header (identical on every process)
    payload: bytes         # payload bytes of this process's block range
    block_start: int       # first global block index of the range
    n_blocks: int          # real coded blocks in `payload`
    n_blocks_total: int    # real coded blocks in the whole stream
    histogram: np.ndarray  # Huffman symbol histogram over the whole mesh
    savings: int           # Huffman bits saved in this range


def assemble_stream(header: bytes,
                    parts: List[Tuple[int, bytes]]) -> bytes:
    """Concatenate per-range payloads (block_start, payload) in block
    order into the final stream."""
    return header + b"".join(p for _, p in sorted(parts))


def _global_masked_max(mesh: shard.Mesh, xs: list, n_real: int) -> int:
    """max(x[:n_real]) of a block-sharded 1-D array (each local shard's
    run in xs), the same on every process: the cross-process decisions
    (the packer-overflow re-run) are taken from it, so every process
    re-runs the programs with collectives in them, or none does."""
    vals = []
    for i, x in enumerate(xs):
        idx = (torch.arange(x.shape[0], device=x.device)
               + mesh.shard_index(i) * x.shape[0])
        vals.append(torch.where(idx < n_real, x, 0).max().reshape(1))
    return int(shard.all_reduce(mesh, vals, "max")[0])


def _global_masked_any(mesh: shard.Mesh, xs: list, n_real: int) -> bool:
    """any(x.reshape(-1)[:n_real]) of a block-sharded bool array, the same
    on every process, so that every process raises (or goes on) alike."""
    return _global_masked_max(
        mesh, [x.reshape(-1).to(torch.int32) for x in xs], n_real) > 0


def _global_dense_overflow(mesh: shard.Mesh, nbits: list, width: int,
                           cap: int) -> bool:
    """Whether any shard's packed words (each row's ceil(nbits / 32),
    at most `width`; pad rows too: they take dense slots) exceed its dense
    cap, the same on every process, so every process takes the same
    fallback."""
    over = [(torch.clamp((nb.long() + 31) // 32, max=width).sum() > cap)
            .to(torch.int32).reshape(1) for nb in nbits]
    return int(shard.all_reduce(mesh, over, "max")[0]) > 0


def _local_blocks(mesh: shard.Mesh, xs: list) -> Tuple[np.ndarray, int]:
    """This process's shards of a block-sharded array as one host array,
    and the global index of its first block (ranges are contiguous a
    process: shards are ordered rank-major)."""
    data = np.concatenate([x.cpu().numpy() for x in xs])
    return data, mesh.shard_index(0) * xs[0].shape[0]


def encode_distributed(pcm: np.ndarray, cfg: Optional[CodecConfig] = None,
                       mesh: Optional[shard.Mesh] = None,
                       rate_mode: str = "reservoir") -> ShardResult:
    """Encode a file's block-stream over the mesh of every process.

    pcm: int16 [n, C], identical on every process (each process reads the
    input; only device work and the final per-range payloads are
    distributed).  Returns this process's `ShardResult`."""
    if rate_mode not in ("cbr", "reservoir"):
        raise ValueError(f"unknown distributed rate mode {rate_mode!r}")
    cfg = cfg or CodecConfig()
    E._check_config(cfg, rate_mode)
    mesh = mesh or shard.make_mesh()
    half, c = cfg.n_mdct_lines, cfg.n_channels
    if pcm.ndim != 2 or pcm.shape[1] != c:
        raise ValueError(f"pcm must be [n, {c}] int16, got {pcm.shape}")
    n_dev = mesh.size
    b = -(-pcm.shape[0] // half) + 1                   # + flush block
    b_pad = -(-b // n_dev) * n_dev
    blocks_per_dev = b_pad // n_dev
    my_lo = mesh.shard_index(0) * blocks_per_dev
    my_hi = my_lo + mesh.n_local * blocks_per_dev
    real = int(np.clip(b - my_lo, 0, my_hi - my_lo))

    # block k's frame is samples [(k - 1) * half, (k + 1) * half) of the
    # file, zeros before it; each shard holds its blocks' second halves
    # and the halo brings the first half of its first frame
    glob = np.zeros((c, b_pad * half), np.int16)
    n = min(pcm.shape[0], b_pad * half)
    glob[:, :n] = pcm[:n].T
    x = shard.shard_put(glob, mesh, axis=1)
    consts = shard.mesh_tables(cfg, mesh)
    run = dict(consts=consts, n_blocks_total=b)

    extras_local = np.zeros(my_hi - my_lo, np.float32)
    if rate_mode == "reservoir":
        meas = shard.sharded_measure(cfg, mesh, x, **run)
        savings, _ = _local_blocks(mesh, [m["savings"] for m in meas])
        leftover, _ = _local_blocks(mesh, [m["leftover"] for m in meas])
        # the reservoir replayed over this process's own real blocks, from
        # a zero carry at the range's start
        if real > 0:
            extras_local[:real] = reservoir_extras(
                savings[:real], leftover[:real],
                cfg.reservoir_withdraw_divisor)[0]
    extras = [torch.from_numpy(e).to(d) for e, d in zip(
        np.split(extras_local, mesh.n_local), mesh.devices)]

    # each shard's download is a flat dense word buffer and nbits, the
    # compressed bytes themselves; rows past the narrow packer re-run the
    # widest, and a shard whose words exceed its dense cap re-runs the
    # padded rows (the Engine's fallbacks), each decided over the mesh
    rows_per_dev = c * blocks_per_dev
    pack_words, dense = E.pack_widths(cfg)
    dense_cap = rows_per_dev * dense
    out, hist = shard.sharded_encode(cfg, mesh, x, extras, pack_words,
                                     dense_cap, **run)
    if _global_masked_max(mesh, [o["nbits"] for o in out], c * b) \
            > 32 * pack_words:
        pack_words = E.PACK_WORDS_MAX
        out, hist = shard.sharded_encode(cfg, mesh, x, extras, pack_words,
                                         dense_cap, **run)
    dense_ok = not _global_dense_overflow(
        mesh, [o["nbits"] for o in out], pack_words, dense_cap)
    if not dense_ok:
        out, hist = shard.sharded_encode(cfg, mesh, x, extras, pack_words,
                                         **run)

    payload = b""
    savings_total = 0
    if real > 0:
        nbits, _ = _local_blocks(mesh, [o["nbits"] for o in out])
        nbits = nbits[:c * real]
        if dense_ok:
            # the process's real rows lead its shards
            payload = b"".join(
                E.assemble_flat(o["dense"], nbits[k:k + rows_per_dev],
                                pack_words)
                for o, k in zip(out, range(0, len(nbits), rows_per_dev)))
        else:
            words, _ = _local_blocks(mesh, [o["words"] for o in out])
            payload = native.assemble_rows(words[:c * real].view(np.uint32),
                                           nbits)
        savings, _ = _local_blocks(mesh, [o["savings"] for o in out])
        savings_total = int(savings[:real].sum())

    header, _ = write_header(cfg, pcm.shape[0])
    return ShardResult(header=header, payload=payload, block_start=my_lo,
                       n_blocks=real, n_blocks_total=b,
                       histogram=hist.cpu().numpy(), savings=savings_total)


def process_block_ranges(n_samples: int, n_dev: int, n_proc: int,
                         cfg: Optional[CodecConfig] = None
                         ) -> List[Tuple[int, int]]:
    """The (block_start, n_real_blocks) range each process of an
    encode_distributed run owns, from the partition arithmetic alone, so
    that a coordinator can tell which ranges a lost process leaves missing
    without hearing from it."""
    cfg = cfg or CodecConfig()
    half = cfg.n_mdct_lines
    b = -(-n_samples // half) + 1
    b_pad = -(-b // n_dev) * n_dev
    bpd = b_pad // n_dev
    dpp = n_dev // n_proc
    out = []
    for p in range(n_proc):
        lo = p * dpp * bpd
        out.append((lo, int(np.clip(b - lo, 0, dpp * bpd))))
    return out


def encode_range(pcm: np.ndarray, block_start: int, n_real: int,
                 cfg: Optional[CodecConfig] = None,
                 rate_mode: str = "reservoir", *,
                 device="cuda") -> bytes:
    """Re-encode ONE process's block range of a distributed encode, byte
    for byte the ShardResult.payload that process would have produced: the
    shard-level redo of a lost process's work.

    Works on one device with no mesh: a range's bytes depend on nothing
    outside blocks [block_start - 1, block_start + n_real) of the input
    (the one-block halo of the 50%-overlap framing, reference
    codec/pacfile.py:264-282, and the per-range reservoir), and its blocks
    are analysed at the rows of the Engine's batches of the whole file, as
    the distributed encode analyses them.  The per-block nBytes prefixes
    make the splice into the stream exact (reference
    codec/pacfile.py:153-229).  device as Engine's."""
    if n_real <= 0:
        return b""
    if rate_mode not in ("cbr", "reservoir"):
        raise ValueError(f"unknown distributed rate mode {rate_mode!r}")
    cfg = cfg or CodecConfig()
    E._check_config(cfg, rate_mode)
    dev_t = E.resolve_device(device, "encode_range")
    half, c = cfg.n_mdct_lines, cfg.n_channels
    lo = block_start
    glob = np.zeros((c, (lo + n_real) * half), np.int16)
    m = min(pcm.shape[0], glob.shape[1])
    glob[:, :m] = pcm[:m].T
    lead = (np.zeros((c, half), np.int16) if lo == 0
            else glob[:, (lo - 1) * half:lo * half])
    y = np.concatenate([lead, glob[:, lo * half:]], axis=1)
    eng = shard.owner(cfg, "f32", dev_t)
    dev = eng.consts()
    parts = analyze_blocks(cfg, torch.from_numpy(y).to(dev_t), lo,
                           -(-pcm.shape[0] // half) + 1, eng)

    extras = torch.zeros(n_real, device=dev_t)
    if rate_mode == "reservoir":
        meas = shard._measure_pieces(cfg, eng, dev, parts)
        ex, _ = reservoir_extras(meas["savings"].cpu().numpy(),
                                 meas["leftover"].cpu().numpy(),
                                 cfg.reservoir_withdraw_divisor)
        extras = torch.from_numpy(ex.astype(np.float32)).to(dev_t)

    pack_words = E.pack_widths(cfg)[0]
    out, _ = shard._final_pieces(cfg, eng, dev, parts, extras, pack_words)
    nbits = out["nbits"].cpu().numpy()
    if int(nbits.max(initial=0)) > 32 * pack_words:
        out, _ = shard._final_pieces(cfg, eng, dev, parts, extras,
                                    E.PACK_WORDS_MAX)
        nbits = out["nbits"].cpu().numpy()
    return native.assemble_rows(E._host_u32(out["words"]), nbits)


def recover_stream(header: bytes, parts: List[Tuple[int, bytes]],
                   pcm: np.ndarray, n_dev: int, n_proc: int,
                   cfg: Optional[CodecConfig] = None,
                   rate_mode: str = "reservoir", *,
                   device="cuda") -> bytes:
    """Assemble a distributed encode's stream, re-encoding any process
    range whose part is missing (a lost process).  `parts` are the
    surviving (block_start, payload) pairs; the redo of each missing range
    is byte for byte the lost process's output (encode_range), so the
    result equals the no-fault stream."""
    cfg = cfg or CodecConfig()
    have = {start for start, _ in parts}
    full = list(parts)
    for lo, n_real in process_block_ranges(pcm.shape[0], n_dev, n_proc,
                                           cfg):
        if lo not in have and n_real > 0:
            full.append((lo, encode_range(pcm, lo, n_real, cfg, rate_mode,
                                          device=device)))
    return assemble_stream(header, full)


@dataclasses.dataclass
class DecodeShardResult:
    """One process's share of a distributed decode."""

    sample_rate: int
    pcm: np.ndarray        # int16 [n_local, C] samples of this range
    sample_start: int      # first global sample index of the range
    num_samples: int       # total samples in the whole decoded stream


def assemble_pcm(parts: List[Tuple[int, np.ndarray]],
                 num_samples: int) -> np.ndarray:
    """Concatenate per-range PCM (sample_start, pcm) in sample order and
    trim to the stream's declared length."""
    return np.concatenate(
        [p for _, p in sorted(parts, key=lambda t: t[0])])[:num_samples]


def _shard_blocks(a: np.ndarray, b: int, c: int, b_pad: int) -> np.ndarray:
    """Per-channel-block rows [b * c, ...] -> [b_pad, c, ...], zero-padded
    past the b real blocks."""
    a = a.reshape(b, c, *a.shape[1:])
    return np.pad(a, [(0, b_pad - b)] + [(0, 0)] * (a.ndim - 1))


def _pcm_range(mesh: shard.Mesh, outs: list, b: int, half: int, c: int,
               num_samples: int) -> Tuple[np.ndarray, int]:
    """This process's int16 PCM [n, C] and first sample from its shards'
    output blocks.  Output block t is the overlap-add of frames t - 1 and
    t; the reference drops block 0 (the MDCT delay) and the flush half
    arrives as block b, so this range owns output blocks
    [max(lo, 1), min(hi, b + 1)), laid out on each shard's device."""
    lo = mesh.shard_index(0) * outs[0].shape[0]
    t0 = max(lo, 1)
    rows = E.interleaved_rows([q.float_to_pcm16(o) for o in outs], t0 - lo,
                              b + 1 - lo)
    if not rows:
        return np.zeros((0, c), np.int16), num_samples
    pcm = np.concatenate([E._download(r.contiguous()) for r in rows]).reshape(-1, c)
    start = (t0 - 1) * half
    return pcm[:max(0, num_samples - start)], start


def decode_distributed(data: bytes, mesh: Optional[shard.Mesh] = None
                       ) -> DecodeShardResult:
    """Decode a stream's block payloads over the mesh of every process.

    data: the whole .wak stream, identical on every process.  Each process
    frames the payload into word rows (the nBytes prefixes make it seekable
    without a bit-walk, reference codec/pacfile.py:170-183), uploads only
    its own range's raw rows, and its shards parse them on the device
    (kernel K5, then K1) before the synthesis and the overlap-add carry
    (shard.sharded_decode_payload).  A stream the device parse does not
    take (rows past its widest bucket, a table set outside the walk LUT,
    more than 5 mantissa-size bits) goes by the host parse
    (_decode_distributed_dense).  Returns this process's contiguous PCM
    range; assemble_pcm of every process's range is Engine.decode's output
    within 1 LSB (synthesis batches round differently)."""
    cfg, num_samples, off = read_header(data)
    E._check_config(cfg)
    mesh = mesh or shard.make_mesh()
    c, half = cfg.n_channels, cfg.n_mdct_lines
    words_all, nbits_all = hd.frame_rows(
        data[off:], word_cap=E._PAYLOAD_WORD_BUCKETS[-1])
    if (words_all is None or cfg.n_mant_size_bits > 5
            or any(hw.device_walk_lut(device=d) is None
                   for d in mesh.devices)):
        return _decode_distributed_dense(data, off, cfg, mesh)
    rows = words_all.shape[0]
    if rows % c:
        raise ValueError(f"corrupt payload: {rows} channel-blocks for "
                         f"{c} channels")
    b = rows // c
    # pad past b so the block after the last real one carries the final
    # overlap-add flush half (reference codec/pacfile.py:171-178)
    b_pad = -(-(b + 1) // mesh.size) * mesh.size
    consts = shard.mesh_tables(cfg, mesh)
    words = shard.shard_put(_shard_blocks(words_all.view(np.int32), b, c,
                                          b_pad), mesh)
    nbits = shard.shard_put(_shard_blocks(nbits_all, b, c, b_pad), mesh)
    outs, bads = shard.sharded_decode_payload(cfg, mesh, words, nbits,
                                              consts=consts)
    if _global_masked_any(mesh, bads, b * c):
        bad_local, lo = _local_blocks(mesh, bads)
        where = np.argwhere(bad_local[:max(0, b - lo)].reshape(-1))
        at = (f" at channel-block {lo * c + int(where[0][0])}"
              if where.size else " (flagged on another process)")
        raise ValueError("corrupt payload" + at)
    pcm, start = _pcm_range(mesh, outs, b, half, c, num_samples)
    return DecodeShardResult(sample_rate=cfg.sample_rate, pcm=pcm,
                             sample_start=start, num_samples=num_samples)


def _decode_distributed_dense(data: bytes, off: int, cfg: CodecConfig,
                              mesh: shard.Mesh) -> DecodeShardResult:
    """The host-parse route: the native runtime parses the whole payload on
    every process, and each shard synthesizes its dense quantized arrays
    (shard.sharded_decode)."""
    _, num_samples, _ = read_header(data)
    c, half = cfg.n_channels, cfg.n_mdct_lines
    parsed = native.unpack_file(
        data[off:], np.asarray(cfg.band_layout.n_lines, np.int32),
        cfg.n_scale_bits, cfg.n_mant_size_bits, cfg.n_table_id_bits,
        read_lrms=True, n_channels=c)
    if parsed["n_cblocks"] % c:
        raise ValueError(f"corrupt payload: {parsed['n_cblocks']} "
                         f"channel-blocks for {c} channels")
    b = parsed["n_cblocks"] // c
    b_pad = -(-(b + 1) // mesh.size) * mesh.size
    put = lambda a: shard.shard_put(  # noqa: E731
        _shard_blocks(a.astype(np.int32), b, c, b_pad), mesh)
    lrms = np.pad(parsed["lrms"][:b] != 0, ((0, b_pad - b), (0, 0)))
    outs = shard.sharded_decode(
        cfg, mesh, put(parsed["ba"]), put(parsed["sf"]), put(parsed["mant"]),
        put(parsed["overall"]), shard.shard_put(lrms, mesh),
        consts=shard.mesh_tables(cfg, mesh))
    pcm, start = _pcm_range(mesh, outs, b, half, c, num_samples)
    return DecodeShardResult(sample_rate=cfg.sample_rate, pcm=pcm,
                             sample_start=start, num_samples=num_samples)
