"""Streaming encode/decode with explicit checkpoint/resume state
(pactpu.codec.stream) on PyTorch.

The reference codec's streaming state is small and explicit: the encoder's
`priorBlock` (reference codec/pacfile.py:264-268), `extraBits`
(pacfile.py:269) and the Huffman `bitDeposit` (codec/Huffman.py:262); the
decoder's `overlapAndAdd` half block (pacfile.py:147-150).  Here that
state is an object.  `StreamingEncoder.push` takes PCM in pieces of any
size and returns the payload bytes of every block that became complete;
`StreamingDecoder.push` takes stream bytes in pieces of any size and
returns PCM.  Both serialize their whole state with `state_bytes()` (an
`.npz` in pactpu's layout: a checkpoint of either package restores in the
other) and resume with `restore()`.

The output is the default `Engine`'s, byte for byte and sample for sample,
however the input is split.  The float32 analysis and synthesis of a block
depend on the size of the batch it runs in (cuBLAS and cuFFT pick their
kernels by batch size) and on its memory layout, so a stream analyses each
block, and synthesizes it, at its own row of a batch of the size and the
layout of the batch that holds it in the Engine's default chunking
(`engine._default_batches` of the file's block count): the analysis takes
the batch's PCM window as the Engine's "analyze" stage does, the push's
samples at their rows and zeros elsewhere, and the synthesis zero fields
in the rows a push does not hold.  The
encoder takes the block count from `header(num_samples)`, the decoder from
the stream's header.  Without it (the checkpoint of a pactpu encoder, or
no header written) the batches are DEFAULT_CHUNK_BLOCKS long, and the
bytes equal the Engine's only for the blocks it analyses in batches of
that length.

The rate control, the final pass and the payload framing are the Engine's
own (`Engine._rate_control`, `_finish_encode`), with the reservoir's
(bitDeposit, extraBits) carry (kernel K7's in the exact mode) handed from
push to push; a push's blocks run them in chunks of the Engine's sizes,
the last padded with zero rows to the next bucket as a file's tail is.
The decoder parses on the host (the native runtime), as
`Engine(decode_parse="host")` does, and extracts the codes with kernel K1.
On the card every stage of a push (the analysis, the measurement pass
with K11, K10 and K7 in the exact mode, the final pass, the synthesis)
replays a program of the stream's Engine (pactpu_torch.codec.programs),
the analysis the very program that `Engine.encode` replays for that batch
size.
"""

from __future__ import annotations

import io
from dataclasses import replace
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from pactpu_torch.codec import programs
from pactpu_torch.codec.engine import (
    DEFAULT_CHUNK_BLOCKS, Engine, _chunk_sizes, _default_batches,
    _download, _offsets, _overlap_add, _overlap_frames, _recut, analyze,
    interleaved_rows, resolve_device, synthesize)
from pactpu_torch.codec.header import (read_header, scan_channel_blocks,
                                       write_header)
from pactpu_torch.ops import quantize as q
from pactpu_torch.utils.config import CodecConfig
from pactpu_torch.utils.metrics import span


def _state_to_bytes(d: dict) -> bytes:
    buf = io.BytesIO()
    np.savez(buf, **d)
    return buf.getvalue()


def _state_from_bytes(data: bytes) -> dict:
    with np.load(io.BytesIO(data), allow_pickle=False) as z:
        return {k: z[k] for k in z.files}


def file_blocks(num_samples: int, half: int) -> int:
    """The coded blocks of a file of num_samples samples: one a block of
    `half` samples begun, plus the flush block (Engine.encode's count)."""
    return -(-int(num_samples) // half) + 1


def header_blocks(num_samples: int, half: int) -> int:
    """The coded blocks of a stream whose header says num_samples.  The
    header writes a whole number of blocks one block longer (Q6,
    reference codec/pacfile.py:231-271), so such a count is already the
    file's blocks."""
    if num_samples % half == 0:
        return num_samples // half
    return file_blocks(num_samples, half)


def batch_pieces(k0: int, k1: int, total: Optional[int]) -> list:
    """The blocks [k0, k1) of a file of `total` blocks cut by the batches
    of the Engine's default chunking of that file (past it, and with
    total None, batches of DEFAULT_CHUNK_BLOCKS): [(k, hi, start, size)]
    for each batch [start, start + size) that holds the blocks [k, hi)."""
    sizes = _default_batches(total) if total else []
    pieces = []
    k = k0
    while k < k1:
        start = 0
        for size in sizes:
            if k < start + size:
                break
            start += size
        else:
            size = DEFAULT_CHUNK_BLOCKS
            start += (k - start) // size * size
        hi = min(k1, start + size)
        pieces.append((k, hi, start, size))
        k = hi
    return pieces


def analyze_blocks(cfg: CodecConfig, seq: torch.Tensor, k0: int,
                   total: Optional[int], eng: Engine) -> list:
    """The analyses of the blocks [k0, k0 + m) of a file of `total` blocks,
    from their int16 PCM seq [C, (m + 1) * half] on eng's device, the
    block before them first (zeros before block 0).  Each batch that holds
    some of them in the Engine's default chunking (batch_pieces) runs as
    the Engine runs it: its PCM window i16[C, (size + 1) * half], the
    blocks' samples at their rows and zeros elsewhere, through eng's
    "analyze" stage (Engine._run_stage; on the card a replay of the
    program that Engine.encode replays for that batch size), which frames
    it.  The rows outside the blocks (at the edges frames of half the
    blocks' samples) are dropped: each row's analysis is its own.  eng:
    the stream's Engine, or a shard device's owner (parallel.shard.owner),
    whose tables the analysis reads.  Returns one analysis dict a piece,
    its blocks' rows, in block order.  The span "analyze" counts the rows
    analysed (the batches' sizes) and the real ones (m)."""
    with span("analyze") as sp:
        half = cfg.n_mdct_lines
        m = seq.shape[1] // half - 1
        dev = eng.consts()
        programmed = programs.encode_programs(eng)["analyze"]

        def stage(x):
            return analyze(cfg, _overlap_frames(x, half), dev)

        pieces = batch_pieces(k0, k0 + m, total)
        if sp is not None:
            sp.counts.update(rows=sum(p[3] for p in pieces), real_rows=m)
        analyses = []
        for k, hi, start, size in pieces:
            lo, n = k - start, hi - k
            window = F.pad(seq[:, (k - k0) * half:(hi - k0 + 1) * half],
                           (lo * half, (size - lo - n) * half))
            a = eng._run_stage("analyze", programmed, size, (cfg,), stage,
                               (window,))
            analyses.append({key: v[lo:lo + n] for key, v in a.items()})
        return analyses


def padded_rows(a: dict, size: int) -> dict:
    """A dict of per-block tensors (an analysis, a chunk's fields) grown
    to `size` rows with zero rows behind its own (a chunk's padding, as a
    file's tail chunk has)."""
    n = next(iter(a.values())).shape[0]
    if n == size:
        return a
    return {k: torch.cat([v, v.new_zeros((size - n, *v.shape[1:]))])
            for k, v in a.items()}


def _placed(t: torch.Tensor, lo: int, size: int) -> torch.Tensor:
    """t's rows at rows lo.. of a zero tensor of `size` rows."""
    if lo == 0 and t.shape[0] == size:
        return t
    out = t.new_zeros((size, *t.shape[1:]))
    out[lo:lo + t.shape[0]] = t
    return out


class StreamingEncoder:
    """Incremental .wak encoder.

    Usage:
        enc = StreamingEncoder()
        out = [enc.header(total_samples)]
        for piece in pcm_pieces:          # int16 [n, C], any n
            out.append(enc.push(piece))
        out.append(enc.flush())

    The concatenation equals `Engine(rate_mode=...).encode(pcm)` for the
    same config.  `header()` needs the total sample count (the header
    stores it, reference codec/pacfile.py:231-271); its first call also
    fixes the batches the blocks are analysed in.  rate_mode "cbr",
    "reservoir" or "exact"; chunk_blocks bounds the chunks of a push's
    rate control and final pass (None: as the Engine's of a file of the
    push's length, at most DEFAULT_CHUNK_BLOCKS), and the bytes do not
    depend on it; device as Engine's (the card unless the CPU is asked
    for)."""

    def __init__(self, cfg: Optional[CodecConfig] = None,
                 rate_mode: str = "reservoir",
                 chunk_blocks: Optional[int] = None, *, device="cuda"):
        self._eng = Engine(cfg, rate_mode, chunk_blocks=chunk_blocks,
                           device=device)
        self.cfg = self._eng.cfg
        half = self.cfg.n_mdct_lines
        c = self.cfg.n_channels
        # the encoder's entire sequential state:
        self._tail = np.zeros((c, half), np.int16)   # priorBlock
        self._rem = np.zeros((0, c), np.int16)       # sub-block remainder
        self._deposit = 0                            # Huffman bitDeposit
        self._extra = 0                              # carried extraBits
        # the same carry as the device tensor the last push left (None
        # before a push and after a restore): the next push starts from it
        self._carry = None
        self._n_samples = 0
        self._n_blocks = 0
        self._flushed = False
        self._total = None        # the file's blocks, from header()

    # -- streaming ---------------------------------------------------------

    def header(self, num_samples: int) -> bytes:
        if self._total is None:
            self._total = file_blocks(num_samples, self.cfg.n_mdct_lines)
        return write_header(self.cfg, num_samples)[0]

    def push(self, pcm: np.ndarray) -> bytes:
        """Feed int16 PCM [n, C]; returns the payload bytes of every block
        that became complete (possibly b'').  The root span "push" counts
        them."""
        with span("push") as sp:
            if self._flushed:
                raise RuntimeError("push after flush")
            c = self.cfg.n_channels
            pcm = np.asarray(pcm, np.int16)
            if pcm.ndim != 2 or pcm.shape[1] != c:
                raise ValueError(f"pcm must be [n, {c}] int16, got "
                                 f"{pcm.shape}")
            self._n_samples += pcm.shape[0]
            half = self.cfg.n_mdct_lines
            r = self._rem.shape[0]
            b = (r + pcm.shape[0]) // half
            if sp is not None:
                sp.counts["blocks"] = b
            if b == 0:
                self._rem = np.concatenate([self._rem, pcm])
                return b""
            take = b * half - r
            pieces = (self._rem, pcm[:take])
            self._rem = pcm[take:].copy()
            return self._encode_blocks(pieces)

    def flush(self) -> bytes:
        """Emit the final partial block (zero-padded) and the trailing flush
        block (reference codec/pacfile.py:355-366), a root span "push"."""
        if self._flushed:
            raise RuntimeError("flush called twice")
        self._flushed = True
        half = self.cfg.n_mdct_lines
        c = self.cfg.n_channels
        r = self._rem.shape[0]
        x = np.zeros(((2 if r else 1) * half, c), np.int16)
        x[:r] = self._rem
        self._rem = np.zeros((0, c), np.int16)
        with span("push", blocks=x.shape[0] // half):
            return self._encode_blocks((x,))

    def _encode_blocks(self, pieces) -> bytes:
        """Encode the complete blocks that the int16 sample pieces [n_k, C],
        joined, make, following the tail; advances all sequential state.
        The push's device tensors are freed in the span "release"."""
        host, seq = self._upload(pieces)
        staged = self._dispatch(seq)
        data = self._finish(staged, host)
        with span("release"):
            del staged, seq
        return data

    def _upload(self, pieces):
        """The PCM of a push: the tail, then the sample pieces [n_k, C]
        joined (m whole blocks), i16[C, (m + 1) half] on the host and on
        the device: the push's one host-to-device copy (the span "upload",
        the join included)."""
        with span("upload") as sp:
            host = np.concatenate([self._tail, *(p.T for p in pieces)], 1)
            src = torch.from_numpy(host)
            if sp is not None:
                sp.counts.update(bytes=src.nbytes,
                                 pinned=int(src.is_pinned()))
            return host, src.to(self._eng.device)

    def _dispatch(self, seq: torch.Tensor):
        """The device half of a push from its uploaded PCM (_upload): the
        analysis batch by batch (analyze_blocks), then the rate control
        and the final pass (Engine._rate_control) in the Engine's chunks
        of the push's m blocks (_chunk_sizes), the last padded with zero
        rows to the next bucket size, its valid prefix m.  On the card
        every stage is a program replay, and nothing waits for the device
        or copies from the host; the reservoir's carry comes from the last
        push as a device tensor.  Returns _rate_control's (staged, carry
        tensor)."""
        eng, cfg = self._eng, self.cfg
        m = seq.shape[1] // cfg.n_mdct_lines - 1
        pieces = analyze_blocks(cfg, seq, self._n_blocks, self._total, eng)
        sizes = _chunk_sizes(m, eng._chunk(m))
        offs = _offsets(sizes)
        real = [min(s, m - lo) for s, lo in zip(sizes, offs)]
        chunks = _recut(pieces, [p["smr"].shape[0] for p in pieces],
                        _offsets(real))
        return eng._rate_control(
            [padded_rows(a, s) for a, s in zip(chunks, sizes)], m, sizes,
            (self._deposit, self._extra) if self._carry is None
            else self._carry)

    def _finish(self, staged, host: np.ndarray) -> bytes:
        """Blocking half of a push: the payload download and framing
        (Engine._finish_encode), then the carry read and the state
        advanced past the push's blocks (host: _upload's PCM).  The carry's
        read is the span "carry"."""
        st, carry = staged
        data = self._eng._finish_encode(st)
        if torch.is_tensor(carry):
            self._carry = carry
            with span("carry"):
                carry = carry.tolist()
        self._deposit, self._extra = (int(v) for v in carry)
        half = self.cfg.n_mdct_lines
        self._tail = np.ascontiguousarray(host[:, -half:])
        self._n_blocks += host.shape[1] // half - 1
        return data

    # -- checkpoint/resume -------------------------------------------------

    def state_bytes(self) -> bytes:
        """Serialize the complete encoder state (a few KB): pactpu's keys,
        and the declared block count under `total_blocks` (-1: none)."""
        return _state_to_bytes(dict(
            tail=self._tail, rem=self._rem,
            scalars=np.asarray([self._deposit, self._extra, self._n_samples,
                                self._n_blocks, int(self._flushed)],
                               np.int64),
            total_blocks=np.asarray(-1 if self._total is None
                                    else self._total, np.int64)))

    @classmethod
    def restore(cls, state: bytes, cfg: Optional[CodecConfig] = None,
                rate_mode: str = "reservoir",
                chunk_blocks: Optional[int] = None, *,
                device="cuda") -> "StreamingEncoder":
        enc = cls(cfg, rate_mode, chunk_blocks, device=device)
        d = _state_from_bytes(state)
        enc._tail = d["tail"].astype(np.int16)
        enc._rem = d["rem"].astype(np.int16).reshape(
            -1, enc.cfg.n_channels)
        (enc._deposit, enc._extra, enc._n_samples, enc._n_blocks,
         flushed) = (int(x) for x in d["scalars"])
        enc._flushed = bool(flushed)
        total = int(d.get("total_blocks", -1))
        enc._total = None if total < 0 else total
        return enc


class StreamingDecoder:
    """Incremental .wak/.pac decoder.

    Feed bytes in any pieces (the header may span pushes); `push` returns
    int16 PCM [n, C] for every block that became decodable, with the
    reference decoder's first-block skip (reference codec/pacfile.py:
    484-487); `flush()` returns the final overlap-add half block
    (pacfile.py:171-178).  Concatenated push and flush output equals
    `Engine.decode` of the whole stream, trimmed as it is to the header's
    numSamples.

    A push decodes once chunk_blocks whole blocks are waiting (a
    multiple of them); `flush()` drains the rest.  Each returns a view of
    its one download.  The float overlap-add
    carry is taken after each push's last block, so the batch a block is
    synthesized in never rounds it.  The stream carries no window:
    `window` is the encode's.  device as Engine's."""

    def __init__(self, fmt: str = "wak", chunk_blocks: int = 16,
                 window: str = "sine", *, device="cuda"):
        if fmt not in ("wak", "pac"):
            raise ValueError(f"unknown format {fmt!r}")
        if int(chunk_blocks) < 1:
            raise ValueError("chunk_blocks must be >= 1")
        self._device = resolve_device(device, "StreamingDecoder")
        self._eng: Optional[Engine] = None
        self._fmt = fmt
        self._window = window
        self._chunk = int(chunk_blocks)
        self._buf = bytearray()        # undecoded stream bytes
        self._cfg: Optional[CodecConfig] = None
        self._carry: Optional[torch.Tensor] = None   # overlapAndAdd (f32)
        self._blk_idx = 0              # global block counter (skip block 0)
        self._flushed = False
        # output is trimmed to the header's numSamples, as Engine.decode's
        self._num_samples = 0
        self._emitted = 0

    @property
    def sample_rate(self) -> Optional[int]:
        return self._cfg.sample_rate if self._cfg else None

    def _start(self, cfg: CodecConfig, num_samples: int) -> None:
        """Set up for a stream whose header gave cfg and num_samples."""
        self._cfg = replace(cfg, window=self._window)
        self._num_samples = int(num_samples)
        self._eng = Engine(device=self._device, cfg=self._cfg, fmt=self._fmt)
        self._carry = torch.zeros((cfg.n_channels, cfg.n_mdct_lines),
                                  dtype=torch.float32, device=self._device)

    def push(self, data: bytes) -> np.ndarray:
        """Feed stream bytes; returns the PCM of every block that became
        decodable.  The root span "decode_push" counts the blocks it
        decoded."""
        with span("decode_push", blocks=0) as sp:
            # after a flush the carry has been emitted as PCM: decoding
            # further blocks would silently part from Engine.decode, so
            # refuse
            if self._flushed:
                raise RuntimeError("push after flush")
            self._buf.extend(data)
            if self._cfg is None:
                try:
                    cfg, n_samp, off = read_header(bytes(self._buf))
                except ValueError:
                    return np.zeros((0, 2), np.int16)  # header incomplete
                self._start(cfg, n_samp)
                del self._buf[:off]
            return self._decode_pending(False, sp)

    def flush(self) -> np.ndarray:
        """Drain the waiting blocks and return their PCM and the final
        overlap-add half block (reference codec/pacfile.py:171-178), a
        root span "decode_push"."""
        if self._flushed:
            raise RuntimeError("flush called twice")
        self._flushed = True
        with span("decode_push", blocks=0) as sp:
            if self._cfg is None:
                return np.zeros((0, 2), np.int16)
            return self._decode_pending(True, sp)

    def _clip(self, pcm: np.ndarray) -> np.ndarray:
        """Trim emitted PCM to the header's numSamples total."""
        pcm = pcm[:max(0, self._num_samples - self._emitted)]
        self._emitted += pcm.shape[0]
        return pcm

    def _decode_pending(self, flush: bool, sp=None) -> np.ndarray:
        """Decode the whole blocks waiting in the byte buffer (C
        channel-blocks each): a push's in multiples of chunk_blocks, a
        flush's every one and then the carry's final half block.  Their
        rows are laid out on the device as Engine.decode's
        (interleaved_rows) and download once.  sp: the call's root span
        (None when not recording), which takes the blocks' count."""
        c = self._cfg.n_channels
        starts, sizes, _ = scan_channel_blocks(self._buf)
        m = len(starts) // c
        if not flush:
            m -= m % self._chunk
        if sp is not None:
            sp.counts["blocks"] = m
        # the stream's first row is the MDCT delay (reference
        # codec/pacfile.py:484-487)
        skip = int(self._blk_idx == 0 and m > 0)
        outs = []
        if m:
            end = starts[m * c - 1] + sizes[m * c - 1]
            outs = self._synthesize(bytes(self._buf[:end]), m)
            del self._buf[:end]
        if flush:
            outs.append(q.float_to_pcm16(self._carry)[None])
        rows = interleaved_rows(outs, skip, m + flush)
        if not rows:
            return np.zeros((0, c), np.int16)
        return self._clip(_download(rows).reshape(-1, c))

    def _synthesize(self, payload: bytes, m: int) -> list:
        """The m blocks of payload: native parse and code repack on the
        host, then each batch piece (batch_pieces) through K1 and the
        synthesis at the block's rows of a batch of the Engine's size
        (stage "synthesize": on the card a program replay), and the
        overlap-add from the carry.  Returns each piece's PCM i16[n, C, N]
        on the device."""
        cfg, eng = self._cfg, self._eng
        c, half = cfg.n_channels, cfg.n_mdct_lines
        # rows as wide as the first of the Engine's decode layouts that
        # holds them (engine.decode_layout), not as the push's widest row:
        # the program is keyed by the width, and one a batch size serves
        # every push (zero words past a row's bits decode to nothing)
        parsed, words, _, width = eng._host_parse(payload, cfg,
                                                  layout_width=True)
        up = eng._upload
        fields = dict(ba=up(parsed["ba"].astype(np.int8).reshape(m, c, -1)),
                      sf=up(parsed["sf"].astype(np.int8).reshape(m, c, -1)),
                      words=up(words.view(np.int32).reshape(m, c, width)),
                      overall=up(parsed["overall"].astype(np.int8).reshape(
                          m, c)),
                      lrms=up(parsed["lrms"] != 0))
        dev = eng.consts()
        programmed = programs.decode_programs(eng)

        def stage(ba, sf, words, overall, lrms):
            return synthesize(cfg, ba, sf, words.reshape(-1, width),
                              overall, lrms, dev)

        k0 = self._blk_idx
        outs = []
        for k, hi, start, size in batch_pieces(
                k0, k0 + m, header_blocks(self._num_samples, half)):
            lo = k - start
            p = {key: _placed(v[k - k0:hi - k0], lo, size)
                 for key, v in fields.items()}
            td = eng._run_stage(
                "synthesize", programmed, size, (cfg,), stage,
                (p["ba"], p["sf"], p["words"], p["overall"], p["lrms"]))
            pcm, self._carry = _overlap_add(td[lo:lo + hi - k], self._carry)
            outs.append(pcm)
        self._blk_idx += m
        return outs

    # -- checkpoint/resume -------------------------------------------------

    def state_bytes(self) -> bytes:
        """Serialize the complete decoder state, in pactpu's layout: the
        undecoded bytes, the header (of numSamples 0), the float carry and
        (block index, flushed, numSamples, emitted)."""
        header = write_header(self._cfg, 0)[0] if self._cfg else b""
        return _state_to_bytes(dict(
            buf=np.frombuffer(bytes(self._buf), np.uint8),
            header=np.frombuffer(header, np.uint8),
            carry=(self._carry.cpu().numpy() if self._carry is not None
                   else np.zeros((0,), np.float32)),
            scalars=np.asarray([self._blk_idx, int(self._flushed),
                                self._num_samples, self._emitted],
                               np.int64)))

    @classmethod
    def restore(cls, state: bytes, fmt: str = "wak", chunk_blocks: int = 16,
                window: str = "sine", *,
                device="cuda") -> "StreamingDecoder":
        dec = cls(fmt=fmt, chunk_blocks=chunk_blocks, window=window,
                  device=device)
        d = _state_from_bytes(state)
        dec._buf = bytearray(d["buf"].tobytes())
        blk_idx, flushed, num_samples, emitted = (int(x)
                                                  for x in d["scalars"])
        header = d["header"].tobytes()
        if header:
            cfg, _, _ = read_header(header)
            dec._start(cfg, num_samples)
            dec._carry = torch.from_numpy(
                d["carry"].astype(np.float32).reshape(
                    cfg.n_channels, cfg.n_mdct_lines)).to(dec._device)
        dec._blk_idx = blk_idx
        dec._flushed = bool(flushed)
        dec._num_samples = num_samples
        dec._emitted = emitted
        return dec
