"""End-to-end codec engine on PyTorch (pactpu.codec.engine, main path).

The engine frames a whole file into [B, 2, 2048] chunks of blocks and runs
analysis (window + MDCT, overall scale, L/R-vs-M/S decision, stereo
psychoacoustic SMRs), then rate control, quantization, Huffman table
selection and payload packing on the device, one batch per chunk.  Only
the framing of the packed rows into the stream (and, on decode, the
Huffman bit-walk) runs on the host, in the repository's native runtime
(csrc/wakbits.cc through pactpu_torch.native).

Ported here: stereo, the sine window, the reference peak picker, water-fill
allocation, the intensity M/S rule, float32, on-device packing, and the
rate modes

- "cbr":       every block allocates from the flat per-block budget.
- "reservoir": two passes.  Pass 1 measures per-channel Huffman savings
               and allocation leftovers with no extra bits; the host
               replays the reference reservoir policy over them (deposit
               savings, withdraw 1/100 per block, carry the leftover,
               reference codec/Huffman.py:353-371, codec/codec.py:229);
               pass 2 re-encodes with those extra bits.  The analysis runs
               once and feeds both passes.

In both modes channel 0's allocation leftover funds channel 1 of the same
block (codec/codec.py:258-260).  `peak_mode` "para" and "weighted" swap the
psychoacoustic model's peak picker and take the compact masking sum
(kernel K6); the rest of the encoder is the same.

Decoding has two parse routes (`decode_parse`, or PACTPU_DECODE_PARSE):
"host" (and "auto") parses in the native runtime, repacks the mantissa
codes into fixed-width words, and slices them back on the device with
kernel K1; "device" uploads the raw payload framed into word rows and runs
the Huffman bit-walk there (kernel K5, then K1 for signs and LRMS flags).
Both end in the same synthesis and overlap-add and give the same samples.

Float32 products run in full float32: the engine turns TF32 off
(`torch.backends.cuda.matmul.allow_tf32`, `torch.backends.cudnn.allow_tf32`)
and sets the float32 matmul precision to "highest", as the JAX reference
uses Precision.HIGHEST for the MDCT and the masking product.
"""

from __future__ import annotations

import itertools
import os
from functools import lru_cache
from typing import Optional

import numpy as np
import torch

from pactpu_torch import native
from pactpu_torch.codec.header import read_header, write_header
from pactpu_torch.ops import bitalloc, bitpack, huffman, kernels, psycho
from pactpu_torch.ops import huffman_decode as hd
from pactpu_torch.ops import huffman_walk as hw
from pactpu_torch.ops import quantize as q
from pactpu_torch.ops.mdct import _mdct_basis_np, imdct, mdct
from pactpu_torch.ops.windows import analysis_window, hann_window
from pactpu_torch.utils.config import CodecConfig

DEFAULT_CHUNK_BLOCKS = 512

# u32 words per channel-block row of the on-device packer.  A chunk whose
# rows need more is re-finalized with the next width of _WIDE_WORDS.
PACK_WORDS = 256
# Average u32 words per row budgeted for the dense payload download (the
# chunk total absorbs per-row spikes); past it, the padded rows download.
PACK_DENSE_WORDS = 112
# Per-channel-block ceiling for the shipped tables: overall(4) + tid(4) +
# 25 * (ba 4 + sf 4) + 25 lrms + 1024 signs + 1024 * (max escape 13 + max
# mantissa 16) = 30,961 bits = 968 words.
PACK_WORDS_MAX = 968
_WIDE_WORDS = (384, PACK_WORDS_MAX)
# mantissa word widths of the decoder's repacked rows
_WORD_BUCKETS = (32, 64, 96, 128, 192, 256, 384, 512)
_TAIL_BUCKETS = (16, 32, 64, 96, 128, 192, 256, 384, 512)
# raw payload word widths of the device-parse route's rows
_PAYLOAD_WORD_BUCKETS = (32, 64, 96, 128, 192, 256, 384, 512, 768, 1024)


@lru_cache(maxsize=8)
def engine_consts_np(cfg: CodecConfig) -> dict:
    """The engine's constant tables as numpy arrays, array for array those
    of pactpu.codec.engine.engine_consts_np(cfg): the MDCT basis, the
    psychoacoustic tables and the Huffman code tables."""
    n = 2 * cfg.n_mdct_lines
    return dict(basis=_mdct_basis_np(n).astype(np.float32),
                psy=psycho._consts(n, cfg.sample_rate),
                tabs=huffman.load_tables())


def consts_from_numpy(consts_np: dict, device) -> dict:
    """Device tensors from an engine_consts_np dict (this package's, or
    pactpu.codec.engine.engine_consts_np's: the same arrays).

    Returns dict(basis f32[N, N/2], psy dict of quiet_i, zvec, bin_bark,
    mld, nonup and the Hann window, tabs tuple of int32 tables)."""
    t = lambda a, dt: torch.as_tensor(np.asarray(a, dt), device=device)  # noqa: E731
    basis = t(consts_np["basis"], np.float32)
    quiet_i, zvec, bin_bark, mld, nonup = consts_np["psy"]
    # kernel K4 skips masker ranges by the order of the bark grids
    for name, grid in (("zvec", zvec), ("bin_bark", bin_bark)):
        if not np.all(np.diff(np.asarray(grid, np.float32)) >= 0):
            raise ValueError(f"psychoacoustic {name} grid must ascend")
    psy = dict(quiet_i=t(quiet_i, np.float32), zvec=t(zvec, np.float32),
               bin_bark=t(bin_bark, np.float32), mld=t(mld, np.float32),
               nonup=t(nonup, np.float32),
               hann=t(hann_window(basis.shape[0]), np.float32))
    tabs = tuple(t(a, np.int32) for a in consts_np["tabs"])
    return dict(basis=basis, psy=psy, tabs=tabs)


def device_tables(cfg: CodecConfig, device) -> dict:
    """Everything the chunk programs read besides their inputs: the
    constants (consts_from_numpy), the band layout tables
    (psycho.layout_tensors) under "lay", and the analysis window "win"."""
    dev = consts_from_numpy(engine_consts_np(cfg), device)
    dev["lay"] = psycho.layout_tensors(cfg.band_layout, device)
    dev["win"] = torch.as_tensor(
        np.asarray(analysis_window(cfg.window, 2 * cfg.n_mdct_lines),
                   np.float32), device=device)
    return dev


def _overlap_frames(y: torch.Tensor, half: int) -> torch.Tensor:
    """[C, (B+1)*half] -> [B, C, 2*half] 50%-overlap frames: frame b is
    [y[b*half:(b+1)*half] ‖ y[(b+1)*half:(b+2)*half]]."""
    c = y.shape[0]
    b = y.shape[1] // half - 1
    first = y[:, :b * half].reshape(c, b, half)
    second = y[:, half:].reshape(c, b, half)
    return torch.cat([first, second], dim=-1).transpose(0, 1)


def analyze(cfg: CodecConfig, frames_i16: torch.Tensor, dev: dict) -> dict:
    """Encoder front half (pactpu analyze_body, stereo intensity branch):
    frames i16[B, 2, 2N] -> dict(mixed f32[B, 2, N], smr f32[B, 2, bands],
    lrms bool[B, bands], overall i32[B, 2])."""
    lay, psy = dev["lay"], dev["psy"]
    frames = q.pcm16_to_float(frames_i16)
    sw = frames * dev["win"]
    lines = mdct(sw, dev["basis"])
    overall = q.scale_factor(torch.abs(lines).amax(-1), cfg.n_scale_bits, 5)
    scaled = lines * q.exp2i(overall)[..., None]
    lrms = psycho.lrms_decision(frames, lay, cfg.ms_decision_factor)
    smr, mixed = psycho.stereo_smrs(sw, scaled, overall, lrms, psy, lay,
                                    cfg.sample_rate, cfg.peak_mode)
    return dict(mixed=mixed, smr=smr, lrms=lrms, overall=overall)


def finalize(cfg: CodecConfig, analysis: dict, extra0: torch.Tensor,
             dev: dict, pack_words: int = PACK_WORDS,
             measure_only: bool = False) -> dict:
    """Encoder tail (pactpu finalize_body, water_fill branch, on-device
    packing): water-filling allocation with the ch0 -> ch1 leftover chain,
    BFP quantization, Huffman table selection, payload packing.

    analysis: the analyze() dict; extra0: f32[B] reservoir extra bits of
    channel 0.  measure_only returns just (savings i32[B, 2], leftover
    i32[B]), the reservoir measurement.  Otherwise the dict also holds
    overall, lrms, bits, sf, tid and the packed payload words
    i32[2B, pack_words] (u32 bit patterns) with nbits i32[2B]."""
    lay = dev["lay"]
    half = cfg.n_mdct_lines
    n_lines, seg = lay["n_lines"], lay["seg"]
    max_mant = min(1 << cfg.n_mant_size_bits, cfg.max_mant_bits)
    mixed, smr, lrms = analysis["mixed"], analysis["smr"], analysis["lrms"]
    overall = analysis["overall"].to(torch.int32)
    b, c = mixed.shape[0], mixed.shape[1]

    budget = torch.tensor(cfg.bit_budget(), dtype=torch.float32,
                          device=mixed.device)
    extra = extra0.to(torch.float32)
    bits_ch = []
    for ch in range(c):
        total = (budget + extra).to(torch.int32)       # truncates, as int()
        bits_c, left = bitalloc.water_fill(
            total, max_mant, n_lines, smr[:, ch], lrms,
            cfg.ms_stop_threshold_db, cfg.lr_stop_threshold_db)
        bits_ch.append(bits_c)
        extra = left.to(torch.float32)
    bits = torch.stack(bits_ch, dim=1)                  # [B, C, bands]

    peak = psycho.band_max(torch.abs(mixed), lay, fill=0.0)
    sf = q.scale_factor(peak, cfg.n_scale_bits, bits)
    sf_l = sf[..., seg]
    nm_l = bits[..., seg]
    mant = q.bfp_mantissa(mixed, sf_l, cfg.n_scale_bits, nm_l)
    sign, unsigned = huffman.split_sign(mant, nm_l)
    transmit = nm_l > 0
    tid, codes, lens, huff_bits = huffman.encode_select(
        unsigned.reshape(b * c, half), nm_l.reshape(b * c, half),
        transmit.reshape(b * c, half), dev["tabs"])

    raw_bits = (bits * n_lines).sum(-1)
    n_signs = transmit.sum(-1)
    savings = (raw_bits - huff_bits.reshape(b, c) - n_signs
               - cfg.n_table_id_bits).to(torch.int32)
    if measure_only:
        return dict(savings=savings, leftover=left)

    words, nbits = bitpack.pack_payload_bits(
        overall.reshape(b * c), tid, bits.reshape(b * c, -1),
        sf.reshape(b * c, -1),
        torch.where(transmit, sign, 0).reshape(b * c, half), codes, lens,
        lrms.to(torch.int32).repeat_interleave(c, dim=0),
        cfg.band_layout.n_lines, cfg.n_scale_bits, cfg.n_mant_size_bits,
        cfg.n_table_id_bits, pack_words)
    return dict(overall=overall, lrms=lrms, bits=bits, sf=sf,
                tid=tid.reshape(b, c), savings=savings, leftover=left,
                words=words, nbits=nbits)


def _line_bit_offsets(ba_rows: torch.Tensor, lay: dict):
    """Per-line bit offset/width of the repacked mantissa codes from the
    per-band allocations ba_rows i32[rows, bands]: a band's lines all have
    its width, so a line's offset is the band's exclusive bit cumsum plus
    line-in-band x width.  Returns (off i32[rows, L], width i32[rows, L],
    total_bits i64[rows])."""
    band_bits = ba_rows.long() * lay["n_lines"]
    band_start = torch.cumsum(band_bits, dim=-1) - band_bits
    width = ba_rows[:, lay["seg"]]
    off = band_start[:, lay["seg"]] + lay["line_in_band"] * width
    return (off.to(torch.int32), width.to(torch.int32).contiguous(),
            band_bits.sum(-1))


def decode_body(cfg: CodecConfig, ba, sf, mant, overall, lrms,
                dev: dict) -> torch.Tensor:
    """Synthesis: quantized block arrays -> pre-overlap time samples.

    ba/sf: i32[B, 2, bands]; mant: i32[B, 2, N]; overall: i32[B, 2];
    lrms: bool[B, bands].  Returns f32[B, 2, 2N]."""
    seg = dev["lay"]["seg"]
    nm_l = ba[..., seg]
    vals = q.bfp_dequantize(sf[..., seg], mant, cfg.n_scale_bits, nm_l)
    vals = vals * q.exp2i(-overall)[..., None]
    # Q1 aliasing: the reference decoder emits L' = M - S, R' = M
    # (reference codec/codec.py:46-56)
    line_ms = lrms[:, seg]
    m, s = vals[:, 0], vals[:, 1]
    lines = torch.stack([torch.where(line_ms, m - s, m),
                         torch.where(line_ms, m, s)], dim=1)
    return imdct(lines, dev["basis"]) * dev["win"]


def decode_chunk(cfg: CodecConfig, ba, sf, words, overall, lrms, carry,
                 dev: dict):
    """One chunk of synthesis + overlap-add + 16-bit conversion.

    ba/sf: int[B, 2, bands]; words: i32[2B, W] repacked mantissa rows;
    overall: int[B, 2]; lrms: bool[B, bands]; carry: f32[2, N], the
    second half of the previous chunk's last frame (the decoder's
    overlap-add state, reference codec/pacfile.py:223-226).
    Returns (pcm i16[B, 2, N], carry')."""
    half = cfg.n_mdct_lines
    b, c = ba.shape[0], ba.shape[1]
    ba = ba.to(torch.int32)
    off, width, _ = _line_bit_offsets(ba.reshape(b * c, -1), dev["lay"])
    mant = kernels.extract_codes(words, off, width).reshape(b, c, half)
    td = decode_body(cfg, ba, sf.to(torch.int32), mant,
                     overall.to(torch.int32), lrms, dev)
    return _overlap_add(td, carry)


def _overlap_add(td: torch.Tensor, carry: torch.Tensor):
    """Pre-overlap blocks f32[B, C, 2N] and the previous chunk's carry
    f32[C, N] -> (pcm i16[B, C, N], carry')."""
    half = td.shape[-1] // 2
    first, second = td[..., :half], td[..., half:]
    prev_second = torch.cat([carry[None], second[:-1]], dim=0)
    return q.float_to_pcm16(prev_second + first), second[-1]


def walk_decode_chunk(cfg: CodecConfig, words, nbits, carry, dev: dict,
                      lut: dict):
    """One chunk of the device-parse route (pactpu chunk_walk_decode_fn):
    Huffman parse of the raw payload rows, synthesis, overlap-add, 16-bit
    conversion.

    words: i32[2B, W] payload rows; nbits: i32[2B]; lut: the walk LUT on
    the device.  Returns (pcm i16[B, 2, N], carry', bad bool[2B])."""
    c, half = cfg.n_channels, cfg.n_mdct_lines
    rec = kernels.huffman_walk(
        words, lut, cfg.band_layout.n_lines, cfg.n_scale_bits,
        cfg.n_mant_size_bits, cfg.n_table_id_bits)
    p = hd.parse_post(rec, words, nbits, dev["lay"])
    b = words.shape[0] // c
    # a block's LRMS flags are its last channel's row
    td = decode_body(cfg, p["ba"].reshape(b, c, -1),
                     p["sf"].reshape(b, c, -1),
                     p["mant"].reshape(b, c, half),
                     p["overall"].reshape(b, c),
                     p["lrms"].reshape(b, c, -1)[:, -1] != 0, dev)
    return (*_overlap_add(td, carry), p["bad"])


def expand_flat(flat: torch.Tensor, ba_rows: torch.Tensor, n_words: int,
                lay: dict) -> torch.Tensor:
    """Re-expand a chunk's dense mantissa words i32[cap] into rows
    i32[rows, n_words]: row r starts at the exclusive prefix sum of the
    rows' word counts, which derive from ba alone.  A trailing zero pad
    keeps every slice in range; the words a row reads past its own count
    belong to the next row, and are harmless: only a field's final word
    can be over-read, and its extra bits are shifted out (K1)."""
    _, _, total_bits = _line_bit_offsets(ba_rows, lay)
    counts = torch.clamp((total_bits + 31) // 32, max=n_words)
    row_off = torch.cumsum(counts, 0) - counts
    flatp = torch.cat([flat, flat.new_zeros(n_words)])
    idx = row_off[:, None] + torch.arange(n_words, device=flat.device)
    return flatp[idx]


def _pad_blocks(b: int, cap: int = DEFAULT_CHUNK_BLOCKS) -> int:
    """Chunk size for a b-block file: next power of two (min 16), capped at
    the chunk size."""
    n = 16
    while n < b and n < cap:
        n <<= 1
    return min(n, cap)


def _offsets(sizes, scale: int = 1) -> list:
    """Exclusive prefix sum of `sizes` (times `scale`), length+1."""
    return list(itertools.accumulate((s * scale for s in sizes), initial=0))


def _chunk_sizes(b: int, chunk: int) -> list:
    """Per-chunk block counts for a b-block file: full `chunk`-sized chunks
    plus a tail bucketed to the next size of _TAIL_BUCKETS (capped at
    `chunk`), so a short tail does not pay for a whole chunk."""
    full = b // chunk
    sizes = [chunk] * full
    tail = b - full * chunk
    if tail:
        sizes.append(min(next((s for s in _TAIL_BUCKETS if s >= tail),
                              chunk), chunk))
    return sizes


def reservoir_extras(savings: np.ndarray, leftover: np.ndarray,
                     divisor: int):
    """Host replay of the reference reservoir policy over per-block pass-1
    measurements: deposit per-channel savings, withdraw 1/divisor per block
    (reference codec/Huffman.py:353-371), carry allocation leftovers
    (codec/codec.py:229,258-260).  savings: int[B, C]; leftover: int[B].
    Returns (extraBits of channel 0 per block int64[B], final (deposit,
    extra) carry)."""
    b = savings.shape[0]
    extras = np.zeros(b, np.int64)
    deposit = extra = 0
    for t in range(b):
        if deposit > 10:
            w = deposit // divisor
            deposit -= w
            extra += w
        elif deposit < 0:
            extra += deposit
            deposit = 0
        extras[t] = extra
        deposit += int(savings[t].sum())   # per-channel deposits, Q10
        extra = int(leftover[t])
    return extras, (deposit, extra)


def _full_fp32() -> None:
    """Float32 matrix products and convolutions in full float32 (no TF32),
    the counterpart of the reference's Precision.HIGHEST."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def _host_u32(t: torch.Tensor) -> np.ndarray:
    """Download an int32 tensor of u32 bit patterns as numpy uint32."""
    return t.cpu().numpy().view(np.uint32)


class Engine:
    """File-level encoder/decoder of .wak streams on one torch device.

    device: where the chunk programs run ("cuda", "cuda:0", "cpu"); there
    is no default.  On a CUDA device the six kernels run as hand-written
    CUDA; on the CPU their plain versions run.  chunk_blocks fixes the
    batch size (None = adapt up to DEFAULT_CHUNK_BLOCKS).  decode_parse
    places the decoder's Huffman parse: "host" (native runtime), "device"
    (kernel K5 on the raw payload) or "auto" (= host: the native runtime is
    always there); None reads PACTPU_DECODE_PARSE (default auto)."""

    def __init__(self, device, cfg: Optional[CodecConfig] = None,
                 rate_mode: str = "reservoir",
                 chunk_blocks: Optional[int] = None,
                 decode_parse: Optional[str] = None):
        if rate_mode not in ("cbr", "reservoir"):
            raise ValueError(f"rate mode {rate_mode!r} is not ported "
                             "(use 'reservoir' or 'cbr')")
        if decode_parse is None:
            decode_parse = os.environ.get("PACTPU_DECODE_PARSE", "auto")
        if decode_parse not in ("auto", "device", "host"):
            raise ValueError(f"PACTPU_DECODE_PARSE={decode_parse!r}: "
                             "expected auto, device or host")
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("Engine(device='cuda'): no CUDA device")
        self.cfg = cfg or CodecConfig()
        _check_config(self.cfg)
        self.rate_mode = rate_mode
        self.chunk_blocks = chunk_blocks
        self.decode_parse = decode_parse
        self._dev = None
        _full_fp32()

    def tables(self) -> dict:
        """Device-resident constant tables (uploaded once per Engine)."""
        if self._dev is None:
            self._dev = device_tables(self.cfg, self.device)
        return self._dev

    def _chunk(self, b: int) -> int:
        return self.chunk_blocks or _pad_blocks(b)

    # -- encode ----------------------------------------------------------

    def _encode_chunks(self, pcm: np.ndarray) -> dict:
        """Upload the PCM once, run the analysis and both reservoir passes
        chunk by chunk, and stage the dense payload download.  The only
        host round trip before the download is the pass-1 measurement the
        reservoir replay needs."""
        cfg = self.cfg
        half = cfg.n_mdct_lines
        c = cfg.n_channels
        if pcm.ndim != 2 or pcm.shape[1] != c:
            raise ValueError(f"pcm must be [n, {c}] int16, got {pcm.shape}")
        b = -(-pcm.shape[0] // half) + 1             # + flush block
        sizes = _chunk_sizes(b, self._chunk(b))
        offs = _offsets(sizes)
        b_pad = offs[-1]
        dev = self.tables()

        glob = np.zeros((c, (b_pad + 1) * half), np.int16)
        n = min(pcm.shape[0], b_pad * half)
        glob[:, half:half + n] = pcm[:n].T
        pcm_dev = torch.from_numpy(glob).to(self.device)
        analyses = [analyze(cfg, _overlap_frames(
            pcm_dev[:, offs[k] * half:(offs[k + 1] + 1) * half], half), dev)
            for k in range(len(sizes))]

        extras = np.zeros(b_pad, np.float32)
        if self.rate_mode == "reservoir":
            zero = [torch.zeros(s, device=self.device) for s in sizes]
            meas = [finalize(cfg, a, z, dev, measure_only=True)
                    for a, z in zip(analyses, zero)]
            sav = torch.cat([m["savings"] for m in meas]).cpu().numpy()
            left = torch.cat([m["leftover"] for m in meas]).cpu().numpy()
            # padded tail blocks take no part: the policy runs over the
            # file's b blocks and their extras stay 0
            extras[:b] = reservoir_extras(sav[:b], left[:b],
                                          cfg.reservoir_withdraw_divisor)[0]
        extras_dev = torch.from_numpy(extras).to(self.device)
        extras_chunks = [extras_dev[offs[k]:offs[k + 1]]
                         for k in range(len(sizes))]
        outs = [finalize(cfg, a, ex, dev, pack_words=PACK_WORDS)
                for a, ex in zip(analyses, extras_chunks)]
        dense = bitpack.compact_rows(
            torch.cat([o["words"] for o in outs]),
            torch.cat([o["nbits"] for o in outs]),
            b_pad * c * PACK_DENSE_WORDS)
        return dict(outs=outs, b=b, analyses=analyses,
                    extras=extras_chunks, sizes=sizes, dense=dense)

    def _finish_encode(self, st: dict) -> bytes:
        """Blocking half of an encode: ONE download of the dense payload
        (rows compacted by their word counts, nbits appended), then host
        framing.  Fallbacks: a chunk whose rows overflow PACK_WORDS is
        re-finalized with a wider packer; a dense total past its cap
        downloads the padded rows instead."""
        cfg = self.cfg
        c = cfg.n_channels
        outs, b, sizes = st["outs"], st["b"], st["sizes"]
        width = outs[0]["words"].shape[1]
        row_offs = _offsets(sizes, scale=c)
        cap = row_offs[-1] * PACK_DENSE_WORDS
        dn = _host_u32(st["dense"])
        nbits_all = dn[cap:].astype(np.int32)
        counts = np.minimum((nbits_all.astype(np.int64) + 31) // 32, width)
        offsets = np.concatenate([[0], np.cumsum(counts[:-1])]).astype(
            np.int32)
        use_dense = int(counts.sum()) <= cap
        if use_dense:
            flat = dn[:cap]
        else:
            words_all = _host_u32(torch.cat([o["words"] for o in outs]))
        parts = []
        done = 0
        for k, (a, ex) in enumerate(zip(st["analyses"], st["extras"])):
            nb = min(sizes[k], b - done)
            if nb <= 0:
                break
            rows = slice(row_offs[k], row_offs[k] + c * nb)
            nb_rows = nbits_all[rows]
            need = -(-int(nb_rows.max(initial=0)) // 32)
            if need > width:
                wide = next((w for w in _WIDE_WORDS if w >= need), None)
                if wide is None:
                    raise ValueError(f"a payload row needs {need} words, "
                                     f"past the {PACK_WORDS_MAX}-word packer")
                wout = finalize(cfg, a, ex, self.tables(), pack_words=wide)
                parts.append(native.assemble_rows(
                    _host_u32(wout["words"][:c * nb]),
                    wout["nbits"][:c * nb].cpu().numpy()))
            elif use_dense:
                parts.append(native.assemble_rows_flat(
                    flat, offsets[rows], nb_rows))
            else:
                parts.append(native.assemble_rows(words_all[rows], nb_rows))
            done += nb
        return b"".join(parts)

    def encode(self, pcm: np.ndarray) -> bytes:
        """pcm: int16 [n, 2] -> complete .wak byte stream."""
        header, _ = write_header(self.cfg, pcm.shape[0])
        return header + self._finish_encode(self._encode_chunks(pcm))

    def encode_many(self, pcms) -> list:
        """Batch encode: every file's device work is queued before the
        first payload download blocks.  The device holds every staged
        file."""
        staged = [(write_header(self.cfg, p.shape[0])[0],
                   self._encode_chunks(p)) for p in pcms]
        return [h + self._finish_encode(st) for h, st in staged]

    def roundtrip_many(self, pcms, return_streams: bool = False):
        """Pipelined many-file encode -> decode: every encode is staged
        first; then file k's payload download and decode dispatch run
        while later files' device work is queued; the PCM downloads drain
        last.  Returns [(sample_rate, pcm), ...] (and the streams with
        return_streams=True), identical to serial encode()/decode()."""
        staged = [(write_header(self.cfg, p.shape[0])[0],
                   self._encode_chunks(p)) for p in pcms]
        streams, dec = [], []
        for header, st in staged:
            stream = header + self._finish_encode(st)
            streams.append(stream)
            dec.append(self._decode_dispatch(stream))
        results = [self._decode_finish(*d) for d in dec]
        return (results, streams) if return_streams else results

    # -- decode ----------------------------------------------------------

    def decode(self, data: bytes) -> tuple[int, np.ndarray]:
        """Full stream -> (sample_rate, int16 [n, C]): the reference
        decoder's first-block skip and final overlap-add flush (reference
        codec/pacfile.py:484-487, 171-178), trimmed to the header's
        numSamples (incl. the Q6 padding quirk)."""
        return self._decode_finish(*self._decode_dispatch(data))

    def decode_many(self, datas) -> list:
        """Batch decode: every stream is parsed (or framed), uploaded and
        queued before the first PCM download blocks."""
        staged = [self._decode_dispatch(d) for d in datas]
        return [self._decode_finish(*st) for st in staged]

    def decode_range(self, data: bytes, start_sample: int,
                     num_samples: int) -> tuple[int, np.ndarray]:
        """Random-access decode: (sample_rate, int16 [n, C]) of the sample
        window [start_sample, start_sample + num_samples), clipped to the
        stream, without decoding the rest.

        The per-channel-block byte-count prefixes make a stream seekable
        (reference codec/pacfile.py:170-183): the host scans prefixes to
        the coded blocks the window needs, and the same staging and chunk
        programs as decode() run on that slice, on either parse route.
        Output block i is the overlap-add of frames i and i + 1, so a
        window costs ceil(window / N) + 1 coded blocks whatever the file's
        length.  The output equals the same slice of a full decode()."""
        cfg, total_samples, off = read_header(data)
        half, c = cfg.n_mdct_lines, cfg.n_channels
        s0 = max(0, int(start_sample))
        s1 = min(int(total_samples),
                 int(start_sample) + max(0, int(num_samples)))
        if s1 <= s0:
            return cfg.sample_rate, np.zeros((0, c), np.int16)

        payload = data[off:]
        i0, i1 = s0 // half, (s1 - 1) // half        # audio block range
        spans = []                                    # per-frame byte spans
        pos = 0
        while pos < len(payload) and len(spans) <= i1 + 1:
            start = pos
            for _ in range(c):
                if pos + 4 > len(payload):
                    raise ValueError("truncated channel-block header")
                pos += 4 + int.from_bytes(payload[pos:pos + 4], "little")
                if pos > len(payload):
                    raise ValueError("corrupt payload: channel-block "
                                     "length exceeds the stream")
            spans.append((start, pos))
        if not spans:
            raise ValueError("no channel-blocks found in payload")
        last = len(spans) - 1
        f0, f1 = min(i0, last), min(i1 + 1, last)
        at_eof = f1 == last and pos >= len(payload)

        mini = (write_header(cfg, total_samples)[0]
                + payload[spans[f0][0]:spans[f1][1]])
        _, _, mb, ola_dev, n_bad = self._decode_dispatch(mini)
        ola = self._fetch_ola(ola_dev, mb, c, n_bad, first_cblock=f0 * c)
        # row t is the overlap-add of frames f0+t-1 and f0+t = audio block
        # f0+t-1; row 0 lacks its true carry and is dropped (as the whole-
        # file decoder's first-block skip); the tail row is the final
        # flush, valid only at the end of the stream
        rows = ola[1:mb + (1 if at_eof else 0)]
        audio = rows.transpose(1, 0, 2).reshape(c, -1).T
        base = f0 * half
        return cfg.sample_rate, audio[s0 - base:s1 - base].copy()

    def _decode_staging(self, data: bytes) -> dict:
        """Host half of a decode: read the header and stage the payload by
        the engine's parse route.  Returns dict(cfg, num_samples, b, run,
        chunk_args): `run(*chunk_args[k], carry)` uploads chunk k and
        queues its decode, returning (pcm i16[B, C, N], carry', bad
        bool[C B] or None)."""
        cfg, num_samples, off = read_header(data)
        _check_config(cfg)
        if self.decode_parse == "device":
            staged = self._decode_staging_device_parse(data, off, cfg)
            if staged is None:
                raise ValueError(
                    "PACTPU_DECODE_PARSE=device: this stream/table set "
                    "does not fit the device parser (oversized rows or "
                    "Huffman codes beyond the LUT's bounds)")
        else:
            staged = self._decode_staging_host_parse(data, off, cfg)
        return dict(cfg=cfg, num_samples=num_samples, **staged)

    def _decode_staging_device_parse(self, data: bytes, off: int,
                                     cfg: CodecConfig):
        """Stage a device-parse decode: frame the raw payload into word
        rows; the chunk program (kernel K5 on a CUDA device, its plain
        version on the CPU) does everything else.  Whether the stream fits
        is decided here, before staging: returns None when it needs the
        host parser (rows wider than the largest bucket, or tables outside
        the LUT's bounds)."""
        lut = hw.device_walk_lut(None, self.device)
        if lut is None:
            return None
        words, nbits = hd.frame_rows(data[off:],
                                     word_cap=_PAYLOAD_WORD_BUCKETS[-1])
        if words is None:
            return None
        c = cfg.n_channels
        rows = words.shape[0]
        if rows % c:
            raise ValueError(f"corrupt payload: {rows} channel-blocks for "
                             f"{c} channels")
        w_bucket = next(w for w in _PAYLOAD_WORD_BUCKETS
                        if w >= words.shape[1])
        b = rows // c
        sizes = _chunk_sizes(b, self._chunk(b))
        offs = _offsets(sizes, scale=c)
        words = np.pad(words, ((0, offs[-1] - rows),
                               (0, w_bucket - words.shape[1])))
        nbits = np.pad(nbits, (0, offs[-1] - rows))
        dev = self.tables()

        def run(words_k, nbits_k, carry):
            return walk_decode_chunk(
                cfg, self._upload(words_k.view(np.int32)),
                self._upload(nbits_k), carry, dev, lut)

        return dict(b=b, run=run, chunk_args=[
            (words[offs[k]:offs[k + 1]], nbits[offs[k]:offs[k + 1]])
            for k in range(len(sizes))])

    def _decode_staging_host_parse(self, data: bytes, off: int,
                                   cfg: CodecConfig) -> dict:
        """Stage a host-parse decode: native parse, repack of the mantissa
        codes into fixed-width words, and compaction of each chunk's rows
        into one flat buffer (padded rows where a chunk's total exceeds
        PACK_DENSE_WORDS per row)."""
        c = cfg.n_channels
        n_lines = np.asarray(cfg.band_layout.n_lines, np.int32)
        parsed = native.unpack_file(
            data[off:], n_lines, cfg.n_scale_bits, cfg.n_mant_size_bits,
            cfg.n_table_id_bits, read_lrms=True, n_channels=c)
        if parsed["n_cblocks"] % c:
            raise ValueError(f"corrupt payload: {parsed['n_cblocks']} "
                             f"channel-blocks for {c} channels")
        b = parsed["n_cblocks"] // c
        sizes = _chunk_sizes(b, self._chunk(b))
        offs = _offsets(sizes)
        b_pad = offs[-1]

        def d2(a):
            a = a.reshape(b, c, *a.shape[1:])
            return np.pad(a, [(0, b_pad - b)] + [(0, 0)] * (a.ndim - 1))

        ba = d2(parsed["ba"]).astype(np.int8)
        sf = d2(parsed["sf"]).astype(np.int8)
        overall = d2(parsed["overall"]).astype(np.int8)
        lrms = np.pad(parsed["lrms"] != 0, ((0, b_pad - b), (0, 0)))

        rowbits = (parsed["ba"].astype(np.int64) * n_lines).sum(1)
        max_bits = int(rowbits.max(initial=0))
        n_words = next((w for w in _WORD_BUCKETS if w * 32 >= max_bits),
                       -(-max_bits // 32))
        rows_pad = native.repack_codes(parsed["mant"], parsed["ba"], n_lines,
                                       n_words)
        counts = np.minimum((rowbits + 31) // 32, n_words)
        col = np.arange(n_words)[None, :]
        words = []
        for k, sz in enumerate(sizes):
            i, rpc = offs[k] * c, sz * c
            cap_k = rpc * PACK_DENSE_WORDS
            cc = counts[i:i + rpc]
            if int(cc.sum()) > cap_k:
                words = None                 # dense overflow: padded rows
                break
            fl = rows_pad[i:i + rpc][col < cc[:, None]]
            words.append(np.pad(fl, (0, cap_k - fl.shape[0])))
        flat = words is not None
        if not flat:
            rows_all = d2(rows_pad).reshape(b_pad * c, n_words)
            words = [rows_all[offs[k] * c:offs[k + 1] * c]
                     for k in range(len(sizes))]
        dev = self.tables()
        up = self._upload

        def run(ba_k, sf_k, words_k, overall_k, lrms_k, carry):
            ba_k, words_k = up(ba_k), up(words_k)
            if flat:
                words_k = expand_flat(
                    words_k, ba_k.reshape(-1, ba_k.shape[-1]).to(
                        torch.int32), n_words, dev["lay"])
            return (*decode_chunk(cfg, ba_k, up(sf_k), words_k,
                                  up(overall_k), up(lrms_k), carry, dev),
                    None)

        return dict(b=b, run=run, chunk_args=[
            (ba[offs[k]:offs[k + 1]], sf[offs[k]:offs[k + 1]],
             words[k].view(np.int32), overall[offs[k]:offs[k + 1]],
             lrms[offs[k]:offs[k + 1]]) for k in range(len(sizes))])

    def _upload(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    def _decode_dispatch(self, data: bytes):
        """Stage, upload and queue every chunk's decode; returns the state
        _decode_finish needs, without waiting for the device."""
        return self._decode_launch(self._decode_staging(data))

    def _decode_launch(self, staged: dict):
        """Device half of a decode dispatch: upload each chunk of a
        _decode_staging result and queue its decode.  Returns (cfg,
        num_samples, b, ola, n_bad): ola i16[b + 1 (+ flag rows), C, N] is
        the overlap-added PCM; on the device-parse route the n_bad
        per-channel-block corruption flags ride behind it as further rows,
        so that one download brings both."""
        cfg, b = staged["cfg"], staged["b"]
        c, half = cfg.n_channels, cfg.n_mdct_lines
        carry = torch.zeros((c, half), device=self.device)
        pcm_chunks, bad_chunks = [], []
        for args in staged["chunk_args"]:
            pcm, carry, bad = staged["run"](*args, carry)
            pcm_chunks.append(pcm)
            if bad is not None:
                bad_chunks.append(bad)
        # the final-flush half (reference pacfile.py:171-178) is the carry
        # when every block was real, else the overlap-add of the first
        # padded block; appending the carry row unifies both
        tail = q.float_to_pcm16(carry)[None]
        ola = torch.cat(pcm_chunks + [tail])[:b + 1]
        n_bad = 0
        if bad_chunks:
            n_bad = b * c
            flags = torch.cat(bad_chunks)[:n_bad].to(torch.int16)
            flags = torch.nn.functional.pad(flags, (0, -n_bad % (c * half)))
            ola = torch.cat([ola, flags.reshape(-1, c, half)])
        return cfg, staged["num_samples"], b, ola, n_bad

    @staticmethod
    def _fetch_ola(ola_dev, b: int, c: int, n_bad: int,
                   first_cblock: int = 0) -> np.ndarray:
        """The single download of a decode: the overlap-added PCM rows
        i16[b + 1, C, N], after raising on a channel-block the device
        parser flagged (numbered from first_cblock)."""
        ola = ola_dev.cpu().numpy()
        bad = ola[b + 1:].reshape(-1)[:n_bad]
        if bad.any():
            raise ValueError("corrupt payload at channel-block "
                             f"{first_cblock + int(np.argmax(bad))}")
        return ola[:b + 1]

    def _decode_finish(self, cfg, num_samples, b, ola_dev, n_bad):
        """Blocking half of decode: the single download + reshaping.
        Row 0 (the MDCT delay) is dropped, the flush row kept."""
        c = cfg.n_channels
        audio = self._fetch_ola(ola_dev, b, c, n_bad)[1:]
        pcm = audio.transpose(1, 0, 2).reshape(c, -1).T[:num_samples]
        return cfg.sample_rate, pcm.copy()


def _check_config(cfg: CodecConfig) -> None:
    """The port covers the reference main path; other modes are still to
    port (ROADMAP.md)."""
    todo = []
    if cfg.n_channels != 2:
        todo.append(f"n_channels={cfg.n_channels}")
    for field, want in (("window", ("sine",)),
                        ("peak_mode", ("ref", "para", "weighted")),
                        ("alloc_mode", ("water_fill",)),
                        ("ms_decision", ("intensity",))):
        if getattr(cfg, field) not in want:
            todo.append(f"{field}={getattr(cfg, field)!r}")
    if cfg.n_mant_size_bits > 5:
        todo.append("n_mant_size_bits > 5")
    if todo:
        raise ValueError("not ported: " + ", ".join(todo))
