"""End-to-end codec engine on PyTorch (pactpu.codec.engine).

The engine frames a whole file into [B, C, 2048] chunks of blocks and runs
analysis (window + MDCT, overall scale, L/R-vs-M/S decision, stereo or
mono psychoacoustic SMRs), then rate control, quantization, Huffman table
selection and payload packing on the device, one batch per chunk (the
analysis per chunk of the default size, Engine._analyze).  Only
the framing of the packed rows into the stream (and, on decode, the
Huffman bit-walk) runs on the host, in the repository's native runtime
(csrc/wakbits.cc through pactpu_torch.native).

Ported here: stereo and mono, the sine and KBD windows, the three peak
pickers, the five allocators (water-fill, kernel K2; kai's closed form,
K8; uniform; constant SNR and MNR, K9), the intensity and
bit-allocation M/S rules, float32 and float64 (precision "f32" | "f64"),
on-device or host packing, trained Huffman table sets, and the rate
modes

- "cbr":       every block allocates from the flat per-block budget.
- "reservoir": two passes.  Pass 1 measures per-channel Huffman savings
               and allocation leftovers with no extra bits; kernel K11
               replays the reference reservoir policy over them on the
               device (deposit savings, withdraw 1/100 per block, carry
               the leftover, reference codec/Huffman.py:353-371,
               codec/codec.py:229), its carry chained from chunk to chunk
               there; pass 2 re-encodes with those extra bits.  The
               analysis runs once and feeds both passes.
- "exact":     the reference's serial reservoir trajectory itself: cost
               tables of every allocation, then kernel K7 walks every
               block (pactpu_torch.codec.exact), then one final pass.  With
               precision="f64" the stream is the reference's serial encode
               (the float64 oracle, pactpu_torch.compat.refcodec).

In both modes channel 0's allocation leftover funds channel 1 of the same
block (codec/codec.py:258-260).  `peak_mode` "para" and "weighted" swap the
psychoacoustic model's peak picker and take the compact masking sum
(kernel K6); the rest of the encoder is the same.  The baseline .pac coder
(Engine(fmt="pac"), encode_baseline) has no Huffman coding, no M/S and no
reservoir; its payload is serialized on the host (native.pack_file).

Decoding has two parse routes (`decode_parse`, or PACTPU_DECODE_PARSE):
"host" (and "auto") parses in the native runtime, repacks the mantissa
codes into fixed-width words, and slices them back on the device with
kernel K1; "device" uploads the raw payload framed into word rows and runs
the Huffman bit-walk there (kernel K5, then K1 for signs and LRMS flags),
or for .pac the fixed-width parse (K1 alone).  Both end in the same
synthesis and overlap-add and give the same samples.

Under precision="f64" every float stage runs in float64 (the basis, the
psychoacoustic tables, the windows, K2's and K4's float64 forms), with the
reference's float64 arithmetic where it decides an integer
(pactpu_torch.ops.quantize); `fmt="pac"` encodes in float32 whatever the
precision, as pactpu does.

On the card each stage of a chunk (the analysis, the measurement pass
with K11, the exact mode's cost tables (K10) and scan (K7), the final
pass with the pack and the dense compaction or the host packer's fields,
the .pac coder's baseline encode of a batch, and the decode chunk of
either parse route) runs as a CUDA-graph replay, captured once a shape,
for every configuration of either format (pactpu_torch.codec.programs;
debug_checks stays launch by launch).  On the CPU, or with
`Engine.use_programs` set to False, the stage functions run directly,
launch by launch.

Float32 products run in full float32: the engine turns TF32 off
(`torch.backends.cuda.matmul.allow_tf32`, `torch.backends.cudnn.allow_tf32`)
and sets the float32 matmul precision to "highest", as the JAX reference
uses Precision.HIGHEST for the MDCT and the masking product.
"""

from __future__ import annotations

import itertools
import os
from dataclasses import replace
from functools import lru_cache
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from numpy.lib.stride_tricks import sliding_window_view

from pactpu_torch import native
from pactpu_torch.codec import exact, programs
from pactpu_torch.codec.header import (read_header, scan_channel_blocks,
                                       write_header)
from pactpu_torch.ops import bitalloc, bitpack, huffman, kernels, psycho
from pactpu_torch.ops import huffman_decode as hd
from pactpu_torch.ops import huffman_walk as hw
from pactpu_torch.ops import quantize as q
from pactpu_torch.ops.mdct import _mdct_basis_np, imdct, mdct
from pactpu_torch.ops.windows import analysis_window, hann_window
from pactpu_torch.utils.config import CodecConfig
from pactpu_torch.utils.metrics import span

DEFAULT_CHUNK_BLOCKS = 512

# u32 words per channel-block row of the on-device packer at the default
# rate (2.27 bits a sample); pack_widths scales it to a configuration's bit
# budget.  A chunk whose rows need more is re-finalized at PACK_WORDS_MAX.
PACK_WORDS = 256
# Average u32 words per row budgeted for the dense payload download at the
# default rate (the chunk total absorbs per-row spikes), scaled as
# PACK_WORDS is; past it, the padded rows download.  The host-parse decode
# budgets its upload by the same words (_decode_layouts).
PACK_DENSE_WORDS = 112
# Per-channel-block ceiling for the shipped tables: overall(4) + tid(4) +
# 25 * (ba 4 + sf 4) + 25 lrms + 1024 signs + 1024 * (max escape 13 + max
# mantissa 16) = 30,961 bits = 968 words.
PACK_WORDS_MAX = 968
# mantissa word widths of the decoder's repacked rows
_WORD_BUCKETS = (32, 64, 96, 128, 192, 256, 384, 512)
_TAIL_BUCKETS = (16, 32, 64, 96, 128, 192, 256, 384, 512)
# the analysis dict's tensors, in the order the programs take them
_ANALYSIS_KEYS = ("mixed", "smr", "lrms", "overall")
# raw payload word widths of the device-parse route's rows
_PAYLOAD_WORD_BUCKETS = (32, 64, 96, 128, 192, 256, 384, 512, 768, 1024)


PRECISIONS = {"f32": np.float32, "f64": np.float64}

# the bit budget PACK_WORDS and PACK_DENSE_WORDS were sized on
_PACK_BASE_BITS = CodecConfig().bit_budget()


def pack_widths(cfg: CodecConfig) -> tuple:
    """(row words, dense words a row) of the on-device packer for cfg:
    PACK_WORDS and PACK_DENSE_WORDS times cfg's bit budget over the
    default's, never less, the row rounded up to 32 words.  A row holds
    its channel's budget, the reservoir's loan and channel 0's leftover,
    which grow with the budget (at 4.93 bits a sample the loans reach a
    whole budget): 608 and 257 words there."""
    s = max(1.0, cfg.bit_budget() / _PACK_BASE_BITS)
    words = min(PACK_WORDS_MAX, 32 * int(np.ceil(PACK_WORDS * s / 32)))
    return words, int(np.ceil(PACK_DENSE_WORDS * s))


def _decode_layouts() -> tuple:
    """The host-parse decode's upload layouts, in order: (the words a row
    that a chunk's dense upload budgets, the width of the rows the device
    expands them to).  A stream takes the first whose budget holds each of
    its chunks and whose width holds its widest row, past the last its
    padded rows.  At 2.27 bits a sample the widest row takes 96 or 128
    words, so the first; 256 holds any row of up to 8,192 mantissa bits;
    at 4.93 the rows average 129 words, past the first budget, so the
    last.  The budget is of mantissa bits alone, not of the coded rows
    that pack_widths budgets, so twice the default's holds 4.93's with 1.7
    times to spare.  The decode program is keyed by the layout, not by the
    stream's widest row: a stream's header carries no rate, and one
    program a chunk size and layout serves every stream that fits it."""
    return ((PACK_DENSE_WORDS, 128), (PACK_DENSE_WORDS, 256),
            (2 * PACK_DENSE_WORDS, 512))


def decode_layout(n_words: int, fits=None):
    """The first of _decode_layouts whose width holds rows of n_words
    words and whose dense budget a row `fits` accepts (every budget when
    fits is None), or None past the last.  Engine.decode takes it with its
    chunks' budget; StreamingDecoder, which uploads padded rows, with
    none, so that its program is keyed as the Engine's."""
    return next(((dense, width) for dense, width in _decode_layouts()
                 if width >= n_words and (fits is None or fits(dense))),
                None)


def _np_dtype(precision: str):
    if precision not in PRECISIONS:
        raise ValueError(f"unknown precision {precision!r} (f32 or f64)")
    return PRECISIONS[precision]


@lru_cache(maxsize=8)
def engine_consts_np(cfg: CodecConfig, precision: str = "f32") -> dict:
    """The engine's constant tables as numpy arrays, array for array those
    of pactpu.codec.engine.engine_consts_np(cfg, precision): the MDCT basis
    and the psychoacoustic tables in float32 or float64, and the Huffman
    code tables."""
    n = 2 * cfg.n_mdct_lines
    dt = _np_dtype(precision)
    return dict(basis=_mdct_basis_np(n).astype(dt),
                psy=psycho._consts(n, cfg.sample_rate, np.dtype(dt).name),
                tabs=huffman.load_tables())


def consts_from_numpy(consts_np: dict, device) -> dict:
    """Device tensors from an engine_consts_np dict (this package's, or
    pactpu.codec.engine.engine_consts_np's: the same arrays), in the float
    type of its basis.

    Returns dict(basis [N, N/2], psy dict of quiet_i, zvec, bin_bark, mld,
    nonup and the Hann window, tabs tuple of int32 tables)."""
    dt = np.float64 if consts_np["basis"].dtype == np.float64 else np.float32
    t = lambda a, dt: torch.as_tensor(np.asarray(a, dt), device=device)  # noqa: E731
    basis = t(consts_np["basis"], dt)
    quiet_i, zvec, bin_bark, mld, nonup = consts_np["psy"]
    # kernel K4 skips masker ranges by the order of the bark grids
    for name, grid in (("zvec", zvec), ("bin_bark", bin_bark)):
        if not np.all(np.diff(np.asarray(grid, dt)) >= 0):
            raise ValueError(f"psychoacoustic {name} grid must ascend")
    psy = dict(quiet_i=t(quiet_i, dt), zvec=t(zvec, dt),
               bin_bark=t(bin_bark, dt), mld=t(mld, dt), nonup=t(nonup, dt),
               hann=t(hann_window(basis.shape[0]), dt))
    tabs = tuple(t(a, np.int32) for a in consts_np["tabs"])
    return dict(basis=basis, psy=psy, tabs=tabs)


def device_tables(cfg: CodecConfig, device, precision: str = "f32") -> dict:
    """Everything the chunk programs read besides their inputs: the
    constants (consts_from_numpy), the band layout tables
    (psycho.layout_tensors) under "lay", and the analysis window "win", in
    the float type of `precision`."""
    dt = _np_dtype(precision)
    dev = consts_from_numpy(engine_consts_np(cfg, precision), device)
    dev["lay"] = psycho.layout_tensors(cfg.band_layout, device)
    dev["win"] = torch.as_tensor(
        np.asarray(analysis_window(cfg.window, 2 * cfg.n_mdct_lines), dt),
        device=device)
    return dev


def _overlap_frames(y: torch.Tensor, half: int) -> torch.Tensor:
    """[C, (B+1)*half] -> [B, C, 2*half] 50%-overlap frames: frame b is
    [y[b*half:(b+1)*half] ‖ y[(b+1)*half:(b+2)*half]]."""
    c = y.shape[0]
    b = y.shape[1] // half - 1
    first = y[:, :b * half].reshape(c, b, half)
    second = y[:, half:].reshape(c, b, half)
    return torch.cat([first, second], dim=-1).transpose(0, 1)


def frame_blocks(x: torch.Tensor, half: int, n_blocks: int) -> torch.Tensor:
    """[C, n] -> [B, C, 2*half] 50%-overlap frames on x's device, with the
    leading zero priorBlock and the trailing zero flush block (reference
    codec/pacfile.py:264-282, 355-366); B = n_blocks + 1."""
    pad_to = (n_blocks + 1) * half
    return _overlap_frames(F.pad(x, (half, pad_to - x.shape[1])), half)


def frame_blocks_np(pcm: np.ndarray, half: int, b_pad: int) -> np.ndarray:
    """Host framing: int16 [n, C] -> int16 [b_pad, C, 2*half] 50%-overlap
    frames (leading zero priorBlock, zero-padded tail and flush blocks)."""
    c = pcm.shape[1]
    x = np.zeros((c, (b_pad + 1) * half), np.int16)
    n = min(pcm.shape[0], b_pad * half)
    x[:, half:half + n] = pcm[:n].T
    win = sliding_window_view(x, 2 * half, axis=1)[:, ::half, :]
    return np.ascontiguousarray(win[:, :b_pad].transpose(1, 0, 2))


def analyze(cfg: CodecConfig, frames_i16: torch.Tensor, dev: dict) -> dict:
    """Encoder front half (pactpu analyze_body): frames i16[B, C, 2N] ->
    dict(mixed f32[B, C, N], smr f32[B, C, bands], lrms bool[B, bands],
    overall i32[B, C]), float64 where dev's tables are.  Mono takes the
    mono SMRs and no LRMS flags;
    stereo decides L/R vs M/S per band by cfg.ms_decision, the spectral
    intensity rule or the bit-allocation rule (water-filling all four
    codings), and takes the stereo SMRs of the chosen coding."""
    lay, psy = dev["lay"], dev["psy"]
    frames, sw, overall, scaled = _transform(cfg, frames_i16, dev)
    if cfg.n_channels == 1:
        smr = psycho.calc_smrs(sw[:, 0], scaled[:, 0], overall[:, 0], psy,
                               lay, cfg.sample_rate, cfg.peak_mode)[:, None]
        lrms = torch.zeros((frames.shape[0], cfg.n_bands), dtype=torch.bool,
                           device=frames.device)
        return dict(mixed=scaled, smr=smr, lrms=lrms, overall=overall)
    smr_lr, smr_ms, ms_lines = psycho.stereo_smr_pair(
        sw, scaled, overall, psy, lay, cfg.sample_rate, cfg.peak_mode)
    if cfg.ms_decision == "bitalloc":
        lrms = bitalloc.lrms_decision_bitalloc(
            smr_lr, smr_ms, lay["n_lines"], int(cfg.bit_budget()),
            exact.max_mant(cfg), cfg.ms_stop_threshold_db,
            cfg.lr_stop_threshold_db)
    else:
        lrms = psycho.lrms_decision(frames, lay, cfg.ms_decision_factor)
    smr, mixed = psycho.select_coding(smr_lr, smr_ms, scaled, ms_lines, lrms,
                                      lay)
    return dict(mixed=mixed, smr=smr, lrms=lrms, overall=overall)


def _transform(cfg: CodecConfig, frames_i16: torch.Tensor, dev: dict):
    """Window + MDCT and the overall block scale: frames i16[B, C, 2N] ->
    (frames f32, windowed f32[B, C, 2N], overall i32[B, C], lines scaled by
    2^overall f32[B, C, N])."""
    dt = dev["basis"].dtype
    frames = q.pcm16_to_float(frames_i16, dt)
    sw = frames * dev["win"]
    lines = mdct(sw, dev["basis"])
    overall = q.scale_factor(torch.abs(lines).amax(-1), cfg.n_scale_bits, 5)
    return frames, sw, overall, lines * q.exp2i(overall, dt)[..., None]


def payload_rows(out: dict) -> tuple:
    """The payload packer's row fields (bitpack.pack_payload_bits' first
    eight arguments: overall, tid, ba, sf, sign, codes, lens, lrms_row,
    a row a channel-block) of a finalize dict that holds sign, codes and
    lens (pack_words=0)."""
    b, c = out["bits"].shape[:2]
    rows = lambda a: a.reshape(b * c, *a.shape[2:])  # noqa: E731
    return (*(rows(out[k]) for k in ("overall", "tid", "bits", "sf", "sign",
                                     "codes", "lens")),
            out["lrms"].to(torch.int32).repeat_interleave(c, dim=0))


def finalize(cfg: CodecConfig, analysis: dict, extra0: torch.Tensor,
             dev: dict, pack_words: int = PACK_WORDS,
             measure_only: bool = False, return_syms: bool = False) -> dict:
    """Encoder tail (pactpu finalize_body): bit allocation by
    cfg.alloc_mode with the ch0 -> ch1 leftover chain, BFP quantization,
    Huffman table selection, payload packing.

    analysis: the analyze() dict (float32 or float64: the budget's sum
    runs in its type); extra0: f32[B] reservoir extra bits of channel 0.
    measure_only returns just (savings i32[B, C], leftover
    i32[B]), the reservoir measurement.  Otherwise the dict also holds
    overall, lrms, bits, sf, tid and, with pack_words > 0, the packed
    payload words i32[CB, pack_words] (u32 bit patterns) with nbits
    i32[CB]; with pack_words = 0, what the host packer takes instead: sign
    (0 where not transmitted), codes and lens [B, C, N].  return_syms adds
    syms [B, C, N], each line's unsigned mantissa or -1 where it is not
    transmitted (the symbols a Huffman table set is trained on)."""
    lay = dev["lay"]
    half = cfg.n_mdct_lines
    n_lines, seg = lay["n_lines"], lay["seg"]
    max_mant = exact.max_mant(cfg)
    mixed, smr, lrms = analysis["mixed"], analysis["smr"], analysis["lrms"]
    overall = analysis["overall"].to(torch.int32)
    b, c = mixed.shape[0], mixed.shape[1]

    dt = mixed.dtype
    budget = torch.full((), cfg.bit_budget(), dtype=dt, device=mixed.device)
    peak = psycho.band_max(torch.abs(mixed), lay, fill=0.0)
    alloc = _allocator(cfg, peak, overall)
    extra = extra0.to(dt)
    bits_ch = []
    for ch in range(c):
        total = (budget + extra).to(torch.int32)       # truncates, as int()
        if alloc is None:
            bits_c, left = bitalloc.water_fill(
                total, max_mant, n_lines, smr[:, ch], lrms,
                cfg.ms_stop_threshold_db, cfg.lr_stop_threshold_db)
        else:
            bits_c = alloc(total, smr[:, ch], ch)
            left = total - (bits_c * n_lines).sum(-1).to(torch.int32)
        bits_ch.append(bits_c)
        extra = left.to(dt)
    bits = torch.stack(bits_ch, dim=1)                  # [B, C, bands]

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

    out = dict(overall=overall, lrms=lrms, bits=bits, sf=sf,
               tid=tid.reshape(b, c), savings=savings, leftover=left)
    fields = dict(sign=torch.where(transmit, sign, 0),
                  codes=codes.reshape(b, c, half),
                  lens=lens.reshape(b, c, half))
    if pack_words:
        out["words"], out["nbits"] = bitpack.pack_payload_bits(
            *payload_rows({**out, **fields}), cfg.band_layout.n_lines,
            cfg.n_scale_bits, cfg.n_mant_size_bits, cfg.n_table_id_bits,
            pack_words)
    else:
        out.update(fields)
    if return_syms:
        out["syms"] = torch.where(transmit, unsigned, -1)
    return out


def _allocator(cfg: CodecConfig, peak: torch.Tensor, overall: torch.Tensor):
    """The allocator of cfg.alloc_mode other than water-filling, as
    fn(total i32[B], smr [B, bands], channel) -> bits i32[B, bands]
    (pactpu/codec/engine.py:248-283); None for water_fill, which also
    returns its own leftover.  The legacy allocators' loop bound is
    pactpu's 4 x the budget: with the channel chain a channel's budget
    stays below it in practice.  const_snr allocates on the per-band peak
    SPL of the coded lines, SPL(4 X^2) - 6.02 overall, in the engine's
    type (reference BitAllocConstSNR's peakSPL)."""
    mode = cfg.alloc_mode
    if mode == "water_fill":
        return None
    max_mant = exact.max_mant(cfg)
    n_lines = cfg.band_layout.n_lines
    legacy_cap = int(4 * max(float(cfg.bit_budget()), 1))
    if mode == "closed_form":
        return lambda total, smr, ch: bitalloc.alloc_closed_form(
            total, max_mant, n_lines, smr)
    if mode == "uniform":
        return lambda total, smr, ch: bitalloc.alloc_uniform_batch(
            total, max_mant, n_lines, legacy_cap)
    if mode == "const_mnr":
        return lambda total, smr, ch: bitalloc.alloc_const_mnr_batch(
            total, max_mant, n_lines, smr, legacy_cap)
    peak_spl = (psycho.spl(4.0 * peak * peak)
                - 6.02 * overall[..., None].to(peak.dtype))
    return lambda total, smr, ch: bitalloc.alloc_const_snr_batch(
        total, max_mant, n_lines, peak_spl[:, ch], legacy_cap)


def encode_baseline(cfg: CodecConfig, frames_i16: torch.Tensor,
                    dev: dict) -> dict:
    """The baseline .pac encode (pactpu encode_body_baseline; reference
    codec/solution/codec_.py:69-148): independent channels, the mono SMRs
    of every channel-block, then finalize_baseline.  frames i16[B, C, 2N]
    -> the finalize_baseline dict."""
    half = cfg.n_mdct_lines
    _, sw, overall, scaled = _transform(cfg, frames_i16, dev)
    b, c = overall.shape
    smr = psycho.calc_smrs(sw.reshape(b * c, -1), scaled.reshape(b * c, half),
                           overall.reshape(-1), dev["psy"], dev["lay"],
                           cfg.sample_rate, cfg.peak_mode)
    return finalize_baseline(cfg, scaled, overall, smr.reshape(b, c, -1), dev)


def finalize_baseline(cfg: CodecConfig, scaled: torch.Tensor,
                      overall: torch.Tensor, smr: torch.Tensor,
                      dev: dict) -> dict:
    """The baseline encoder's tail: water-filling (kernel K2, no
    L/R-vs-M/S stop rule: every flag false, no channel chain) under the
    budget without the table id field, raw BFP mantissas, no Huffman
    coding and no reservoir.

    scaled f32[B, C, N] lines scaled by 2^overall; overall i32[B, C];
    smr f32[B, C, bands].  Returns dict(overall i32[B, C], bits
    i32[B, C, bands], sf i32[B, C, bands], mant i32[B, C, N]: each line's
    bits[band]-bit sign-magnitude code, 0 where its band has no bits)."""
    lay = dev["lay"]
    b, c, n_bands = smr.shape
    # the baseline budget has no Huffman table id field
    # (reference solution/codec_.py:84-87)
    budget = (cfg.target_bits_per_sample * cfg.n_mdct_lines
              - cfg.n_scale_bits * (n_bands + 1)
              - cfg.n_mant_size_bits * n_bands)
    smr = smr.reshape(b * c, n_bands)
    bits, _ = bitalloc.water_fill(
        torch.full((b * c,), int(budget), dtype=torch.int32,
                   device=smr.device), exact.max_mant(cfg), lay["n_lines"],
        smr, torch.zeros_like(smr, dtype=torch.bool),
        cfg.ms_stop_threshold_db, cfg.lr_stop_threshold_db)
    bits = bits.reshape(b, c, n_bands)
    peak = psycho.band_max(torch.abs(scaled), lay, fill=0.0)
    sf = q.scale_factor(peak, cfg.n_scale_bits, bits)
    nm_l = bits[..., lay["seg"]]
    mant = q.bfp_mantissa(scaled, sf[..., lay["seg"]], cfg.n_scale_bits, nm_l)
    return dict(overall=overall.to(torch.int32), bits=bits, sf=sf,
                mant=torch.where(nm_l > 0, mant, 0))


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

    ba/sf: i32[B, C, bands]; mant: i32[B, C, N]; overall: i32[B, C];
    lrms: bool[B, bands] (read for stereo only).  Returns f32[B, C, 2N]
    (float64 where dev's tables are)."""
    dt = dev["basis"].dtype
    seg = dev["lay"]["seg"]
    nm_l = ba[..., seg]
    vals = q.bfp_dequantize(sf[..., seg], mant, cfg.n_scale_bits, nm_l, dt)
    lines = vals * q.exp2i(-overall, dt)[..., None]
    if cfg.n_channels == 2:
        # Q1 aliasing: the reference decoder emits L' = M - S, R' = M
        # (reference codec/codec.py:46-56)
        line_ms = lrms[:, seg]
        m, s = lines[:, 0], lines[:, 1]
        lines = torch.stack([torch.where(line_ms, m - s, m),
                             torch.where(line_ms, m, s)], dim=1)
    return imdct(lines, dev["basis"]) * dev["win"]


def decode_chunk(cfg: CodecConfig, ba, sf, words, overall, lrms, carry,
                 dev: dict):
    """One chunk of synthesis + overlap-add + 16-bit conversion.

    ba/sf: int[B, C, bands]; words: i32[C B, W] repacked mantissa rows;
    overall: int[B, C]; lrms: bool[B, bands]; carry: f32[C, N], the
    second half of the previous chunk's last frame (the decoder's
    overlap-add state, reference codec/pacfile.py:223-226).
    Returns (pcm i16[B, C, N], carry')."""
    return _overlap_add(synthesize(cfg, ba, sf, words, overall, lrms, dev),
                        carry)


def synthesize(cfg: CodecConfig, ba, sf, words, overall, lrms,
               dev: dict) -> torch.Tensor:
    """The codes of the repacked mantissa rows (kernel K1), then
    decode_body: arguments as decode_chunk's; returns the pre-overlap
    blocks f32[B, C, 2N]."""
    half = cfg.n_mdct_lines
    b, c = ba.shape[0], ba.shape[1]
    ba = ba.to(torch.int32)
    off, width, _ = _line_bit_offsets(ba.reshape(b * c, -1), dev["lay"])
    mant = kernels.extract_codes(words, off, width).reshape(b, c, half)
    return decode_body(cfg, ba, sf.to(torch.int32), mant,
                       overall.to(torch.int32), lrms, dev)


def _overlap_add(td: torch.Tensor, carry: torch.Tensor):
    """Pre-overlap blocks f32[B, C, 2N] and the previous chunk's carry
    f32[C, N] -> (pcm i16[B, C, N], carry')."""
    half = td.shape[-1] // 2
    first, second = td[..., :half], td[..., half:]
    prev_second = torch.cat([carry[None], second[:-1]], dim=0)
    return q.float_to_pcm16(prev_second + first), second[-1]


def interleaved_rows(chunks: list, lo: int, hi: int) -> list:
    """The decoded PCM's layout: rows [lo, hi) of successive chunks' i16[B,
    C, N] blocks as [n, N, C] views (channels interleaved), one a chunk
    that holds some, on its device.  Joined (torch.cat on one device, the
    host past a download a device) they read as int16 [n N, C]."""
    parts, at = [], 0
    for p in chunks:
        a, z = max(lo - at, 0), min(hi - at, p.shape[0])
        if a < z:
            parts.append(p[a:z].permute(0, 2, 1))
        at += p.shape[0]
    return parts


def assemble_flat(dense, nbits: np.ndarray, width: int) -> bytes:
    """The framed payload of rows packed back to back in dense (a host
    array, or a device tensor of which only their words download) by
    bitpack.compact_rows: ceil(nbits / 32) words a row, at most width."""
    counts = np.minimum((nbits.astype(np.int64) + 31) // 32, width)
    flat = dense[:int(counts.sum())]
    if torch.is_tensor(flat):
        flat = _host_u32(flat)
    return native.assemble_rows_flat(
        flat, (np.cumsum(counts) - counts).astype(np.int32), nbits)


def payload_decode_chunk(cfg: CodecConfig, words, nbits, carry, dev: dict,
                         lut: Optional[dict]):
    """One chunk of the device-parse route (pactpu
    _chunk_decode_payload_fn): payload_synthesize, then overlap-add and
    16-bit conversion.  Returns (pcm i16[B, C, N], carry', bad bool[C B])."""
    td, bad = payload_synthesize(cfg, words, nbits, dev, lut)
    return (*_overlap_add(td, carry), bad)


def payload_synthesize(cfg: CodecConfig, words, nbits, dev: dict,
                       lut: Optional[dict]):
    """Parse of raw payload rows and synthesis.  With the walk LUT (.wak)
    the parse is the Huffman bit-walk (kernel K5, then K1 for signs and
    LRMS flags); with lut None it is the baseline .pac layout (K1 alone).

    words: i32[C B, W] payload rows; nbits: i32[C B].  Returns the
    pre-overlap blocks f32[B, C, 2N] and bad bool[C B]."""
    c, half = cfg.n_channels, cfg.n_mdct_lines
    if lut is None:
        p = hd.parse_rows_raw(cfg, words, nbits, dev["lay"])
    else:
        rec = kernels.huffman_walk(
            words, lut, cfg.band_layout.n_lines, cfg.n_scale_bits,
            cfg.n_mant_size_bits, cfg.n_table_id_bits)
        p = hd.parse_post(rec, words, nbits, dev["lay"])
    b = words.shape[0] // c
    # a block's LRMS flags are its last channel's row
    return decode_body(cfg, p["ba"].reshape(b, c, -1),
                       p["sf"].reshape(b, c, -1),
                       p["mant"].reshape(b, c, half),
                       p["overall"].reshape(b, c),
                       p["lrms"].reshape(b, c, -1)[:, -1] != 0, dev), p["bad"]


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


def _default_batches(b: int) -> list:
    """The default chunking of a b-block file: the batches the encoder's
    analysis runs in."""
    return _chunk_sizes(b, _pad_blocks(b))


def _recut(parts: list, counts: list, offs: list) -> list:
    """Dicts of per-block tensors for consecutive batches of counts[k]
    blocks, re-cut into the chunks [offs[i], offs[i + 1]): views where a
    chunk lies in one batch, joined where it spans several."""
    starts = _offsets(counts)
    out = []
    for lo, hi in zip(offs[:-1], offs[1:]):
        cut = [(p, max(lo, s) - s, min(hi, e) - s)
               for p, s, e in zip(parts, starts[:-1], starts[1:])
               if s < hi and e > lo]
        out.append({key: cut[0][0][key][cut[0][1]:cut[0][2]] if len(cut) == 1
                    else torch.cat([p[key][a:z] for p, a, z in cut])
                    for key in parts[0]})
    return out


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
                     divisor: int, deposit: int = 0, extra: int = 0):
    """Host replay of the reference reservoir policy over per-block pass-1
    measurements: deposit per-channel savings, withdraw 1/divisor per block
    (reference codec/Huffman.py:353-371), carry allocation leftovers
    (codec/codec.py:229,258-260).  savings: int[B, C]; leftover: int[B];
    (deposit, extra): the carry from the blocks before (a stream's).
    Returns (extraBits of channel 0 per block int64[B], final (deposit,
    extra) carry).  The Engine runs the same policy on the device (kernel
    K11, kernels.reservoir_scan); the cluster's ranges replay it here, as
    pactpu's do."""
    b = savings.shape[0]
    extras = np.zeros(b, np.int64)
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


class EncodeStats(dict):
    """One encode's statistics by name (savings; extras; in the reservoir
    mode measure_savings and measure_leftover): device tensors until first
    read, then host arrays of the file's b blocks."""

    def __init__(self, b: int = 0):
        super().__init__()
        self.b = b

    def host(self, key: str):
        v = self.get(key)
        if v is not None and not isinstance(v, np.ndarray):
            v = self[key] = v.cpu().numpy()[:self.b]
        return v

    @property
    def extras(self):
        """Channel 0's extra bits of each block."""
        return self.host("extras")

    @property
    def measure(self):
        """(savings [b, C], leftover [b]) of the reservoir's measurement
        pass (extra bits 0); None in the other rate modes."""
        if self.get("measure_savings") is None:
            return None
        return self.host("measure_savings"), self.host("measure_leftover")


def resolve_device(device, who: str = "Engine") -> torch.device:
    """torch.device(device), raising where it names CUDA and there is no
    card: every entry point of the port runs on the card unless the caller
    asks for the CPU.  A CUDA device without an index is the current
    device now ("cuda" -> "cuda:<current>"), so that every table, stream,
    pool and program of an Engine lives on one device whatever is current
    later."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"{who}(device={str(device)!r}): no CUDA "
                               "device")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def _full_fp32() -> None:
    """Float32 matrix products and convolutions in full float32 (no TF32),
    the counterpart of the reference's Precision.HIGHEST."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def _download(t) -> np.ndarray:
    """A tensor (or a list of them, joined) on the host, as numpy: the span
    "download" (bytes; pinned: whether the host copy is page-locked)."""
    with span("download") as sp:
        h = (torch.cat(t) if isinstance(t, list) else t).cpu()
        if sp is not None:
            sp.counts.update(bytes=h.nbytes, pinned=int(h.is_pinned()))
        return h.numpy()


def _copied(out: np.ndarray, src: np.ndarray) -> int:
    """The bytes the host copied to make `out` from `src`: 0 for a view."""
    return 0 if np.may_share_memory(out, src) else out.nbytes


def _host_u32(t) -> np.ndarray:
    """Download an int32 tensor (or a list of them, joined) of u32 bit
    patterns as numpy uint32."""
    return _download(t).view(np.uint32)


class Engine:
    """File-level encoder/decoder of .wak and .pac streams on one torch
    device.

    The positional arguments are pactpu's, in its order (`Engine(cfg,
    "cbr")`); device and decode_parse, which pactpu has not, are
    keyword-only.  device: where the chunk programs run ("cuda",
    "cuda:0", "cpu"); the default is the card, and without one the
    constructor raises: the CPU is used only when asked for.  On a CUDA
    device the kernels run as hand-written CUDA; on the CPU their plain
    versions run.  fmt="wak" is the full coder (Huffman, M/S,
    reservoir); fmt="pac" the baseline coder (independent channels, raw
    mantissas, no reservoir: rate_mode makes no difference to it), whose
    streams carry nothing that tells them apart: the engine's fmt decides
    how a stream is read.  The decoder takes a
    stream's sample rate, channels and band layout from its header; a
    stream carries no window: synthesis uses the engine's cfg.window.
    Assigning cfg checks the new config as the constructor does and drops
    the device tables of the old one.  chunk_blocks
    fixes the batch size of the rate control, the final pass and the
    decode (None = adapt up to DEFAULT_CHUNK_BLOCKS); the encode's
    analysis runs in the default batches whatever it is, so the bytes do
    not depend on it.
    decode_parse places the decoder's parse: "host" (native runtime),
    "device" (on the raw payload: kernel K5 for .wak, K1 for .pac) or
    "auto" (= host: the native runtime is always there); None reads
    PACTPU_DECODE_PARSE (default auto).  precision "f32" or "f64" is the
    float type of every stage (the .pac encode stays float32);
    rate_mode="exact" is the reference's serial reservoir (kernel K7), and
    with "f64" the reference's serial encode byte for byte.  tables is a
    Huffman table set (a path or a 4-tuple, _check_tables; None = the
    shipped set) for the encoder, both parse routes and K5's walk LUT;
    device_pack=False packs the payload on the host (the same bytes, no
    K3); debug_checks=True checks every encode pass as pactpu does
    (DebugCheckError).  last_savings, last_measure and last_extras read
    the last encode's statistics.  use_programs (True) lets the stages run
    as CUDA-graph replays on the card (pactpu_torch.codec.programs); False
    runs them launch by launch, the same bytes and samples."""

    def __init__(self, cfg: Optional[CodecConfig] = None,
                 rate_mode: str = "reservoir", fmt: str = "wak",
                 chunk_blocks: Optional[int] = None,
                 device_pack: Optional[bool] = None,
                 precision: str = "f32", debug_checks: bool = False,
                 tables=None, *, device="cuda",
                 decode_parse: Optional[str] = None):
        if rate_mode not in ("cbr", "reservoir", "exact"):
            raise ValueError(f"unknown rate mode {rate_mode!r}")
        if fmt not in ("wak", "pac"):
            raise ValueError(f"unknown format {fmt!r}")
        if fmt == "pac" and rate_mode == "exact":
            raise ValueError("the baseline .pac coder has no reservoir")
        _np_dtype(precision)                          # validate
        if decode_parse is None:
            decode_parse = os.environ.get("PACTPU_DECODE_PARSE", "auto")
        if decode_parse not in ("auto", "device", "host"):
            raise ValueError(f"PACTPU_DECODE_PARSE={decode_parse!r}: "
                             "expected auto, device or host")
        self.device = resolve_device(device)
        # the chunk programs of the card (programs.encode_programs and
        # decode_programs say which configurations take them); with
        # use_programs False every stage runs launch by launch
        self.programs = programs.Programs(self.device)
        self.use_programs = True
        self.rate_mode = rate_mode
        self.cfg = cfg or CodecConfig()
        self.fmt = fmt
        self.precision = precision
        self.chunk_blocks = chunk_blocks
        self.decode_parse = decode_parse
        self.tables = _check_tables(tables)
        # False: every chunk's payload is packed on the host (native
        # pack_file), no K3 launch, the same bytes
        self.device_pack = device_pack is not False
        self.debug_checks = debug_checks
        # what last_savings / last_measure / last_extras read, and of
        # encode_many each file's (last_many): device tensors until first
        # read (the encode does not wait for them)
        self._last = EncodeStats()
        self.last_many: list = []
        _full_fp32()

    @property
    def cfg(self) -> CodecConfig:
        return self._cfg

    @cfg.setter
    def cfg(self, cfg: CodecConfig) -> None:
        """Replacing the config (the CLI adapts an engine to its input's
        sample rate and channel count) checks it against the engine's rate
        mode as the constructor does, and drops the device tables derived
        from the old one (pactpu/codec/engine.py:926-960)."""
        _check_config(cfg, self.rate_mode)
        self._cfg = cfg
        self._dev = {}
        self.programs.clear()

    def consts(self, precision: Optional[str] = None,
               cfg: Optional[CodecConfig] = None) -> dict:
        """Device-resident constant tables in the engine's precision (or
        the one named), with the engine's Huffman table set, uploaded once
        per Engine and configuration.  cfg: a stream's header config, for
        the decoder: its MDCT size, sample rate and band layout with the
        engine's window (a stream carries none); None = the engine's."""
        precision = precision or self.precision
        cfg = self.cfg if cfg is None else replace(cfg,
                                                   window=self.cfg.window)
        key = (precision, cfg.n_mdct_lines, cfg.sample_rate,
               cfg.band_layout.n_lines, cfg.window)
        if key not in self._dev:
            dev = device_tables(cfg, self.device, precision)
            if self.tables is not None:
                dev["tabs"] = tuple(torch.as_tensor(t, device=self.device)
                                    for t in self.tables)
            self._dev[key] = dev
        return self._dev[key]

    @property
    def last_savings(self):
        """Huffman bits saved by the last encode (the reference program's
        bits-saved readout, pacfile.py:439), summed over its blocks;
        fetched at first read.  None before a .wak encode."""
        v = self._last.host("savings")
        return None if v is None else int(v.sum())

    @property
    def last_measure(self):
        """(savings [b, C], leftover [b]) of the last reservoir-mode
        encode's measurement pass (extra bits 0), the numbers the reservoir
        replay ran on; None in the other rate modes.  Fetched at first
        read."""
        return self._last.measure

    @property
    def last_extras(self):
        """Channel 0's extra bits of each block of the last encode (any
        rate mode), fetched at first read."""
        return self._last.extras

    def _chunk(self, b: int) -> int:
        return self.chunk_blocks or _pad_blocks(b)

    def _run_stage(self, stage: str, programmed: bool, blocks: int,
                   key: tuple, fn, args):
        """fn(*args), one stage of a chunk of `blocks` blocks: a replay of
        the stage's program where `programmed` (programs.encode_programs,
        decode_programs or shard_programs) and the chunk has the size of
        one of _TAIL_BUCKETS (a chunk_blocks of another size, and a batch
        past the default chunking, run directly), else fn on args uploaded
        to the device.
        key: what besides the inputs' shapes decides the stage (fn reads
        nothing else); args: tensors or host arrays."""
        if programmed and blocks in _TAIL_BUCKETS:
            host = [torch.from_numpy(np.ascontiguousarray(a))
                    if isinstance(a, np.ndarray) else a for a in args]
            return self.programs.run(stage, (self.precision, *key), fn, host,
                                     blocks=blocks)
        with span("direct:" + stage, blocks=blocks):
            return fn(*(self._upload(a) for a in args))

    def _exact_run(self):
        """The runner of exact.exact_extras_chunked's stages, "cost" (K10)
        and "exact_scan" (K7): each through its program where
        programs.encode_programs says so (_run_stage)."""
        routes, cfg = programs.encode_programs(self), self.cfg

        def run(stage, fn, args):
            return self._run_stage(stage, routes[stage], args[0].shape[0],
                                   (cfg,), fn, args)
        return run

    def _device_carry(self, carry) -> torch.Tensor:
        """A (bitDeposit, extraBits) carry as an i32[2] tensor on the
        device: a tensor as it is, host ints written by fills (a host value
        copied up would wait for the device)."""
        if torch.is_tensor(carry):
            return carry.to(device=self.device, dtype=torch.int32)
        out = torch.full((2,), int(carry[0]), dtype=torch.int32,
                         device=self.device)
        out[1].fill_(int(carry[1]))
        return out

    # -- encode ----------------------------------------------------------

    def _upload_pcm(self, pcm: np.ndarray, batches) -> dict:
        """Upload the PCM once, framed for batches(b), a list of block
        counts (zero frames past the file).  Returns dict(b: the file's
        block count, the flush block included; sizes: the chunks' block
        counts; offs: the batches' block offsets; pcm: i16[C, (n + 1) N]
        on the device).  The span "upload" covers the framing and the
        copy."""
        half = self.cfg.n_mdct_lines
        c = self.cfg.n_channels
        if pcm.ndim != 2 or pcm.shape[1] != c:
            raise ValueError(f"pcm must be [n, {c}] int16, got {pcm.shape}")
        b = self._blocks(pcm)
        sizes = _chunk_sizes(b, self._chunk(b))
        offs = _offsets(batches(b))
        b_pad = offs[-1]
        with span("upload") as sp:
            glob = np.zeros((c, (b_pad + 1) * half), np.int16)
            n = min(pcm.shape[0], b_pad * half)
            glob[:, half:half + n] = pcm[:n].T
            src = torch.from_numpy(glob)
            if sp is not None:
                sp.counts.update(bytes=src.nbytes,
                                 pinned=int(src.is_pinned()))
            return dict(b=b, sizes=sizes, offs=offs,
                        pcm=src.to(self.device))

    def _frames(self, pcm: np.ndarray, batches):
        """Upload the PCM once and cut it into batches of overlapped frames.
        Returns (b, sizes, frames): as _upload_pcm, with the frames
        i16[n, C, 2N] on the device of each batch of batches(b)."""
        up = self._upload_pcm(pcm, batches)
        half, offs = self.cfg.n_mdct_lines, up["offs"]
        return up["b"], up["sizes"], [_overlap_frames(
            up["pcm"][:, offs[k] * half:(offs[k + 1] + 1) * half], half)
            for k in range(len(offs) - 1)]

    def _analysis_batches(self, b: int) -> list:
        """The batches the encode's analysis runs in (_analyze)."""
        own = _default_batches(b)
        rest = sum(_chunk_sizes(b, self._chunk(b))) - sum(own)
        return own + ([rest] if rest > 0 else [])

    def _analyze(self, pcm: np.ndarray):
        """Upload the PCM and analyse it.  Returns (b, sizes, analyses):
        as _frames, with the analysis dict of each chunk."""
        up = self._upload_pcm(pcm, self._analysis_batches)
        return up["b"], up["sizes"], self._analyze_uploaded(up)

    def _analyze_uploaded(self, up: dict) -> list:
        """The analysis dict of each chunk of an _upload_pcm result.

        The analysis runs in the batches of the default chunking, whatever
        chunk_blocks is, and the chunks are cut from them: cuBLAS and cuFFT
        pick their kernels by batch size, so a block's float32 lines and
        SMRs would otherwise depend on the chunk size, and so would the
        exact mode's stream.  Blocks past the default chunking's padding,
        which a larger chunk size adds, are all zero frames: they take a
        batch of their own.  The span "analyze" counts the rows analysed
        and the real ones (the file's blocks)."""
        cfg, dev = self.cfg, self.consts()
        half, offs = cfg.n_mdct_lines, up["offs"]
        programmed = programs.encode_programs(self)["analyze"]

        def stage(x):
            return analyze(cfg, _overlap_frames(x, half), dev)

        with span("analyze", rows=offs[-1], real_rows=up["b"]):
            parts = [self._run_stage(
                "analyze", programmed, offs[k + 1] - offs[k], (cfg,), stage,
                (up["pcm"][:, offs[k] * half:(offs[k + 1] + 1) * half],))
                for k in range(len(offs) - 1)]
            return _recut(parts, [z - a for a, z in zip(offs, offs[1:])],
                          _offsets(up["sizes"]))

    def _encode_chunks(self, pcm: np.ndarray) -> dict:
        """Upload the PCM once, run the analysis (_analyze) and the rate
        control (_rate_control) chunk by chunk, and stage the dense payload
        download."""
        return self._encode_dispatch(
            self._upload_pcm(pcm, self._analysis_batches))

    def _encode_dispatch(self, up: dict) -> dict:
        """The device half of an encode from its uploaded PCM (an
        _upload_pcm result): every chunk's analysis, rate control, final
        pass and compaction queued, nothing waited for.  In the reservoir
        and cbr modes on the card no host sync and no device-to-host copy
        happens here."""
        return self._rate_control(self._analyze_uploaded(up), up["b"],
                                  up["sizes"])[0]

    def _rate_control(self, analyses: list, b: int, sizes: list,
                      carry=(0, 0)):
        """Both reservoir passes, or the exact scan, over the analysis
        dicts of consecutive chunks of sizes[k] blocks (the first b real),
        from the (bitDeposit, extraBits) carry of the blocks before them
        (host ints or an i32[2] device tensor); then the final pass and the
        staged download (_stage_payload).  The reservoir chains the
        measurement pass of each chunk into kernel K11 (kernels.
        reservoir_scan) with the carry on the device, as the exact scan
        chains K7: no host round trip.  Returns (staged, carry'): carry'
        an i32[2] device tensor (read it after the download), in cbr the
        carry unchanged.  The span "rate" covers the passes before the
        final one."""
        with span("rate", chunks=len(sizes)):
            extras_chunks, carry = self._extras(analyses, b, sizes, carry)
        return self._stage_payload(analyses, extras_chunks, b, sizes), carry

    def _extras(self, analyses: list, b: int, sizes: list, carry):
        """Each chunk's extra bits and the carry after them
        (_rate_control)."""
        cfg = self.cfg
        offs = _offsets(sizes)
        dev = self.consts()
        self._last = EncodeStats(b)

        if self.rate_mode == "exact":
            extras_chunks, carry = exact.exact_extras_chunked(
                cfg, analyses, dev, b, self._device_carry(carry),
                self._exact_run())
        elif self.rate_mode == "cbr":
            extras_chunks = [torch.zeros(s, device=self.device)
                             for s in sizes]
        else:
            programmed = programs.encode_programs(self)["measure"]
            divisor = cfg.reservoir_withdraw_divisor
            carry = self._device_carry(carry)

            def stage(mixed, smr, lrms, overall, carry, valid):
                m = finalize(cfg, dict(mixed=mixed, smr=smr, lrms=lrms,
                                       overall=overall),
                             torch.zeros(mixed.shape[0],
                                         device=mixed.device),
                             dev, measure_only=True)
                ex, carry = kernels.reservoir_scan(
                    m["savings"], m["leftover"], valid, carry, divisor)
                return m["savings"], m["leftover"], ex, carry

            extras_chunks, meas = [], []
            for k, a in enumerate(analyses):
                # padded tail blocks take no part: their extras stay 0
                valid = (torch.arange(sizes[k], device=self.device)
                         < max(0, b - offs[k]))
                sav, left, ex, carry = self._run_stage(
                    "measure", programmed, sizes[k], (cfg,), stage,
                    (*(a[key] for key in _ANALYSIS_KEYS), carry, valid))
                extras_chunks.append(ex)
                meas.append((sav, left))
            self._last.update(
                measure_savings=torch.cat([m[0] for m in meas]),
                measure_leftover=torch.cat([m[1] for m in meas]))
        self._last["extras"] = torch.cat(extras_chunks)
        return extras_chunks, carry

    def _stage_payload(self, analyses, extras_chunks, b: int,
                       sizes: list) -> dict:
        """The final pass of every chunk with its extra bits (Engine(
        debug_checks=True) checks it here), and the staged download: each
        chunk's payload rows compacted by their word counts (device
        packing, `dense`), or the fields the host packer takes
        (device_pack=False).  The span "final" counts the rows, the real
        ones and the packer's words a row (pack_widths; 0 unpacked)."""
        cfg, dev = self.cfg, self.consts()
        c = cfg.n_channels
        pack_words, dense = pack_widths(cfg)
        if not self.device_pack:
            pack_words = 0
        programmed = programs.encode_programs(self)["final"]

        def stage(mixed, smr, lrms, overall, extras):
            out = finalize(cfg, dict(mixed=mixed, smr=smr, lrms=lrms,
                                     overall=overall), extras, dev,
                           pack_words=pack_words)
            if pack_words:
                out["dense"] = bitpack.compact_rows(
                    out["words"], out["nbits"], mixed.shape[0] * c * dense)
            return out

        with span("final") as sp:
            if sp is not None:
                sp.counts.update(rows=sum(sizes), real_rows=b,
                                 words=pack_words)
            outs = [self._run_stage("final", programmed, size,
                                    (cfg, pack_words), stage,
                                    (*(a[k] for k in _ANALYSIS_KEYS), ex))
                    for a, ex, size in zip(analyses, extras_chunks, sizes)]
            if self.debug_checks:
                _debug_check_encode(analyses, outs, exact.max_mant(cfg),
                                    sizes)
        st = dict(outs=outs, b=b, analyses=analyses, extras=extras_chunks,
                  sizes=sizes)
        if self.device_pack:
            st["dense"] = [o.pop("dense") for o in outs]
        return st

    def _host_pack(self, st: dict, header: bytes = b"") -> bytes:
        """header and the payload of a device_pack=False encode: the
        download of every chunk's fields, then the native serializer
        (pack_payload, the span "frame")."""
        b = st["b"]
        out = {k: _download(torch.cat([o[k] for o in st["outs"]])[:b])
               for k in ("overall", "tid", "bits", "sf", "sign", "codes",
                         "lens", "lrms")}
        with span("frame") as sp:
            data = self.pack_payload(out, b)
            if sp is not None:
                sp.counts.update(bytes_out=len(data), wide=0, padded=0)
            return header + data

    def pack_payload(self, out: dict, b: int) -> bytes:
        """The .wak payload of the first b blocks of encode_arrays' host
        arrays (pactpu's pack_payload): the device-packed rows framed on
        the host, or without them the native serializer on the fields.  A
        packed row wider than its words raises (encode packs such a chunk
        again, wider)."""
        cfg = self.cfg
        c = cfg.n_channels
        if "words" in out:
            words = np.ascontiguousarray(out["words"][:c * b]).view(np.uint32)
            nbits = np.ascontiguousarray(out["nbits"][:c * b], np.int32)
            if -(-int(nbits.max(initial=0)) // 32) > words.shape[1]:
                raise ValueError("a payload row is wider than its packed "
                                 "words; Engine.encode packs it wider")
            return native.assemble_rows(words, nbits)
        r2 = lambda a: a[:b].reshape(c * b, *a.shape[2:])  # noqa: E731
        return native.pack_file(
            np.asarray(cfg.band_layout.n_lines, np.int32), cfg.n_scale_bits,
            cfg.n_mant_size_bits, cfg.n_table_id_bits, r2(out["overall"]),
            r2(out["tid"]), r2(out["bits"]), r2(out["sf"]), r2(out["sign"]),
            r2(out["codes"]), r2(out["lens"]),
            np.asarray(out["lrms"][:b], np.int32), n_channels=c)

    def _finish_encode(self, st: dict, header: bytes = b"") -> bytes:
        """Blocking half of an encode: ONE download of every chunk's dense
        payload (rows compacted by their word counts, nbits appended), then
        host framing (or, with device_pack=False, _host_pack).  Fallbacks:
        a chunk whose rows overflow the packer's width (pack_widths) is
        re-finalized at PACK_WORDS_MAX, launch by launch; a chunk whose
        dense total passes its cap downloads its padded rows instead.
        header (a stream's) goes in front of the payload.  Spans:
        "download" (the dense download), then "frame" (the framing; the
        payload's bytes, the chunks re-finalized wide and the chunks that
        took their padded rows)."""
        cfg = self.cfg
        c = cfg.n_channels
        outs, b, sizes = st["outs"], st["b"], st["sizes"]
        self._last["savings"] = torch.cat([o["savings"] for o in outs])
        if not self.device_pack:
            return self._host_pack(st, header)
        width = outs[0]["words"].shape[1]
        dense = pack_widths(cfg)[1]
        dn = _host_u32(st["dense"])
        with span("frame") as sp:
            chunks, pos = [], 0
            for size in sizes:
                rows = size * c
                cap = rows * dense
                nbits = dn[pos + cap:pos + cap + rows].astype(np.int32)
                counts = np.minimum((nbits.astype(np.int64) + 31) // 32, width)
                flat = dn[pos:pos + cap] if int(counts.sum()) <= cap else None
                chunks.append((flat, nbits))
                pos += cap + rows
            padded = [k for k, (flat, _) in enumerate(chunks)
                      if flat is None and sum(sizes[:k]) < b]
            if padded:
                words = _host_u32([outs[k]["words"] for k in padded])
                padded = dict(zip(padded, np.split(
                    words, np.cumsum([sizes[k] * c for k in padded])[:-1])))
            parts = []
            done = wide = 0
            for k, (a, ex) in enumerate(zip(st["analyses"], st["extras"])):
                nb = min(sizes[k], b - done)
                if nb <= 0:
                    break
                flat, nbits = chunks[k]
                nb_rows = nbits[:c * nb]
                need = -(-int(nb_rows.max(initial=0)) // 32)
                if need > width:
                    if need > PACK_WORDS_MAX:
                        raise ValueError(
                            f"a payload row needs {need} words, past the "
                            f"{PACK_WORDS_MAX}-word packer")
                    wout = finalize(cfg, a, ex, self.consts(),
                                    pack_words=PACK_WORDS_MAX)
                    parts.append(native.assemble_rows(
                        _host_u32(wout["words"][:c * nb]),
                        _download(wout["nbits"][:c * nb])))
                    wide += 1
                elif flat is not None:
                    parts.append(assemble_flat(flat, nb_rows, width))
                else:
                    parts.append(native.assemble_rows(padded[k][:c * nb],
                                                      nb_rows))
                done += nb
            if sp is not None:
                sp.counts.update(bytes_out=sum(map(len, parts)), wide=wide,
                                 padded=len(padded))
            return b"".join([header, *parts])

    def _encode_baseline(self, pcm: np.ndarray, header: bytes = b"") -> bytes:
        """The .pac payload: the PCM uploaded once, encode_baseline batch
        by batch (the default chunking's, whatever chunk_blocks is: no
        rate control spans them, and the bytes do not depend on it, as in
        _analyze), then _baseline_finish, header in front."""
        return self._baseline_finish(self._baseline_dispatch(
            self._upload_pcm(pcm, _default_batches)), header)

    def _baseline_dispatch(self, up: dict) -> dict:
        """The device half of a .pac encode from its uploaded PCM (an
        _upload_pcm result of the default batches): each batch's
        encode_baseline, in float32 as pactpu, as one program (stage
        "baseline", pactpu's _encode_baseline_fn) where
        programs.encode_programs says so, and every batch's side info and
        mantissas joined for one download; nothing waited for.  Returns
        dict(b, host: i32[b C, 1 + 2 bands + N] on the device)."""
        cfg = self.cfg
        c, half, offs = cfg.n_channels, cfg.n_mdct_lines, up["offs"]
        dev = self.consts("f32")          # as pactpu: .pac encodes in f32
        programmed = programs.encode_programs(self)["baseline"]
        self._last = EncodeStats()

        def stage(x):
            o = encode_baseline(cfg, _overlap_frames(x, half), dev)
            return torch.cat([o["overall"][..., None], o["bits"], o["sf"],
                              o["mant"]], -1)

        outs = [self._run_stage(
            "baseline", programmed, offs[k + 1] - offs[k], (cfg, "f32"),
            stage, (up["pcm"][:, offs[k] * half:(offs[k + 1] + 1) * half],))
            for k in range(len(offs) - 1)]
        b = up["b"]
        return dict(b=b, host=torch.cat(outs)[:b].reshape(b * c, -1))

    def _baseline_finish(self, st: dict, header: bytes = b"") -> bytes:
        """Blocking half of a .pac encode: ONE download of every batch's
        side info and mantissas, host serialization (native pack_file,
        the baseline layout; the span "frame")."""
        cfg = self.cfg
        c, half, nb = cfg.n_channels, cfg.n_mdct_lines, cfg.n_bands
        b = st["b"]
        host = _download(st["host"])
        ba = host[:, 1:1 + nb]
        with span("frame") as sp:
            data = native.pack_file(
                np.asarray(cfg.band_layout.n_lines, np.int32),
                cfg.n_scale_bits, cfg.n_mant_size_bits, 0, host[:, 0],
                np.zeros(b * c, np.int32), ba, host[:, 1 + nb:1 + 2 * nb],
                np.zeros((b * c, half), np.int32), host[:, 1 + 2 * nb:],
                ba[:, cfg.band_layout.line_to_band],
                np.zeros((b, nb), np.int32), write_lrms=False, n_channels=c)
            if sp is not None:
                sp.counts.update(bytes_out=len(data), wide=0, padded=0)
            return header + data

    def encode(self, pcm: np.ndarray) -> bytes:
        """pcm: int16 [n, C] -> complete .wak (or .pac) byte stream (the
        root span "encode", its blocks counted; its device tensors are
        freed in the span "release")."""
        with span("encode") as sp:
            if sp is not None:
                sp.counts["blocks"] = self._blocks(pcm)
            header, _ = write_header(self.cfg, pcm.shape[0])
            if self.fmt == "pac":
                return self._encode_baseline(pcm, header)
            st = self._encode_chunks(pcm)
            data = self._finish_encode(st, header)
            with span("release"):
                del st
            return data

    def _blocks(self, pcm: np.ndarray) -> int:
        """The blocks of an encode of pcm, the flush block included."""
        return -(-pcm.shape[0] // self.cfg.n_mdct_lines) + 1

    def encode_arrays(self, pcm: np.ndarray):
        """pcm: int16 [n, C] -> (host arrays, b), pactpu's encode_arrays:
        the final pass of every chunk joined, rows past the file's b blocks
        included (savings, leftover, overall, lrms, bits, sf, tid, and
        words as uint32 with nbits, or with device_pack=False sign, codes
        and lens).  The header and pack_payload(out, b) are encode(pcm)."""
        with span("encode") as sp:
            st = self._encode_chunks(pcm)
            if sp is not None:
                sp.counts["blocks"] = st["b"]
            outs = st["outs"]
            self._last["savings"] = torch.cat([o["savings"] for o in outs])
            out = {k: _download([o[k] for o in outs]) for k in outs[0]}
        if "words" in out:
            out["words"] = out["words"].view(np.uint32)
        return out, st["b"]

    def encode_many(self, pcms) -> list:
        """Batch encode: every file's device work is queued before the
        first payload download blocks.  The device holds every staged
        file.  The .pac coder encodes file by file.  last_savings,
        last_measure and last_extras describe the last file, last_many
        each file's (EncodeStats, in order)."""
        if self.fmt == "pac":
            out, many = [], []
            for p in pcms:
                out.append(self.encode(p))
                many.append(self._last)
            self.last_many = many
            return out
        staged = self._encode_staged(pcms)
        out, many = [], []
        for header, st in staged:
            self._last = st["stats"]
            with span("encode", blocks=0):
                out.append(self._finish_encode(st, header))
            many.append(self._last)
        self.last_many = many
        return out

    def _encode_staged(self, pcms) -> list:
        """The first half of encode_many and roundtrip_many: each file's
        (header, staged encode), each under a root span "encode" of its
        blocks (its download and framing run later, under a second root
        span "encode" of 0 blocks)."""
        staged = []
        for p in pcms:
            with span("encode") as sp:
                st = self._encode_chunks(p)
                if sp is not None:
                    sp.counts["blocks"] = st["b"]
            st["stats"] = self._last
            staged.append((write_header(self.cfg, p.shape[0])[0], st))
        return staged

    def roundtrip_many(self, pcms, return_streams: bool = False):
        """Pipelined many-file encode -> decode: every encode is staged
        first; then file k's payload download and decode dispatch run
        while later files' device work is queued; the PCM downloads drain
        last.  Returns [(sample_rate, pcm), ...] (and the streams with
        return_streams=True), identical to serial encode()/decode().  The
        .pac coder runs file by file, encode then decode."""
        if self.fmt == "pac":
            streams = [self.encode(p) for p in pcms]
            results = [self.decode(s) for s in streams]
            return (results, streams) if return_streams else results
        streams, dec = [], []
        for header, st in self._encode_staged(pcms):
            self._last = st["stats"]
            with span("encode", blocks=0):
                streams.append(self._finish_encode(st, header))
            with span("decode") as sp:
                dec.append(self._decode_dispatch(streams[-1]))
                if sp is not None:
                    sp.counts["blocks"] = dec[-1][2]
        results = []
        for d in dec:
            with span("decode", blocks=0):
                results.append(self._decode_finish(*d))
        return (results, streams) if return_streams else results

    # -- decode ----------------------------------------------------------

    def decode(self, data: bytes) -> tuple[int, np.ndarray]:
        """Full stream -> (sample_rate, int16 [n, C]): the reference
        decoder's first-block skip and final overlap-add flush (reference
        codec/pacfile.py:484-487, 171-178), trimmed to the header's
        numSamples (incl. the Q6 padding quirk).  The root span "decode"
        counts the stream's blocks."""
        with span("decode") as sp:
            d = self._decode_dispatch(data)
            if sp is not None:
                sp.counts["blocks"] = d[2]
            return self._decode_finish(*d)

    def decode_many(self, datas) -> list:
        """Batch decode: every stream is parsed (or framed), uploaded and
        queued before the first PCM download blocks."""
        staged = []
        for data in datas:
            with span("decode") as sp:
                staged.append(self._decode_dispatch(data))
                if sp is not None:
                    sp.counts["blocks"] = staged[-1][2]
        out = []
        for st in staged:
            with span("decode", blocks=0):
                out.append(self._decode_finish(*st))
        return out

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

        i0, i1 = s0 // half, (s1 - 1) // half        # audio block range
        # the channel-blocks of the frames [0, i1 + 2)
        starts, sizes, end = scan_channel_blocks(
            data, off, limit=(i1 + 2) * c, strict=True)
        if len(starts) % c:
            raise ValueError("truncated channel-block header")
        last = len(starts) // c - 1
        f0, f1 = min(i0, last), min(i1 + 1, last)
        at_eof = f1 == last and end >= len(data)
        k1 = (f1 + 1) * c - 1              # the range's last channel-block
        mini = (write_header(cfg, total_samples)[0]
                + data[starts[f0 * c] - 4:starts[k1] + sizes[k1]])
        with span("decode") as sp:
            _, _, mb, ola_dev, n_bad = self._decode_dispatch(mini)
            if sp is not None:
                sp.counts["blocks"] = mb
            ola = self._fetch_ola(ola_dev, mb, c, n_bad, first_cblock=f0 * c)
            # block t of ola is the overlap-add of frames f0+t and f0+t+1 =
            # audio block f0+t (the row before, which lacks its true carry,
            # was dropped on the device as the whole-file decoder's
            # first-block skip); the tail block is the final flush, valid
            # only at the end of the stream
            with span("assemble", samples=s1 - s0) as sp:
                audio = ola[:(mb if at_eof else mb - 1) * half]
                base = f0 * half
                pcm = audio[s0 - base:s1 - base]
                if sp is not None:
                    sp.counts["copied"] = _copied(pcm, ola)
                return cfg.sample_rate, pcm

    def _decode_staging(self, data: bytes) -> dict:
        """Host half of a decode: read the header and stage the payload by
        the engine's parse route.  Returns dict(cfg, num_samples, b, run,
        chunk_args): `run(*chunk_args[k], carry)` uploads chunk k and
        queues its decode (a program replay on the card where
        programs.decode_programs says so), returning (pcm i16[B, C, N],
        carry', bad bool[C B] or None)."""
        cfg, num_samples, off = read_header(data)
        _check_config(cfg)
        if self.decode_parse == "device":
            _check_device_parse(cfg)
            staged = self._decode_staging_device_parse(data, off, cfg)
            if staged is None:
                raise ValueError(
                    "decode_parse='device': this stream or table set does "
                    "not fit the device parser (rows past its widest "
                    "bucket, or Huffman codes past the walk LUT's bounds: "
                    "more than 128 prefixes deeper than 11 bits in a "
                    "table); decode it with decode_parse='host'")
        else:
            staged = self._decode_staging_host_parse(data, off, cfg)
        return dict(cfg=cfg, num_samples=num_samples, **staged)

    def _decode_staging_device_parse(self, data: bytes, off: int,
                                     cfg: CodecConfig):
        """Stage a device-parse decode: frame the raw payload into word
        rows; the chunk program (kernel K5 for .wak, K1 for .pac on a CUDA
        device, their plain versions on the CPU) does everything else.
        Whether the stream fits is decided here, before staging: returns
        None when it needs the host parser (rows wider than the largest
        bucket, or tables outside the LUT's bounds)."""
        lut = None
        if self.fmt == "wak":
            lut = hw.device_walk_lut(self.tables, device=self.device)
            if lut is None:
                return None
        with span("parse", bytes_in=len(data) - off):
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
        dev = self.consts(cfg=cfg)
        programmed = programs.decode_programs(self)

        def stage(words_k, nbits_k, carry):
            return payload_decode_chunk(cfg, words_k, nbits_k, carry, dev,
                                        lut)

        def run(words_k, nbits_k, carry):
            return self._run_stage(
                "decode_device_parse", programmed, words_k.shape[0] // c,
                (replace(cfg, window=self.cfg.window),), stage,
                (words_k, nbits_k, carry))

        words = words.view(np.int32)
        return dict(b=b, run=run, chunk_args=[
            (words[offs[k]:offs[k + 1]], nbits[offs[k]:offs[k + 1]])
            for k in range(len(sizes))])

    def _decode_staging_host_parse(self, data: bytes, off: int,
                                   cfg: CodecConfig) -> dict:
        """Stage a host-parse decode: native parse, repack of the mantissa
        codes into fixed-width words, and compaction of each chunk's rows
        into one flat buffer in the first of _decode_layouts that holds
        them (padded rows past the last: the span "compact" counts that
        overflow)."""
        c = cfg.n_channels
        parsed, rows_pad, rowbits, n_words = self._host_parse(data[off:], cfg)
        b = parsed["n_cblocks"] // c
        sizes = _chunk_sizes(b, self._chunk(b))
        offs = _offsets(sizes)
        b_pad = offs[-1]

        def d2(a):
            a = a.reshape(b, c, *a.shape[1:])
            return np.pad(a, [(0, b_pad - b)] + [(0, 0)] * (a.ndim - 1))

        with span("compact") as sp:
            ba = d2(parsed["ba"]).astype(np.int8)
            sf = d2(parsed["sf"]).astype(np.int8)
            overall = d2(parsed["overall"]).astype(np.int8)
            lrms = np.pad(parsed["lrms"] != 0, ((0, b_pad - b), (0, 0)))

            counts = np.minimum((rowbits + 31) // 32, n_words)
            totals = [int(counts[offs[k] * c:offs[k + 1] * c].sum())
                      for k in range(len(sizes))]
            layout = decode_layout(n_words, lambda dense: all(
                t <= sz * c * dense for t, sz in zip(totals, sizes)))
            if layout is not None:
                col = np.arange(n_words)[None, :]
                words = []
                for k, sz in enumerate(sizes):
                    i, rpc = offs[k] * c, sz * c
                    fl = rows_pad[i:i + rpc][col < counts[i:i + rpc, None]]
                    words.append(np.pad(fl, (0, rpc * layout[0]
                                             - fl.shape[0])))
            else:                            # dense overflow: padded rows
                rows_all = d2(rows_pad).reshape(b_pad * c, n_words)
                words = [rows_all[offs[k] * c:offs[k + 1] * c]
                         for k in range(len(sizes))]
            if sp is not None:
                sp.counts["overflow"] = int(layout is None)
        dev = self.consts(cfg=cfg)
        programmed = programs.decode_programs(self)
        width = n_words if layout is None else layout[1]

        def stage(ba_k, sf_k, words_k, overall_k, lrms_k, carry):
            if layout is not None:
                words_k = expand_flat(
                    words_k, ba_k.reshape(-1, ba_k.shape[-1]).to(
                        torch.int32), width, dev["lay"])
            return decode_chunk(cfg, ba_k, sf_k, words_k, overall_k, lrms_k,
                                carry, dev)

        def run(ba_k, sf_k, words_k, overall_k, lrms_k, carry):
            return (*self._run_stage(
                "decode", programmed, ba_k.shape[0],
                (replace(cfg, window=self.cfg.window), width,
                 layout is not None),
                stage, (ba_k, sf_k, words_k, overall_k, lrms_k, carry)),
                None)

        return dict(b=b, run=run, chunk_args=[
            (ba[offs[k]:offs[k + 1]], sf[offs[k]:offs[k + 1]],
             words[k].view(np.int32), overall[offs[k]:offs[k + 1]],
             lrms[offs[k]:offs[k + 1]]) for k in range(len(sizes))])

    def _host_parse(self, payload: bytes, cfg: CodecConfig,
                    layout_width: bool = False):
        """The native parse of a payload (the engine's fmt and tables) and
        its mantissa codes repacked into fixed-width rows.  Returns
        (parsed, rows u32[CB, W], bits of each row i64[CB], W: the
        smallest of _WORD_BUCKETS that holds the widest row, or with
        layout_width the width of the first decode layout that holds it,
        decode_layout's)."""
        c = cfg.n_channels
        huff = self.fmt == "wak"
        n_lines = np.asarray(cfg.band_layout.n_lines, np.int32)
        parsed = native.unpack_file(
            payload, n_lines, cfg.n_scale_bits, cfg.n_mant_size_bits,
            cfg.n_table_id_bits if huff else 0, read_lrms=huff, n_channels=c,
            tables=self.tables)
        if parsed["n_cblocks"] % c:
            raise ValueError(f"corrupt payload: {parsed['n_cblocks']} "
                             f"channel-blocks for {c} channels")
        rowbits = (parsed["ba"].astype(np.int64) * n_lines).sum(1)
        max_bits = int(rowbits.max(initial=0))
        n_words = next((w for w in _WORD_BUCKETS if w * 32 >= max_bits),
                       -(-max_bits // 32))
        if layout_width:
            n_words = (decode_layout(n_words) or (0, n_words))[1]
        rows = native.repack_codes(parsed["mant"], parsed["ba"], n_lines,
                                   n_words)
        return parsed, rows, rowbits, n_words

    def _upload(self, a) -> torch.Tensor:
        """A host array on the engine's device (a tensor is moved as it
        is: devbench times a staged decode on uploaded arguments)."""
        if torch.is_tensor(a):
            return a.to(self.device)
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    def _decode_dispatch(self, data: bytes):
        """Stage, upload and queue every chunk's decode; returns the state
        _decode_finish needs, without waiting for the device."""
        return self._decode_launch(self._decode_staging(data))

    def _decode_launch(self, staged: dict):
        """Device half of a decode dispatch: upload each chunk of a
        _decode_staging result (_decode_upload) and queue its decode
        (_decode_queue)."""
        return self._decode_queue(self._decode_upload(staged))

    def _decode_upload(self, staged: dict) -> dict:
        """A _decode_staging result with its chunks' host arrays on the
        device: the only host-to-device copies of a decode (the span
        "upload": their bytes, and whether every one was page-locked)."""
        with span("upload") as sp:
            if sp is not None:
                host = [a for args in staged["chunk_args"] for a in args
                        if not torch.is_tensor(a) or a.device.type == "cpu"]
                sp.counts.update(
                    bytes=sum(a.nbytes for a in host),
                    pinned=int(all(torch.is_tensor(a) and a.is_pinned()
                                   for a in host)))
            return {**staged, "chunk_args": [
                tuple(self._upload(a) for a in args)
                for args in staged["chunk_args"]]}

    def _decode_queue(self, staged: dict):
        """Queue every chunk's decode of a _decode_staging result (on the
        card with its chunks uploaded by _decode_upload, no host sync and
        no copy from the host happens here).  Returns (cfg, num_samples,
        b, ola, n_bad): ola i16[b (+ flag rows), N, C] is the overlap-added
        PCM already in the caller's layout, its channels interleaved and
        the MDCT-delay row dropped; on the device-parse route the n_bad
        per-channel-block corruption flags ride behind it as further
        rows, so that one download brings both."""
        cfg, b = staged["cfg"], staged["b"]
        c, half = cfg.n_channels, cfg.n_mdct_lines
        with span("queue", chunks=len(staged["chunk_args"])):
            dt = self.consts(cfg=cfg)["basis"].dtype
            carry = torch.zeros((c, half), dtype=dt, device=self.device)
            pcm_chunks, bad_chunks = [], []
            for args in staged["chunk_args"]:
                pcm, carry, bad = staged["run"](*args, carry)
                pcm_chunks.append(pcm)
                if bad is not None:
                    bad_chunks.append(bad)
            # the final-flush half (reference pacfile.py:171-178) is the
            # carry when every block was real, else the overlap-add of the
            # first padded block; appending the carry row unifies both.
            # Rows 1..b are kept (row 0 is the MDCT delay), joined by the
            # one copy below
            parts = interleaved_rows(
                pcm_chunks + [q.float_to_pcm16(carry)[None]], 1, b + 1)
            n_bad = 0
            if bad_chunks:
                n_bad = b * c
                flags = torch.cat(bad_chunks)[:n_bad].to(torch.int16)
                flags = torch.nn.functional.pad(flags,
                                                (0, -n_bad % (c * half)))
                parts.append(flags.reshape(-1, half, c))
            ola = torch.cat(parts)
        return cfg, staged["num_samples"], b, ola, n_bad

    @staticmethod
    def _fetch_ola(ola_dev, b: int, c: int, n_bad: int,
                   first_cblock: int = 0) -> np.ndarray:
        """The single download of a decode: the overlap-added PCM
        i16[b * N, C] (a view of the download), after raising on a
        channel-block the device parser flagged (numbered from
        first_cblock)."""
        ola = _download(ola_dev)
        bad = ola[b:].reshape(-1)[:n_bad]
        if bad.any():
            raise ValueError("corrupt payload at channel-block "
                             f"{first_cblock + int(np.argmax(bad))}")
        return ola[:b].reshape(-1, c)

    def _decode_finish(self, cfg, num_samples, b, ola_dev, n_bad):
        """Blocking half of decode: the single download, then its first
        num_samples rows (the span "assemble", its samples a channel
        counted and the bytes the host copied to lay them out)."""
        audio = self._fetch_ola(ola_dev, b, cfg.n_channels, n_bad)
        with span("assemble") as sp:
            pcm = audio[:num_samples]
            if sp is not None:
                sp.counts.update(samples=pcm.shape[0],
                                 copied=_copied(pcm, audio))
            return cfg.sample_rate, pcm


ALLOC_MODES = ("water_fill", "closed_form", "uniform", "const_snr",
               "const_mnr")


def _check_config(cfg: CodecConfig, rate_mode: str = "reservoir") -> None:
    """Refuse what pactpu refuses: unknown channel counts, windows, peak
    pickers, allocators and M/S rules ("not ported", as nothing outside
    these is), and in the exact mode anything but the reference's
    water-filled, sine-windowed, intensity-M/S trajectory."""
    bad = []
    for field, want in (("n_channels", (1, 2)),
                        ("window", ("sine", "kbd")),
                        ("peak_mode", ("ref", "para", "weighted")),
                        ("alloc_mode", ALLOC_MODES),
                        ("ms_decision", ("intensity", "bitalloc"))):
        if getattr(cfg, field) not in want:
            bad.append(f"{field}={getattr(cfg, field)!r}")
    if bad:
        raise ValueError("not ported: " + ", ".join(bad))
    if rate_mode == "exact":
        for field, want, what in (
                ("alloc_mode", "water_fill", "water-filling"),
                ("window", "sine", "sine-windowed"),
                ("ms_decision", "intensity", "spectral-intensity M/S")):
            if getattr(cfg, field) != want:
                raise ValueError(
                    f"rate_mode='exact' reproduces the reference's {what} "
                    f"trajectory: {field} must be {want!r}")


def _check_tables(tables):
    """A Huffman table set as Engine(tables=...) takes it (pactpu's
    checks): None (the shipped set), a path to an .npz in the
    huffman_tables.npz layout (pactpu_torch.ops.huffman_train.save_tables
    or pactpu's), or the 4-tuple (lengths [T, S], codes [T, S],
    escape_lengths [T], escape_codes [T]).  Code lengths must fit the
    packer's 5 bits and every escape code must be at least 1 bit long.
    Returns None or the tuple as contiguous int32 arrays."""
    if tables is None:
        return None
    if isinstance(tables, (str, os.PathLike)):
        with np.load(tables) as z:
            tables = (z["lengths"], z["codes"], z["escape_lengths"],
                      z["escape_codes"])
    tables = tuple(np.ascontiguousarray(t, np.int32) for t in tables)
    if (int(tables[0].max(initial=0)) > 31
            or int(tables[2].max(initial=0)) > 31):
        raise ValueError("Huffman code lengths > 31 bits cannot be packed")
    if int(tables[2].min(initial=1)) < 1:
        raise ValueError("every Huffman table needs an escape code of "
                         "length >= 1 (see huffman_train.train_tables for "
                         "the escape-only default)")
    return tables


class DebugCheckError(RuntimeError):
    """Raised by Engine(debug_checks=True) when an encode pass produces
    non-finite SMRs or an allocation outside [0, max_mant] or of one bit
    (pactpu.codec.engine.DebugCheckError)."""


def _debug_check_encode(analyses, outs, max_mant: int, sizes) -> None:
    """pactpu's three checks of an encode's chunks (analysis dicts and
    finalize outputs, tensors or numpy arrays), with its messages; raises
    DebugCheckError naming the first offending chunk and block."""
    def host(a):
        return a.cpu().numpy() if torch.is_tensor(a) else np.asarray(a)

    offs = _offsets(sizes)
    for k, a in enumerate(analyses):
        smr = host(a["smr"])
        if not np.isfinite(smr).all():
            blk = int(np.argwhere(~np.isfinite(smr))[0][0])
            raise DebugCheckError(
                f"non-finite SMR in chunk {k}, block {offs[k] + blk}")
    for k, o in enumerate(outs):
        bits = host(o["bits"])
        if bits.min(initial=0) < 0 or bits.max(initial=0) > max_mant:
            blk = int(np.argwhere((bits < 0) | (bits > max_mant))[0][0])
            raise DebugCheckError(
                f"allocation out of [0, {max_mant}] in chunk {k}, "
                f"block {offs[k] + blk}")
        if (bits == 1).any():
            blk = int(np.argwhere(bits == 1)[0][0])
            raise DebugCheckError(
                f"1-bit allocation escaped the refund (Q12) in chunk {k}, "
                f"block {offs[k] + blk}")


def _check_device_parse(cfg: CodecConfig) -> None:
    """The device-parse route's own limit: kernel K5's band records hold
    at most 5 mantissa-size bits (encode and the host parse take more)."""
    if cfg.n_mant_size_bits > 5:
        raise ValueError("decode_parse='device': at most 5 mantissa-size "
                         f"bits (this stream has {cfg.n_mant_size_bits}); "
                         "decode it with decode_parse='host'")
