"""The exact serial bit reservoir (pactpu.codec.exact) on PyTorch.

The reference's reservoir couples block t to t + 1: each block withdraws a
share of the deposit before allocating, channel 0's allocation leftover
funds channel 1, and each channel's Huffman savings go back into the
deposit (reference codec/Huffman.py:353-371, codec/codec.py:229, 258-260).
Engine(rate_mode="exact") reproduces that trajectory exactly; with
precision="f64" its stream is the reference's serial encode byte for
byte (the float64 oracle, pactpu_torch.compat.refcodec).

Everything in the serial loop that depends on the running extra bits
does so through the integer allocation of a band, one of 0..16, so the
heavy part is computed for every allocation at once, batch-parallel:

    cost[b, ch, band, alloc, table] = sum over the band's lines of the
        Huffman code length (or escape length + alloc) of the mantissa the
        band would emit at that allocation

(cost_table: kernel K10, pactpu_torch.ops.kernels.cost_table), and the
serial part is one water-fill per channel per block plus a gather of that
table: kernel K7 (pactpu_torch.ops.kernels.exact_scan), one warp walking
every valid block of a chunk (a mask it reads on the device), the carry
chained across chunks on the device.  The two are pactpu's two jit
programs a chunk (_cost_fn, _extras_fn): on the card the Engine runs each
as a CUDA-graph replay (stages "cost" and "exact_scan", pactpu_torch.
codec.programs), the cost program on a second stream one chunk ahead of
K7's, in a memory pool of its own.
"""

from __future__ import annotations

import torch

from pactpu_torch.codec import programs
from pactpu_torch.ops import kernels
from pactpu_torch.utils.config import CodecConfig


def max_mant(cfg: CodecConfig) -> int:
    """The mantissa bit cap: the size field's range or max_mant_bits."""
    return min(1 << cfg.n_mant_size_bits, cfg.max_mant_bits)


def cost_table(cfg: CodecConfig, analysis: dict, dev: dict) -> torch.Tensor:
    """Huffman bits of every band at every allocation under every table
    (pactpu.codec.exact.cost_table_body, integer-equal to it): analysis
    dict (engine.analyze) -> i32[B, C, bands, 17, T], allocation 0 all
    zeros; kernel K10 (kernels.cost_table) on the card, its plain version
    on the CPU."""
    tab_lens, _, esc_len, _ = dev["tabs"]
    mixed = analysis["mixed"].contiguous()
    return kernels.cost_table(mixed, dev["lay"], tab_lens, esc_len,
                              cfg.n_scale_bits, max_mant(cfg),
                              packed_tables(dev) if mixed.is_cuda else None)


def packed_tables(dev: dict):
    """K10's packed form of dev's Huffman table set (kernels.pack_tables),
    made at the first call and kept in dev beside "tabs", which no one
    changes once the dict is handed out (engine.device_tables,
    Engine.consts)."""
    if "packed" not in dev:
        tab_lens, _, esc_len, _ = dev["tabs"]
        dev["packed"] = kernels.pack_tables(tab_lens, esc_len)
    return dev["packed"]


def exact_extras_chunked(cfg: CodecConfig, analyses: list, dev: dict,
                         n_real: int, carry: torch.Tensor = None, run=None):
    """The exact trajectory over a file's chunks (pactpu.codec.exact.
    exact_extras_chunked): per chunk the cost table (stage "cost", K10,
    pactpu's _cost_fn), then kernel K7 from the last chunk's carry (stage
    "exact_scan", pactpu's _extras_fn) over the chunk's valid blocks.
    n_real: the file's real blocks (the padding behind them leaves the
    carry alone, so the chunk size never changes the trajectory).  run:
    run(stage, fn, args) runs a stage on its tensor arguments (the
    Engine's: a program replay on the card); None calls fn(*args).
    Returns (per-chunk extras f32[size] on the device, the final carry
    i32[2] on the device); nothing waits for the device.

    On the card the cost tables run on a second stream, one chunk ahead:
    chunk k + 1's beside chunk k's K7, which waits for its own table by an
    event, so a chunk's table costs the chain nothing but its first.  As
    programs, the cost program replays on that stream beside the
    exact_scan program's replay (the two take separate memory pools,
    programs.SIDE_STAGES)."""
    lay = dev["lay"]
    device = lay["n_lines"].device
    run = run or (lambda stage, fn, args: fn(*args))
    if carry is None:
        carry = torch.zeros(2, dtype=torch.int32, device=device)
    side = programs.stream(device, "cost") if device.type == "cuda" else None
    main = torch.cuda.current_stream(device) if side is not None else None
    if side is not None:
        packed_tables(dev)                  # packed on main, read on side
        side.wait_stream(main)              # the analyses are queued there

    def cost_stage(mixed):
        return cost_table(cfg, dict(mixed=mixed), dev)

    def scan_stage(smr, lrms, cost, valid, carry):
        ex, carry = kernels.exact_scan(
            smr.contiguous(), lrms.contiguous(), cost, valid, carry,
            float(cfg.bit_budget()), lay["n_lines"], max_mant(cfg),
            cfg.ms_stop_threshold_db, cfg.lr_stop_threshold_db,
            cfg.n_table_id_bits, cfg.reservoir_withdraw_divisor)
        # as pactpu: the extras go to finalize as float32
        return ex.to(torch.float32), carry

    def table(k: int):
        if side is None:
            return run("cost", cost_stage, (analyses[k]["mixed"],)), None
        with torch.cuda.stream(side):
            cost = run("cost", cost_stage, (analyses[k]["mixed"],))
            ready = torch.cuda.Event()
            ready.record(side)
        return cost, ready

    extras, done = [], 0
    pending = table(0) if analyses else None
    for k, a in enumerate(analyses):
        cost, ready = pending
        if k + 1 < len(analyses):
            pending = table(k + 1)
        if ready is not None:
            main.wait_event(ready)
            cost.record_stream(main)
        size = a["smr"].shape[0]
        # padded tail blocks take no part (a fill: no upload)
        valid = torch.arange(size, device=device) < max(0, n_real - done)
        ex, carry = run("exact_scan", scan_stage,
                        (a["smr"], a["lrms"], cost, valid, carry))
        extras.append(ex)
        done += size
    return extras, carry
