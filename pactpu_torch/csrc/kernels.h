// C interface of the port's hand-written Hopper kernels (sm_90a).
//
// Each function launches one kernel on `stream` and returns
// cudaGetLastError() as an int (0 = the launch was accepted).  Pointers are
// device pointers to contiguous row-major tensors allocated by the caller
// (pactpu_torch/ops/kernels.py); no function allocates or synchronizes.
#pragma once

#include <cstdint>

#include <cuda_runtime.h>

extern "C" {

// K1: out[r, l] = the width[r, l]-bit field at bit off[r, l] of row r's
// MSB-first u32 words (0 where width is 0).
int pactpu_extract_codes(const uint32_t* words, const int32_t* off,
                         const int32_t* width, int32_t* out, int rows,
                         int n_words, int n_lines, cudaStream_t stream);

// K2: greedy water-filling bit allocation per row (n_bands <= 1024), in
// float32 and in float64.
int pactpu_water_fill(const int32_t* total_bits, const float* smr,
                      const uint8_t* lrms, const int32_t* n_lines,
                      int32_t* bits, int32_t* leftover, int rows,
                      int n_bands, int max_mant_bits, float ms_stop,
                      float lr_stop, cudaStream_t stream);
int pactpu_water_fill_f64(const int32_t* total_bits, const double* smr,
                          const uint8_t* lrms, const int32_t* n_lines,
                          int32_t* bits, int32_t* leftover, int rows,
                          int n_bands, int max_mant_bits, double ms_stop,
                          double lr_stop, cudaStream_t stream);

// K3: out[r, w] = sum (mod 2^32) of part0[r, j] over items with w0 == w and
// of part1[r, j] over items with w0 + 1 == w; out-of-range words dropped.
int pactpu_pack_words(const uint32_t* part0, const uint32_t* part1,
                      const int32_t* w0, uint32_t* out, int rows, int items,
                      int n_words, cudaStream_t stream);

// K3, the whole payload pack: words [rows, n_words] (MSB-first u32) and
// nbits [rows] of each row's item stream, from overall and tid [rows], ba,
// sf and lrms [rows, nb], sign, codes and lens [rows, lines], and the
// layout's plan (item_plan [items]: perm << 8 | kind << 6 | const_width;
// group_plan [groups]: start << 16 | len << 10 | band; built by
// pactpu_torch/ops/bitpack.py:device_plan; items <= 4096).  Shared memory:
// 4 bytes times 13 + 5 nb + 3 lines + 2 groups + ceil(lines / 32) + items
// + n_words, at most 48 KB.
int pactpu_pack_payload(const int32_t* overall, const int32_t* tid,
                        const int32_t* ba, const int32_t* sf,
                        const int32_t* sign, const int32_t* codes,
                        const int32_t* lens, const int32_t* lrms,
                        const int32_t* item_plan, const int32_t* group_plan,
                        uint32_t* words, int32_t* nbits, int rows, int nb,
                        int lines, int items, int groups, int n_words,
                        cudaStream_t stream);

// K4: upslope masking-intensity sum per (row, line); bark and zvec must be
// ascending; in float32 and in float64.
int pactpu_spread_up(const float* iprime, const float* mspl,
                     const float* bark, const float* zvec, float* out,
                     int rows, int n_maskers, int n_lines,
                     cudaStream_t stream);
int pactpu_spread_up_f64(const double* iprime, const double* mspl,
                         const double* bark, const double* zvec, double* out,
                         int rows, int n_maskers, int n_lines,
                         cudaStream_t stream);

// K5: per-row Huffman bit-walk through the two-level LUT (l1 [n_tab, 2048],
// l1b [n_tab, 128], l2 [n_tab, l2_width]); n_lines is a device array of
// n_bands line counts.  Writes code [rows, total_lines] (every line, zero
// where a row's band has no bits), basf and soff [rows, n_bands], misc
// [rows, 5].
int pactpu_huffman_walk(const uint32_t* words, const uint32_t* l1,
                        const uint32_t* l1b, const uint32_t* l2,
                        const int32_t* n_lines, int32_t* code,
                        int32_t* basf, int32_t* soff, int32_t* misc, int rows,
                        int n_words, int n_bands, int total_lines, int n_tab,
                        int l2_width, int n_scale_bits, int n_mant_size_bits,
                        int n_table_id_bits, cudaStream_t stream);

// K6: full-slope masking-intensity sum per (row, line) over the row's valid
// masker slots (mspl, lev, bark, valid [rows, n_slots]; drop [rows]);
// n_slots <= 4096, slots in any order; in float32 and in float64.
int pactpu_spread(const float* mspl, const float* lev, const float* bark,
                  const float* valid, const float* drop, const float* zvec,
                  float* out, int rows, int n_slots, int n_lines,
                  cudaStream_t stream);
int pactpu_spread_f64(const double* mspl, const double* lev,
                      const double* bark, const double* valid,
                      const double* drop, const double* zvec, double* out,
                      int rows, int n_slots, int n_lines,
                      cudaStream_t stream);

// K7: the exact serial bit reservoir over a chunk's blocks (smr [blocks,
// channels, n_bands], lrms [blocks, n_bands], cost [blocks, channels,
// n_bands, 17, n_tab]; channels 1 or 2, n_bands <= 1024, n_tab <= 16) for
// its valid blocks, the prefix of nonzero flags of valid [blocks] (read on
// the device: n_valid = the first zero flag's index, blocks if none), from
// carry_in (deposit, extra) to carry_out; extras [blocks] = each block's
// channel-0 extra bits, 0 past n_valid; in float32 and in float64 (the
// type of the SMRs and of the total's sum).
int pactpu_exact_scan_valid(const float* smr, const uint8_t* lrms,
                            const uint8_t* valid, const int32_t* cost,
                            const int32_t* n_lines, const int32_t* carry_in,
                            int32_t* carry_out, int32_t* extras, int blocks,
                            int channels, int n_bands, int n_tab,
                            double budget, int max_mant, double ms_stop,
                            double lr_stop, int tid_bits, int divisor,
                            cudaStream_t stream);
int pactpu_exact_scan_valid_f64(const double* smr, const uint8_t* lrms,
                                const uint8_t* valid, const int32_t* cost,
                                const int32_t* n_lines,
                                const int32_t* carry_in, int32_t* carry_out,
                                int32_t* extras, int blocks, int channels,
                                int n_bands, int n_tab, double budget,
                                int max_mant, double ms_stop, double lr_stop,
                                int tid_bits, int divisor,
                                cudaStream_t stream);

// K8: kai's closed-form allocation per row (init and take-back loop) from
// budget [rows] and smr [rows, n_bands] (n_bands <= 1024), in float32 and
// in float64 (the type of the SMRs and of the init's arithmetic).
int pactpu_closed_form(const int32_t* budget, const float* smr,
                       const int32_t* n_lines, int32_t* bits, int rows,
                       int n_bands, int max_mant_bits, cudaStream_t stream);
int pactpu_closed_form_f64(const int32_t* budget, const double* smr,
                           const int32_t* n_lines, int32_t* bits, int rows,
                           int n_bands, int max_mant_bits,
                           cudaStream_t stream);

// K9: the constant-SNR/MNR greedy grant walk per row from total [rows] and
// float32 level [rows, n_bands] (n_bands <= 1024), at most max_steps
// grants a row.
int pactpu_grant_fill(const int32_t* total, const float* level,
                      const int32_t* n_lines, int32_t* bits, int rows,
                      int n_bands, int max_mant_bits, int max_steps,
                      cudaStream_t stream);

// K10: the exact mode's cost table cost [items, n_bands, 17, n_tab] of the
// items (block, channel) of mixed [items, half] (half <= 1024 lines, the
// bands the n_bands consecutive runs of n_lines): for each allocation
// 1..max_mant (<= 16, (1 << n_scale_bits) - 1 + max_mant <= 31) and table
// (n_tab <= 16, over n_sym symbols), the band's Huffman bits; packed
// [tab_rows, W] the table set as kernels.pack_tables packs it (W = 2 words
// a symbol up to 10 tables, else 4; the symbols below n_pack, then the
// escapes' entry; tab_rows * W a multiple of 4); exp2_tab [k + L + 1] =
// quantize.exp2i(k) for k in [-L - 1, L + max_mant], L the largest scale
// factor; in float32 and in float64 (the type of mixed and exp2_tab).
int pactpu_cost_table_packed(const float* mixed, const int32_t* n_lines,
                             const uint32_t* packed, const float* exp2_tab,
                             int32_t* cost, int items, int half, int n_bands,
                             int n_tab, int n_sym, int n_pack, int tab_rows,
                             int n_scale_bits, int max_mant,
                             cudaStream_t stream);
int pactpu_cost_table_packed_f64(const double* mixed, const int32_t* n_lines,
                                 const uint32_t* packed,
                                 const double* exp2_tab, int32_t* cost,
                                 int items, int half, int n_bands, int n_tab,
                                 int n_sym, int n_pack, int tab_rows,
                                 int n_scale_bits, int max_mant,
                                 cudaStream_t stream);

// K11: the reservoir policy over a chunk's blocks: savings [blocks,
// channels] summed a block (int32, wrapping), leftover and valid (0/1)
// [blocks], from carry_in (deposit, extra) to carry_out; extras [blocks] =
// each block's channel-0 extra bits as float32, 0 where valid is 0
// (divisor > 0).
int pactpu_reservoir_scan(const int32_t* savings, const int32_t* leftover,
                          const uint8_t* valid, const int32_t* carry_in,
                          int32_t* carry_out, float* extras, int blocks,
                          int channels, int divisor, cudaStream_t stream);

}  // extern "C"
