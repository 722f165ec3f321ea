// K7 exact_scan: the exact serial bit reservoir over every block of a
// chunk, for Engine(rate_mode="exact").
//
// Replaces the lax.scan of pactpu/codec/exact.py:152 (extras_scan_body's
// step, exact.py:113-175), which the JAX package runs as XLA operations,
// not as a Pallas kernel.  Per block t, in order (reference
// codec/Huffman.py:353-371, codec/codec.py:229, 258-260):
//
//   take    = deposit / divisor if deposit > 10, + deposit if deposit < 0
//   granted = extra + take                       (extras[t], channel 0's)
//   per channel: total = int(budget + chain), truncated in the engine's
//     type as finalize does; the greedy fill of the channel's SMRs (K2's
//     step, water_fill_step.cuh); the Huffman cost of that allocation,
//     min over tables of sum over bands of cost[t, ch, band, bits, table]
//     (the cost table of pactpu_torch/codec/exact.py); savings = raw bits
//     - (that + sign bits + table id bits); chain = the fill's leftover
//   deposit += sum of savings - take; extra = the last chain
//
// for the chunk's n_valid first blocks (the rest are padding: extras 0,
// the carry untouched).  The carry (deposit, extra) comes in and goes out
// as int32[2] on the device, so chunks chain with no host round trip.
//
// Bound on the H100: the chain of dependent fills.  Nothing of a block
// can start before the last block's savings are known, so the time is
// blocks x channels x greedy steps x one step; a warp walks the chain, one
// warp on the whole card.  What is not on the chain hides behind it: at
// the top of block t the warp issues block t+1's SMR and LRMS loads (into
// registers, used one block later) and prefetches block t+1's cost rows
// (C x bands x 17 x tables int32, 34 KB for a stereo block of 25 bands
// and 10 tables) from device memory into L2, so that the gather after a
// fill waits for one L2 round trip, not for the memory.  The gather is
// S x tables loads a lane issued together, then one warp sum a table.
//
// Exactness: the same operations in the same order as the plain version
// (kernels.exact_scan_plain): integer arithmetic, the fill bit-exact with
// K2's plain version, the total's addition and truncation in T.

#include "kernels.h"
#include "water_fill_step.cuh"

namespace {

constexpr int kAllocs = 17;     // allocation values 0..16 of the cost table
constexpr int kMaxTables = 16;  // Huffman tables (4 table id bits: 15)

template <typename T, int S, bool kWide>
__global__ void __launch_bounds__(32)
exact_scan_kernel(const T* __restrict__ smr, const uint8_t* __restrict__ lrms,
                  const int32_t* __restrict__ cost,
                  const int32_t* __restrict__ n_lines,
                  const int32_t* __restrict__ carry_in,
                  int32_t* __restrict__ carry_out,
                  int32_t* __restrict__ extras, int blocks, int n_valid,
                  int channels, int n_bands, int n_tab, double budget,
                  int max_mant, T ms_stop, T lr_stop, int tid_bits,
                  int divisor) {
  const int lane = threadIdx.x;
  const int64_t cost_block =
      static_cast<int64_t>(channels) * n_bands * kAllocs * n_tab;
  const T budget_t = static_cast<T>(budget);
  const int ns = wf::n_slots<S, kWide>(n_bands);
  int nl[S];
#pragma unroll
  for (int j = 0; j < ns; ++j)
    nl[j] = lane + 32 * j < n_bands ? n_lines[lane + 32 * j] : 0;

  // block t's SMRs (two channels at most) and M/S slots, loaded a block
  // ahead
  T s_next[2][S];
  unsigned ms_next = 0;
  auto load = [&](int t) {
    ms_next = 0;
#pragma unroll
    for (int j = 0; j < ns; ++j) {
      const int band = lane + 32 * j;
      const bool real = band < n_bands;
#pragma unroll
      for (int ch = 0; ch < 2; ++ch)
        s_next[ch][j] = real && ch < channels
                            ? smr[(static_cast<int64_t>(t) * channels + ch) *
                                      n_bands + band]
                            : T(0);
      ms_next |= (real && lrms[static_cast<int64_t>(t) * n_bands + band] != 0
                      ? 1u : 0u) << j;
    }
  };
  // block t's cost rows into L2, 128-byte lines spread over the lanes
  auto prefetch = [&](int t) {
    const char* base = reinterpret_cast<const char*>(cost + t * cost_block);
    const int64_t bytes = cost_block * 4;
    for (int64_t b = 128 * lane; b < bytes; b += 128 * 32)
      asm volatile("prefetch.global.L2 [%0];" :: "l"(base + b));
  };

  int deposit = carry_in[0];
  int extra = carry_in[1];
  if (n_valid > 0) {
    load(0);
    prefetch(0);
  }
  for (int t = 0; t < n_valid; ++t) {
    T s_cur[2][S];
#pragma unroll
    for (int j = 0; j < ns; ++j) {
      s_cur[0][j] = s_next[0][j];
      s_cur[1][j] = s_next[1][j];
    }
    const unsigned ms = ms_next;
    if (t + 1 < n_valid) {
      load(t + 1);
      prefetch(t + 1);
    }
    const int take = (deposit > 10 ? deposit / divisor : 0) +
                     (deposit < 0 ? deposit : 0);
    const int granted = extra + take;
    int chain = granted, savings = 0;
#pragma unroll
    for (int ch = 0; ch < 2; ++ch) {
      if (ch == channels) break;
      const T(&s)[S] = s_cur[ch];
      const int total = static_cast<int>(
          wf::add_rn(budget_t, static_cast<T>(chain)));   // truncates
      int bits[S];
      const int left = wf::fill_row<T, S, kWide>(
          s, ms, nl, n_bands, total, max_mant, ms_stop, lr_stop, bits);
      // the allocation's Huffman cost under every table
      const int32_t* cost_c =
          cost + t * cost_block +
          static_cast<int64_t>(ch) * n_bands * kAllocs * n_tab;
      int raw = 0, signs = 0;
#pragma unroll
      for (int j = 0; j < ns; ++j) {
        raw += bits[j] * nl[j];
        signs += bits[j] > 0 ? nl[j] : 0;
      }
      raw = __reduce_add_sync(wf::kFull, raw);
      signs = __reduce_add_sync(wf::kFull, signs);
      // every load first, then one warp sum a table
      int part[kMaxTables];
#pragma unroll
      for (int tb = 0; tb < kMaxTables; ++tb) {
        part[tb] = 0;
        if (tb < n_tab) {
#pragma unroll
          for (int j = 0; j < ns; ++j)
            if (lane + 32 * j < n_bands)
              part[tb] += __ldg(cost_c + (static_cast<int64_t>(
                  lane + 32 * j) * kAllocs + bits[j]) * n_tab + tb);
        }
      }
      int best = 0x7fffffff;
#pragma unroll
      for (int tb = 0; tb < kMaxTables; ++tb)
        if (tb < n_tab)
          best = min(best, __reduce_add_sync(wf::kFull, part[tb]));
      savings += raw - (best + signs + tid_bits);
      chain = left;
    }
    if (lane == 0) extras[t] = granted;
    deposit = deposit - take + savings;
    extra = chain;
  }
  for (int t = max(n_valid, 0) + lane; t < blocks; t += 32) extras[t] = 0;
  if (lane == 0) {
    carry_out[0] = deposit;
    carry_out[1] = extra;
  }
}

template <typename T, int S, bool kWide = false>
int launch(const T* smr, const uint8_t* lrms, const int32_t* cost,
           const int32_t* n_lines, const int32_t* carry_in,
           int32_t* carry_out, int32_t* extras, int blocks, int n_valid,
           int channels, int n_bands, int n_tab, double budget, int max_mant,
           double ms_stop, double lr_stop, int tid_bits, int divisor,
           cudaStream_t stream) {
  exact_scan_kernel<T, S, kWide><<<1, 32, 0, stream>>>(
      smr, lrms, cost, n_lines, carry_in, carry_out, extras, blocks, n_valid,
      channels, n_bands, n_tab, budget, max_mant, static_cast<T>(ms_stop),
      static_cast<T>(lr_stop), tid_bits, divisor);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const T* smr, const uint8_t* lrms, const int32_t* cost,
             const int32_t* n_lines, const int32_t* carry_in,
             int32_t* carry_out, int32_t* extras, int blocks, int n_valid,
             int channels, int n_bands, int n_tab, double budget,
             int max_mant, double ms_stop, double lr_stop, int tid_bits,
             int divisor, cudaStream_t stream) {
  if (channels < 1 || channels > 2 || divisor == 0 || n_tab < 1 ||
      n_tab > kMaxTables)
    return static_cast<int>(cudaErrorInvalidValue);
  const int slots = (n_bands + 31) / 32;
#define PACTPU_K7_CASE(S)                                                   \
  if (slots <= S)                                                           \
    return launch<T, S>(smr, lrms, cost, n_lines, carry_in, carry_out,      \
                        extras, blocks, n_valid, channels, n_bands, n_tab,  \
                        budget, max_mant, ms_stop, lr_stop, tid_bits,       \
                        divisor, stream);
  PACTPU_K7_CASE(1)
  PACTPU_K7_CASE(2)
  PACTPU_K7_CASE(4)
#undef PACTPU_K7_CASE
  if (slots <= 32)
    return launch<T, 32, true>(smr, lrms, cost, n_lines, carry_in,
                               carry_out, extras, blocks, n_valid, channels,
                               n_bands, n_tab, budget, max_mant, ms_stop,
                               lr_stop, tid_bits, divisor, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" int pactpu_exact_scan(
    const float* smr, const uint8_t* lrms, const int32_t* cost,
    const int32_t* n_lines, const int32_t* carry_in, int32_t* carry_out,
    int32_t* extras, int blocks, int n_valid, int channels, int n_bands,
    int n_tab, double budget, int max_mant, double ms_stop, double lr_stop,
    int tid_bits, int divisor, cudaStream_t stream) {
  return dispatch<float>(smr, lrms, cost, n_lines, carry_in, carry_out,
                         extras, blocks, n_valid, channels, n_bands, n_tab,
                         budget, max_mant, ms_stop, lr_stop, tid_bits,
                         divisor, stream);
}

extern "C" int pactpu_exact_scan_f64(
    const double* smr, const uint8_t* lrms, const int32_t* cost,
    const int32_t* n_lines, const int32_t* carry_in, int32_t* carry_out,
    int32_t* extras, int blocks, int n_valid, int channels, int n_bands,
    int n_tab, double budget, int max_mant, double ms_stop, double lr_stop,
    int tid_bits, int divisor, cudaStream_t stream) {
  return dispatch<double>(smr, lrms, cost, n_lines, carry_in, carry_out,
                          extras, blocks, n_valid, channels, n_bands, n_tab,
                          budget, max_mant, ms_stop, lr_stop, tid_bits,
                          divisor, stream);
}
