// K9 grant_fill: the greedy grant walk of the constant-SNR and
// constant-MNR allocators (CodecConfig(alloc_mode="const_snr" |
// "const_mnr")).
//
// Replaces no Pallas kernel: pactpu runs this walk as the lax.while_loop of
// _greedy_noise_floor_batch (pactpu/ops/bitalloc.py:458; reference
// codec/bitalloc.py:60-125), XLA operations.  Per row, from alloc = 0 and
// remaining = the row's budget, each step:
//
//   grantable = alloc < max_mant & remaining >= n_lines & remaining > 0
//   band      = the first band of largest level among the grantable ones
//               (the others read -inf; a NaN level is the largest, as in
//               jnp.argmax)
//   alloc[band] += 1, remaining -= n_lines[band], level[band] -= 6
//
// until no band is grantable or the step cap (the caller's
// _legacy_iter_bound) is reached; then allocations of one bit drop to 0.
// The levels are float32 in every precision, as pactpu casts them.  A step
// whose arg-max falls on a band that is not grantable (every grantable
// level -inf, an earlier band not grantable) grants nothing in pactpu and
// changes nothing, so every later step repeats it: the row stops there.
//
// One departure, sanctioned: `remaining > 0`.  pactpu's grantable mask
// lacks it, so once the budget is spent exactly, bands of zero lines go on
// taking free bits up to the cap; the reference's loop runs while
// remaining_bits > 0 (ROADMAP queue 3, fault (b)).
//
// Bound on the H100: latency of a serial loop, one grant a step.  K2's
// layout and step (one warp a row, band b in lane b % 32, slot b / 32,
// S = 1, 2 or 4 slots in registers, the wide form past 128 bands): a warp
// maximum of the keys (water_fill_step.cuh's order-preserving key), a warp
// minimum of the band index among the lanes that hold it (the first-index
// tie-break), one shuffle of what the grant cost.

#include "kernels.h"
#include "water_fill_step.cuh"

namespace {

constexpr int kWarpsPerBlock = 4;

template <int S, bool kWide>
__global__ void grant_fill_kernel(const int32_t* __restrict__ total,
                                  const float* __restrict__ level,
                                  const int32_t* __restrict__ n_lines,
                                  int32_t* __restrict__ bits_out, int rows,
                                  int n_bands, int max_mant, int max_steps) {
  const int row = blockIdx.x * kWarpsPerBlock + threadIdx.x / 32;
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;  // the whole warp leaves together
  const int64_t at = static_cast<int64_t>(row) * n_bands + lane;
  const int ns = wf::n_slots<S, kWide>(n_bands);
  float lev[S];
  int nl[S], alloc[S];
  bool real[S];
#pragma unroll
  for (int j = 0; j < ns; ++j) {
    real[j] = lane + 32 * j < n_bands;
    // x + 0: -0.0 reads as +0.0 and a NaN of either sign as the card's
    // positive NaN, whose key is above +inf's
    lev[j] = real[j] ? __fadd_rn(level[at + 32 * j], 0.0f) : -INFINITY;
    nl[j] = real[j] ? n_lines[lane + 32 * j] : 0;
    alloc[j] = 0;
  }
  const unsigned ninf = wf::ordered(-INFINITY);
  int remaining = total[row];
  for (int step = 0; step < max_steps; ++step) {
    bool any = false;
    bool can[S];
    unsigned kb = 0;        // this lane's largest key, its lowest slot on ties
    int jb = 0;
#pragma unroll
    for (int j = 0; j < ns; ++j) {
      can[j] = real[j] && alloc[j] < max_mant && remaining >= nl[j] &&
               remaining > 0;
      any = any || can[j];
      const unsigned k = can[j] ? wf::ordered(lev[j]) : ninf;
      if (j == 0 || k > kb) {
        kb = k;
        jb = j;
      }
    }
    if (!__any_sync(wf::kFull, any)) break;
    const unsigned kmax = wf::warp_max(kb);
    const unsigned cand =
        wf::warp_min(kb == kmax ? 32u * jb + lane : 0xffffffffu);
    int cost = -1;          // the grant's lines; -1: the band is not grantable
#pragma unroll
    for (int j = 0; j < ns; ++j) {
      if (cand != 32u * j + lane || !can[j]) continue;
      cost = nl[j];
      alloc[j] += 1;
      lev[j] = __fsub_rn(lev[j], 6.0f);
    }
    cost = __shfl_sync(wf::kFull, cost, static_cast<int>(cand & 31u));
    if (cost < 0) break;    // the arg-max is not grantable: a fixed point
    remaining -= cost;
  }

  int32_t* out = bits_out + static_cast<int64_t>(row) * n_bands + lane;
#pragma unroll
  for (int j = 0; j < ns; ++j)
    if (real[j])
      out[32 * j] = alloc[j] < 2 ? 0 : min(alloc[j], max_mant);
}

template <int S, bool kWide = false>
int launch(const int32_t* total, const float* level, const int32_t* n_lines,
           int32_t* bits, int rows, int n_bands, int max_mant, int max_steps,
           cudaStream_t stream) {
  const int blocks = (rows + kWarpsPerBlock - 1) / kWarpsPerBlock;
  grant_fill_kernel<S, kWide><<<blocks, 32 * kWarpsPerBlock, 0, stream>>>(
      total, level, n_lines, bits, rows, n_bands, max_mant, max_steps);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int pactpu_grant_fill(const int32_t* total, const float* level,
                                 const int32_t* n_lines, int32_t* bits,
                                 int rows, int n_bands, int max_mant_bits,
                                 int max_steps, cudaStream_t stream) {
  const int slots = (n_bands + 31) / 32;
  if (slots <= 1)
    return launch<1>(total, level, n_lines, bits, rows, n_bands,
                     max_mant_bits, max_steps, stream);
  if (slots <= 2)
    return launch<2>(total, level, n_lines, bits, rows, n_bands,
                     max_mant_bits, max_steps, stream);
  if (slots <= 4)
    return launch<4>(total, level, n_lines, bits, rows, n_bands,
                     max_mant_bits, max_steps, stream);
  if (slots <= 32)
    return launch<32, true>(total, level, n_lines, bits, rows, n_bands,
                            max_mant_bits, max_steps, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}
