// K2 water_fill: the reference's greedy water-filling bit allocation.
//
// Replaces pactpu/ops/pallas_ops.py:_water_fill_kernel (via
// _water_fill_call / water_fill), bit-exact with the XLA loop of
// pactpu/ops/bitalloc.py:water_fill (reference codec/bitalloc.py:129-184),
// in float32 and, for precision="f64", in float64 (where pactpu runs that
// XLA loop in float64, bitalloc.py:57).
//
// Bound on the H100: latency of a serial loop.  A row runs up to
// n_bands * (max_mant + 1) dependent steps (an arg-max over the bands, a
// grant, a kill) on a few hundred bytes of input, so the time is the
// longest row's step count times the length of one step.  A warp runs its
// instructions in order: every wait for a warp-wide operation (on this
// card, by tools/warp_op_latency.cu: a shuffle 26 clocks, a vote 19, a
// reduction 47 and not pipelined with another, a find-first-set 36), every
// divergent branch and every constant load in the step lengthens it,
// whether the next arg-max needs the result or not.  One warp holds one
// row, rows are independent, four warps a block.  The step itself is
// water_fill_step.cuh's (shared with K7): one reduction, one ballot and
// selects for up to 32 bands (band b in lane b); above that each lane
// holds S = 2 or 4 bands in registers (up to 128), or up to 32 in the wide
// form (up to 1,024), and a step adds a warp minimum for the first-index
// tie-break; float64 takes a second reduction for the key's low word.

#include "kernels.h"
#include "water_fill_step.cuh"

namespace {

constexpr int kWarpsPerBlock = 4;

template <typename T, int S, bool kWide>
__global__ void water_fill_kernel(const int32_t* __restrict__ total_bits,
                                  const T* __restrict__ smr,
                                  const uint8_t* __restrict__ lrms,
                                  const int32_t* __restrict__ n_lines,
                                  int32_t* __restrict__ bits_out,
                                  int32_t* __restrict__ left_out, int rows,
                                  int n_bands, int max_mant, T ms_stop,
                                  T lr_stop) {
  const int row = blockIdx.x * kWarpsPerBlock + threadIdx.x / 32;
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;  // the whole warp leaves together
  const int64_t at = static_cast<int64_t>(row) * n_bands + lane;
  const int ns = wf::n_slots<S, kWide>(n_bands);
  T s[S];
  int nl[S], bits[S];
  unsigned ms = 0;
#pragma unroll
  for (int j = 0; j < ns; ++j) {
    const bool real = lane + 32 * j < n_bands;
    s[j] = real ? smr[at + 32 * j] : T(0);
    nl[j] = real ? n_lines[lane + 32 * j] : 0;
    ms |= (real && lrms[at + 32 * j] != 0 ? 1u : 0u) << j;
  }
  const int left = wf::fill_row<T, S, kWide>(s, ms, nl, n_bands,
                                             total_bits[row], max_mant,
                                             ms_stop, lr_stop, bits);
#pragma unroll
  for (int j = 0; j < ns; ++j)
    if (lane + 32 * j < n_bands) bits_out[at + 32 * j] = bits[j];
  if (lane == 0) left_out[row] = left;
}

template <typename T, int S, bool kWide = false>
int launch(const int32_t* total_bits, const T* smr, const uint8_t* lrms,
           const int32_t* n_lines, int32_t* bits, int32_t* leftover,
           int rows, int n_bands, int max_mant_bits, double ms_stop,
           double lr_stop, cudaStream_t stream) {
  const int blocks = (rows + kWarpsPerBlock - 1) / kWarpsPerBlock;
  water_fill_kernel<T, S, kWide><<<blocks, 32 * kWarpsPerBlock, 0, stream>>>(
      total_bits, smr, lrms, n_lines, bits, leftover, rows, n_bands,
      max_mant_bits, static_cast<T>(ms_stop), static_cast<T>(lr_stop));
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const int32_t* total_bits, const T* smr, const uint8_t* lrms,
             const int32_t* n_lines, int32_t* bits, int32_t* leftover,
             int rows, int n_bands, int max_mant_bits, double ms_stop,
             double lr_stop, cudaStream_t stream) {
  const int slots = (n_bands + 31) / 32;
#define PACTPU_K2_CASE(S)                                                   \
  if (slots <= S)                                                           \
    return launch<T, S>(total_bits, smr, lrms, n_lines, bits, leftover,     \
                        rows, n_bands, max_mant_bits, ms_stop, lr_stop,     \
                        stream);
  PACTPU_K2_CASE(1)
  PACTPU_K2_CASE(2)
  PACTPU_K2_CASE(4)
#undef PACTPU_K2_CASE
  if (slots <= 32)
    return launch<T, 32, true>(total_bits, smr, lrms, n_lines, bits,
                               leftover, rows, n_bands, max_mant_bits,
                               ms_stop, lr_stop, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" int pactpu_water_fill(const int32_t* total_bits, const float* smr,
                                 const uint8_t* lrms, const int32_t* n_lines,
                                 int32_t* bits, int32_t* leftover, int rows,
                                 int n_bands, int max_mant_bits,
                                 float ms_stop, float lr_stop,
                                 cudaStream_t stream) {
  return dispatch<float>(total_bits, smr, lrms, n_lines, bits, leftover, rows,
                         n_bands, max_mant_bits, ms_stop, lr_stop, stream);
}

extern "C" int pactpu_water_fill_f64(const int32_t* total_bits,
                                     const double* smr, const uint8_t* lrms,
                                     const int32_t* n_lines, int32_t* bits,
                                     int32_t* leftover, int rows, int n_bands,
                                     int max_mant_bits, double ms_stop,
                                     double lr_stop, cudaStream_t stream) {
  return dispatch<double>(total_bits, smr, lrms, n_lines, bits, leftover,
                          rows, n_bands, max_mant_bits, ms_stop, lr_stop,
                          stream);
}
