// K2 water_fill: the reference's greedy water-filling bit allocation.
//
// Replaces pactpu/ops/pallas_ops.py:_water_fill_kernel (via
// _water_fill_call / water_fill), bit-exact with the XLA loop of
// pactpu/ops/bitalloc.py:water_fill (reference codec/bitalloc.py:129-184).
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
// row, band b in lane b, the state (bits, budget, retired flag) in
// registers; rows are independent, four warps a block.  A step is one
// reduction, one ballot and selects:
//
// - The arg-max: the float key smr - 6 bits maps to a 32-bit unsigned
//   integer that orders as the floats do; one __reduce_max_sync gives the
//   maximum, and the lowest set bit of the ballot of the lanes that hold it
//   is the first-index tie-break: a lane is the candidate if that bit is
//   its own.
// - Everything else runs while the reduction is in flight, on operands
//   that were ready at the last step's end.  The stop rule `max of the
//   statistic < threshold` is the vote `every lane's statistic <
//   threshold`, taken for both thresholds; the candidate's M/S flag, a bit
//   of a ballot taken before the loop, picks one.  What the last candidate
//   paid reaches the other lanes by one shuffle.  Each lane works out what
//   it would do as the candidate (pay or not, its next key and statistic,
//   whether it retires), so that once the ballot names the candidate only
//   selects are left; 6 bits is kept as a float beside the count.
// - No branch in the step but the loop's exit (a vote on the live flags,
//   also in the reduction's shadow; from there every step is a no-op), and
//   no case for padding lanes (lane >= n_bands): they hold -inf and never
//   retire; a real lane holds at least -inf too and has a lower index, so
//   padding never wins.
//
// -0.0 and +0.0 must tie: an SMR of -0.0 is read as +0.0, after which no
// key can be -0.0 (x - x is +0.0).  A NaN SMR maps above +inf and fails
// every `<`, as the plain version's arg-max and max treat it.

#include <math.h>

#include "kernels.h"

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarpsPerBlock = 4;

// Order-preserving map of the floats (no -0.0 among them) to u32.
__device__ __forceinline__ unsigned ordered(float f) {
  const unsigned u = __float_as_uint(f);
  return u ^ (static_cast<unsigned>(static_cast<int>(u) >> 31) | 0x80000000u);
}

__global__ void water_fill_kernel(const int32_t* __restrict__ total_bits,
                                  const float* __restrict__ smr,
                                  const uint8_t* __restrict__ lrms,
                                  const int32_t* __restrict__ n_lines,
                                  int32_t* __restrict__ bits_out,
                                  int32_t* __restrict__ left_out, int rows,
                                  int n_bands, int max_mant, float ms_stop,
                                  float lr_stop) {
  const int row = blockIdx.x * kWarpsPerBlock + threadIdx.x / 32;
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;  // the whole warp leaves together
  const bool real = lane < n_bands;
  const int64_t at = static_cast<int64_t>(row) * n_bands + lane;
  const float s = real ? __fadd_rn(smr[at], 0.0f) : -INFINITY;  // -0 -> +0
  const unsigned ms_mask = __ballot_sync(kFull, real && lrms[at] != 0);
  const int nl = real ? n_lines[lane] : 0;
  const unsigned own_bit = 1u << lane;
  const unsigned dead_key = ordered(-1e30f);
  int bits = 0;
  float six_bits = 0.0f;    // 6 * bits, exact
  bool retired = false;     // of a real lane: out of the running
  int paid = 0;             // the last grant's cost, on the lane that paid
  int total = total_bits[row];
  const int max_iters = n_bands * (max_mant + 1);

  // candidate: first-index argmax of smr - 6 bits over the live bands,
  // retired ones at -1e30 (unfused, as the reference computes it)
  unsigned key = ordered(s);
  // global stop statistic: smr - 6 (bits - 1) over ALL bands, retired too
  float stat = __fsub_rn(s, -6.0f);
  int cand = 0;             // the last step's candidate lane
  for (int it = 0; it < max_iters; ++it) {
    const unsigned key_max = __reduce_max_sync(kFull, key);
    // While that reduction runs (its operands were ready at the last
    // step's end): the votes, the last grant's cost, and what this lane
    // does IF it is the candidate, so that little is left to do once it
    // is known.
    const bool any_live = __any_sync(kFull, real && !retired);
    const bool ms_quiet = __all_sync(kFull, stat < ms_stop);
    const bool lr_quiet = __all_sync(kFull, stat < lr_stop);
    total -= __shfl_sync(kFull, paid, cand);
    if (!any_live) {    // every later step is a no-op
      paid = 0;
      break;
    }
    const bool pay = total - nl >= 0;
    const float six_next = pay ? six_bits + 6.0f : six_bits;
    const unsigned key_next = ordered(__fsub_rn(s, six_next));
    const float stat_next = __fsub_rn(s, __fsub_rn(six_next, 6.0f));
    const bool retire = !pay || bits + 1 >= max_mant;
    // the candidate: the first lane that holds the maximum
    const unsigned holders = __ballot_sync(kFull, key == key_max);
    const unsigned first = holders & (0u - holders);
    const bool me = first == own_bit;
    const bool kill_stop = first & ms_mask ? ms_quiet : lr_quiet;
    cand = __popc(first - 1u);
    paid = me && pay ? nl : 0;
    bits += me && pay;
    six_bits = me ? six_next : six_bits;
    stat = me ? stat_next : stat;
    retired = retired || (me && (retire || kill_stop));
    key = !me ? key : retired ? dead_key : key_next;
  }
  total -= __shfl_sync(kFull, paid, cand);   // the last step's grant

  // refund the 1-bit bands (the reference never codes 1-bit mantissas)
  const bool one = bits == 1;
  const int refund = __reduce_add_sync(kFull, one ? nl : 0);
  if (real) bits_out[at] = one ? 0 : bits;
  if (lane == 0) left_out[row] = total + refund;
}

}  // namespace

extern "C" int pactpu_water_fill(const int32_t* total_bits, const float* smr,
                                 const uint8_t* lrms, const int32_t* n_lines,
                                 int32_t* bits, int32_t* leftover, int rows,
                                 int n_bands, int max_mant_bits,
                                 float ms_stop, float lr_stop,
                                 cudaStream_t stream) {
  const int blocks = (rows + kWarpsPerBlock - 1) / kWarpsPerBlock;
  water_fill_kernel<<<blocks, 32 * kWarpsPerBlock, 0, stream>>>(
      total_bits, smr, lrms, n_lines, bits, leftover, rows, n_bands,
      max_mant_bits, ms_stop, lr_stop);
  return static_cast<int>(cudaGetLastError());
}
