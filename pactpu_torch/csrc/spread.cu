// K6 spread_maskers: the masking sum over compacted masker slots, both
// slopes of the spreading function.
//
// Replaces pactpu/ops/pallas_ops.py:_spread_kernel (via spread_maskers),
// the accumulation of the compact masked-threshold path
// (pactpu/ops/psycho.py:274-309) that the aidan peak modes need:
//
//   out[b, l] = sum over valid slots k of
//     10^((mspl[b,k] - drop[b] - 27 on + [dz >= 0] lev[b,k] on - 96) / 10),
//   dz = zvec[l] - bark[b, k],  on = max(|dz| - 0.5, 0).
//
// Bound on the H100: operations, on the special-function unit.  At 3,072
// rows x 513 slots x 1,024 lines the triple space is 1.6 G, one exp2 each
// for the valid ones, against 38 MB of inputs and output.  The design is
// K4's (spread_up.cu): grid (row, 256-line tile), one thread per line with
// its sum in a register, the row's slots staged once in shared memory so
// that the slot loop reads only shared memory and is uniform across the
// block (no divergence when an invalid slot is skipped).  Unlike K4 the
// slot barks are per row and in no order (top-k of interpolated peak
// positions), so there is no range skip: every valid slot reaches every
// line through one slope or the other.  The TPU kernel needed the slot
// count to be a multiple of 128 lanes; this one takes any count.
//
// The arithmetic keeps the plain version's order with unfused float32
// operations, so each term has the plain version's bits; only the order
// of the sum over slots differs (slot order here, a tree there).

#include "kernels.h"

namespace {

constexpr int kLineTile = 256;
// log2(10) / 10, the constant of pactpu/ops/pallas_ops.py:34 in float32
constexpr float kLog2_10_over_10 = 0.33219280948873623f;

__global__ void spread_kernel(const float* __restrict__ mspl,
                              const float* __restrict__ lev,
                              const float* __restrict__ bark,
                              const float* __restrict__ valid,
                              const float* __restrict__ drop,
                              const float* __restrict__ zvec,
                              float* __restrict__ out, int n_slots,
                              int n_lines) {
  extern __shared__ float sm[];
  float* s_base = sm;                  // mspl - drop
  float* s_lev = sm + n_slots;
  float* s_bark = sm + 2 * n_slots;
  __shared__ int s_count;
  const int64_t row = blockIdx.x;
  const float d = drop[row];
  // compact the row's valid slots, in slot order, by one warp's ballots
  if (threadIdx.x < 32) {
    int count = 0;
    for (int k0 = 0; k0 < n_slots; k0 += 32) {
      const int k = k0 + threadIdx.x;
      const bool v = k < n_slots && valid[row * n_slots + k] != 0.0f;
      const unsigned m = __ballot_sync(0xFFFFFFFFu, v);
      if (v) {
        const int j = count + __popc(m & ((1u << threadIdx.x) - 1u));
        s_base[j] = __fsub_rn(mspl[row * n_slots + k], d);
        s_lev[j] = lev[row * n_slots + k];
        s_bark[j] = bark[row * n_slots + k];
      }
      count += __popc(m);
    }
    if (threadIdx.x == 0) s_count = count;
  }
  __syncthreads();

  const int l = blockIdx.y * kLineTile + threadIdx.x;
  if (l >= n_lines) return;
  const float zv = zvec[l];
  const int count = s_count;
  float acc = 0.0f;
  for (int j = 0; j < count; ++j) {
    const float dz = __fsub_rn(zv, s_bark[j]);
    const float adz = fabsf(dz);
    const float on = adz > 0.5f ? __fsub_rn(adz, 0.5f) : 0.0f;
    float s_db = __fsub_rn(s_base[j], __fmul_rn(27.0f, on));
    s_db = __fadd_rn(s_db, dz >= 0.0f ? __fmul_rn(s_lev[j], on) : 0.0f);
    acc += exp2f(__fmul_rn(kLog2_10_over_10, __fsub_rn(s_db, 96.0f)));
  }
  out[row * n_lines + l] = acc;
}

}  // namespace

extern "C" int pactpu_spread(const float* mspl, const float* lev,
                             const float* bark, const float* valid,
                             const float* drop, const float* zvec, float* out,
                             int rows, int n_slots, int n_lines,
                             cudaStream_t stream) {
  const dim3 grid(rows, (n_lines + kLineTile - 1) / kLineTile);
  const size_t smem = 3 * sizeof(float) * static_cast<size_t>(n_slots);
  spread_kernel<<<grid, kLineTile, smem, stream>>>(
      mspl, lev, bark, valid, drop, zvec, out, n_slots, n_lines);
  return static_cast<int>(cudaGetLastError());
}
