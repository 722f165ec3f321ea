// K8 closed_form: kai's closed-form allocator, its init and its take-back
// loop in one launch (CodecConfig(alloc_mode="closed_form")).
//
// Replaces no Pallas kernel: pactpu runs this allocator as XLA operations,
// a vectorised init (pactpu/ops/bitalloc.py:closed_form_init) and the
// lax.while_loop of closed_form_takeback (bitalloc.py:241; reference
// baselines/kai/bitalloc.py:84-134).  Per row:
//
//   avg  = sum(smr * n_lines) / sum(n_lines)
//   r    = budget / sum(n_lines) + (smr - avg) / 6, bits = floor(r), with
//          r < 2 -> 0 and r capped at max_mant
//   while spent >= budget (at most bands x (max_mant + 1) trips): the first
//          band of least adjusted SMR among those still in the running
//          gives back a bit (a 1-bit band drops to 0), its SMR rises by
//          6 dB, and an emptied band leaves the running.
//
// Once spent < budget a trip of the reference only retires its candidate
// and changes no bits, and spent never rises again, so the row stops
// there: an exact early exit.
//
// The arithmetic is that of pactpu's engine, where the band layout is a
// constant under jit: the mean is XLA's CPU dot (eight running fused
// multiply-adds over bands j = i mod 8 of the whole octets, summed in
// adjacent pairs, then the remaining bands fused one by one into a second
// sum, added last), divided as a product with 1/sum(n_lines); r is
// fma(smr - avg, 1/6, budget * (1/sum(n_lines))).  A fused multiply-add is
// computed as the plain version (kernels.closed_form_plain) computes it:
// float32 as one rounding of the float64 product and sum, float64 by the
// error-free transformations of pactpu_torch/ops/quantize.fma64, so that
// kernel and plain version are bit-equal on the card.
//
// Bound on the H100: latency of a serial loop.  A row's trips are a chain
// of dependent steps (an arg-min over the bands, then one band's update);
// a row takes one trip per bit it gives back.  Rows are independent: one
// warp a row, four warps a block, the bands in lanes as K2 lays them out
// (band b in lane b % 32, slot b / 32: S = 1, 2 or 4 slots in registers up
// to 128 bands, the wide form past that).  A trip is one warp minimum of
// the keys (the SMR mapped to an unsigned integer that orders as the
// floats do, NaN lowest as jnp.argmin takes it, a retired band at +inf),
// one warp minimum of the band index among the lanes that hold it (the
// first-index tie-break) and one shuffle of what the candidate gave back.

#include "kernels.h"
#include "water_fill_step.cuh"

namespace {

constexpr int kWarpsPerBlock = 4;
constexpr int kDotLanes = 8;      // the running sums of XLA's CPU dot

// a * b + c rounded once, as quantize.fma32 (float32: the float64 product
// of two float32 values is exact) and quantize.fma64 (float64: Dekker's
// product and Knuth's sum) compute it
__device__ __forceinline__ float fma_like(float a, float b, float c) {
  return __double2float_rn(
      __dadd_rn(__dmul_rn(static_cast<double>(a), static_cast<double>(b)),
                static_cast<double>(c)));
}

__device__ __forceinline__ void split(double x, double& hi, double& lo) {
  const double t = __dmul_rn(134217729.0, x);   // 2^27 + 1
  hi = __dsub_rn(t, __dsub_rn(t, x));
  lo = __dsub_rn(x, hi);
}

__device__ __forceinline__ double fma_like(double a, double b, double c) {
  const double p = __dmul_rn(a, b);
  double ah, al, bh, bl;
  split(a, ah, al);
  split(b, bh, bl);
  const double e = __dadd_rn(
      __dadd_rn(__dadd_rn(__dsub_rn(__dmul_rn(ah, bh), p), __dmul_rn(ah, bl)),
                __dmul_rn(al, bh)),
      __dmul_rn(al, bl));
  const double s = __dadd_rn(p, c);
  const double bb = __dsub_rn(s, p);
  const double t = __dadd_rn(__dsub_rn(p, __dsub_rn(s, bb)), __dsub_rn(c, bb));
  return __dadd_rn(s, __dadd_rn(t, e));
}

__device__ __forceinline__ float mul_rn(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ double mul_rn(double a, double b) {
  return __dmul_rn(a, b);
}
__device__ __forceinline__ float rcp_rn(float a) { return __fdiv_rn(1.0f, a); }
__device__ __forceinline__ double rcp_rn(double a) {
  return __ddiv_rn(1.0, a);
}

// The arg-min key: ascending as the floats, NaN below everything (jnp.argmin
// takes the first NaN), -0.0 read as +0.0 (x + 0 rounds it so; -0 and +0
// tie in the reference's compare)
template <typename T>
__device__ __forceinline__ auto min_key(T x) {
  return isnan(x) ? decltype(wf::ordered(x))(0)
                  : wf::ordered(wf::add_rn(x, T(0)));
}

template <typename T, int S, bool kWide>
__global__ void closed_form_kernel(const int32_t* __restrict__ budget,
                                   const T* __restrict__ smr,
                                   const int32_t* __restrict__ n_lines,
                                   int32_t* __restrict__ bits_out, int rows,
                                   int n_bands, int max_mant) {
  using Key = decltype(wf::ordered(T(0)));
  const int row = blockIdx.x * kWarpsPerBlock + threadIdx.x / 32;
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;  // the whole warp leaves together
  const T* s_r = smr + static_cast<int64_t>(row) * n_bands;
  const int ns = wf::n_slots<S, kWide>(n_bands);
  const int bud = budget[row];

  // the weighted mean, in the order of XLA's CPU dot
  const int octets = n_bands / kDotLanes * kDotLanes;
  T acc = T(0);
  if (lane < kDotLanes)
    for (int j = lane; j < octets; j += kDotLanes)
      acc = fma_like(s_r[j], static_cast<T>(n_lines[j]), acc);
#pragma unroll
  for (int d = 1; d < kDotLanes; d <<= 1)
    acc = wf::add_rn(acc, __shfl_down_sync(wf::kFull, acc, d));
  T tail = T(0);
  if (lane == 0)
    for (int j = octets; j < n_bands; ++j)
      tail = fma_like(s_r[j], static_cast<T>(n_lines[j]), tail);
  const T dot = __shfl_sync(wf::kFull, wf::add_rn(acc, tail), 0);

  T m[S];
  int nl[S], bits[S];
  bool live[S];
  int lines = 0, spent = 0;
#pragma unroll
  for (int j = 0; j < ns; ++j) {
    const bool real = lane + 32 * j < n_bands;
    m[j] = real ? s_r[lane + 32 * j] : T(INFINITY);
    nl[j] = real ? n_lines[lane + 32 * j] : 0;
    live[j] = real;
    lines += nl[j];
  }
  lines = __reduce_add_sync(wf::kFull, lines);
  const T inv_lines = rcp_rn(static_cast<T>(lines));
  const T avg = mul_rn(dot, inv_lines);
  const T base = mul_rn(static_cast<T>(bud), inv_lines);
  const T sixth = T(1) / T(6);
#pragma unroll
  for (int j = 0; j < ns; ++j) {
    const T r = fma_like(wf::sub_rn(m[j], avg), sixth, base);
    bits[j] = !live[j] || isnan(r) || r < T(2)
                  ? 0
                  : static_cast<int>(floor(fmin(r, static_cast<T>(max_mant))));
    spent += bits[j] * nl[j];
  }
  spent = __reduce_add_sync(wf::kFull, spent);

  const Key dead = wf::ordered(T(INFINITY));
  const int trips = n_bands * (max_mant + 1);
  for (int t = 0; t < trips && spent >= bud; ++t) {
    bool any = false;
    Key kb = dead;          // this lane's least key, its lowest slot on ties
    int jb = 0;
#pragma unroll
    for (int j = 0; j < ns; ++j) {
      any = any || live[j];
      const Key k = live[j] ? min_key(m[j]) : dead;
      if (j == 0 || k < kb) {
        kb = k;
        jb = j;
      }
    }
    if (!__any_sync(wf::kFull, any)) break;
    const Key kmin = wf::warp_min(kb);
    const unsigned cand =
        wf::warp_min(kb == kmin ? 32u * jb + lane : 0xffffffffu);
    int back = 0;           // the bits x lines the candidate gives back
#pragma unroll
    for (int j = 0; j < ns; ++j) {
      if (cand != 32u * j + lane) continue;
      const int cur = bits[j];
      int dec = cur > 0 ? cur - 1 : 0;
      dec = dec == 1 ? 0 : dec;
      back = (cur - dec) * nl[j];
      bits[j] = dec;
      m[j] = wf::add_rn(m[j], T(6));
      live[j] = live[j] && dec != 0;
    }
    spent -= __shfl_sync(wf::kFull, back, static_cast<int>(cand & 31u));
  }

  int32_t* out = bits_out + static_cast<int64_t>(row) * n_bands;
#pragma unroll
  for (int j = 0; j < ns; ++j)
    if (lane + 32 * j < n_bands) out[lane + 32 * j] = bits[j];
}

template <typename T, int S, bool kWide = false>
int launch(const int32_t* budget, const T* smr, const int32_t* n_lines,
           int32_t* bits, int rows, int n_bands, int max_mant,
           cudaStream_t stream) {
  const int blocks = (rows + kWarpsPerBlock - 1) / kWarpsPerBlock;
  closed_form_kernel<T, S, kWide><<<blocks, 32 * kWarpsPerBlock, 0, stream>>>(
      budget, smr, n_lines, bits, rows, n_bands, max_mant);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const int32_t* budget, const T* smr, const int32_t* n_lines,
             int32_t* bits, int rows, int n_bands, int max_mant,
             cudaStream_t stream) {
  const int slots = (n_bands + 31) / 32;
  if (slots <= 1)
    return launch<T, 1>(budget, smr, n_lines, bits, rows, n_bands, max_mant,
                        stream);
  if (slots <= 2)
    return launch<T, 2>(budget, smr, n_lines, bits, rows, n_bands, max_mant,
                        stream);
  if (slots <= 4)
    return launch<T, 4>(budget, smr, n_lines, bits, rows, n_bands, max_mant,
                        stream);
  if (slots <= 32)
    return launch<T, 32, true>(budget, smr, n_lines, bits, rows, n_bands,
                               max_mant, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" int pactpu_closed_form(const int32_t* budget, const float* smr,
                                  const int32_t* n_lines, int32_t* bits,
                                  int rows, int n_bands, int max_mant_bits,
                                  cudaStream_t stream) {
  return dispatch<float>(budget, smr, n_lines, bits, rows, n_bands,
                         max_mant_bits, stream);
}

extern "C" int pactpu_closed_form_f64(const int32_t* budget,
                                      const double* smr,
                                      const int32_t* n_lines, int32_t* bits,
                                      int rows, int n_bands,
                                      int max_mant_bits,
                                      cudaStream_t stream) {
  return dispatch<double>(budget, smr, n_lines, bits, rows, n_bands,
                          max_mant_bits, stream);
}
