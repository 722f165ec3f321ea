// K4 spread_up: the tonal-level-dependent upward slope of the masking sum.
//
// Replaces pactpu/ops/pallas_ops.py:_make_spread_up_kernel (via
// _spread_up_call / spread_maskers_up), used by the dense masked-threshold
// path of pactpu/ops/psycho.py:249-272:
//
//   out[b, l] = sum_k iprime[b, k] * 10^((0.367 max(mspl[b, k] - 40, 0) - 27)
//                                        * (dz - 0.5) / 10),
//   over the pairs with dz = zvec[l] - bark[k] > 0.5.
//
// Bound on the H100: operations, and among them the special-function unit
// (one exp2 per (row, peak masker, line above its plateau) triple, 16 a
// clock an SM) and the eight or so instructions around each exp2 (one warp
// instruction a clock a scheduler); the inputs and the output are a few
// tens of MB.  Only the peaks carry a nonzero iprime (a
// few hundred of the 1,024 bins), so the design does the work the inputs
// need and no more:
//
// - One block a row.  Its eight warps first compact the row's nonzero
//   maskers, in ascending order, into shared memory (warp ballots and prefix
//   popcounts; each warp takes one contiguous eighth of the bins), storing
//   per masker one float4 {bark, iprime, slope}, slope = log2(10)/10 *
//   (0.367 max(mspl - 40, 0) - 27) computed once.  The masker loop then runs
//   over the peaks only, and one 16-byte broadcast load fetches a masker.
// - Four lines a thread.  A warp owns four spans of 32 consecutive lines
//   (coalesced stores); a masker fetched once feeds four sums in registers,
//   and the four independent exp2 chains hide the unit's latency.  Warp w
//   takes spans w, 15-w, 16+w and 31-w of the 32 in a 1,024-line tile, so
//   that low and high lines (few and many maskers in reach) balance.
// - The exact range skip, per span: both bark grids ascend, so the maskers
//   whose plateau ends below the span's last line are a prefix of the
//   compacted list (float32 subtraction is monotone, so the test that drops
//   a masker for the last line drops it for every line of the span).  The
//   prefix lengths of a warp's four spans ascend too: the loop runs in four
//   stretches, the first with all four spans, the last with one.  A line
//   below a masker's plateau adds nothing (a predicated add, not a product
//   with zero).
// - exp2f without its denormal range where that is exact.  exp2f(x) is the
//   unit's ex2 plus three instructions that matter only for x < -126.  The
//   slope is at least log2(10)/10 * -27 = -8.97 a bark, so a masker whose
//   farthest line in the warp's spans is at most 14 bark past its plateau
//   has every exponent above -125.6 and takes the bare instruction, with
//   exp2f's bits.  The maskers farther away than that are again a prefix of
//   the list (`deep`); only they pay for the full exp2f.
//
// Each term is computed with the plain version's unfused float32
// operations, so it has the plain version's bits up to exp2f's rounding;
// the sum runs in masker order with a fused multiply-add, not in the plain
// version's order.
//
// The float64 form (precision="f64", where pactpu runs its XLA loop in
// float64, psycho.py:247) is the same kernel on double: a masker is three
// doubles, every exponent takes the double exp2 (ex2.approx is float32
// only, and the -126 shortcut has no double counterpart), the terms use the
// plain version's unfused double operations.

#include <math.h>

#include "kernels.h"

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kSpans = 4;                       // 32-line spans a warp owns
constexpr int kLineTile = 32 * kSpans * kWarps; // lines a block covers a pass
// log2(10) / 10, the constant of pactpu/ops/pallas_ops.py:34 in float32
constexpr float kLog2_10_over_10 = 0.33219280948873623f;
// the same in float64, as the plain version holds it (numpy's log2(10) / 10)
constexpr double kLog2_10_over_10_f64 = 0.3321928094887362;

// 14 bark at the steepest slope, log2(10)/10 * -27 a bark, is an exponent
// of -125.6: above exp2f's denormal range, which begins at -126
constexpr float kDeepBark = 14.0f;

// A compacted masker: {bark, iprime, slope}; float4 (one 16-byte load) or
// three doubles.
template <typename T> struct Masker;
template <> struct Masker<float> { using type = float4; };
template <> struct Masker<double> { struct type { double x, y, z; }; };

__device__ __forceinline__ float sub_rn(float a, float b) {
  return __fsub_rn(a, b);
}
__device__ __forceinline__ double sub_rn(double a, double b) {
  return __dsub_rn(a, b);
}
__device__ __forceinline__ float mul_rn(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ double mul_rn(double a, double b) {
  return __dmul_rn(a, b);
}

// 2^x: exp2f, or its bare instruction where no x lies below -126; exp2 in
// double
template <bool kDeep>
__device__ __forceinline__ float exp2_term(float x) {
  float e;
  if (kDeep) {
    e = exp2f(x);
  } else {
    asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(e) : "f"(x));
  }
  return e;
}
template <bool kDeep>
__device__ __forceinline__ double exp2_term(double x) {
  return exp2(x);
}

// The sums of spans I0.. over the maskers [begin, end); kDeep: some exponent
// may lie below -126.
template <int I0, bool kDeep, typename T>
__device__ __forceinline__ void accumulate(
    const typename Masker<T>::type* __restrict__ s_m, int begin, int end,
    const T (&zv)[kSpans], T (&acc)[kSpans]) {
  for (int j = begin; j < end; ++j) {
    const auto m = s_m[j];                      // {bark, iprime, slope}
#pragma unroll
    for (int i = I0; i < kSpans; ++i) {
      const T dz = sub_rn(zv[i], T(m.x));
      const T x = mul_rn(T(m.z), sub_rn(dz, T(0.5)));
      const T e = exp2_term<kDeep>(x);
      if (dz > T(0.5)) acc[i] = fma(T(m.y), e, acc[i]);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
spread_up_kernel(const T* __restrict__ iprime, const T* __restrict__ mspl,
                 const T* __restrict__ bark, const T* __restrict__ zvec,
                 T* __restrict__ out, int n_maskers, int n_lines) {
  using M = typename Masker<T>::type;
  extern __shared__ __align__(16) unsigned char smem[];
  M* s_m = reinterpret_cast<M*>(smem);          // the row's peaks, compacted
  __shared__ int s_cnt[kWarps];
  constexpr bool kDouble = sizeof(T) == 8;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x & 31;
  const int64_t row = blockIdx.x;
  const T* ip_r = iprime + row * n_maskers;
  const T* ms_r = mspl + row * n_maskers;

  // compaction: warp w counts, then writes, the peaks of its bins
  const int seg = (n_maskers + kThreads - 1) / kThreads * 32;
  const int k_begin = warp * seg;
  int mine = 0;
  for (int k0 = k_begin; k0 < k_begin + seg; k0 += 32) {
    const int k = k0 + lane;
    mine += __popc(__ballot_sync(kFull, k < n_maskers && ip_r[k] != T(0)));
  }
  if (lane == 0) s_cnt[warp] = mine;
  __syncthreads();
  int at = 0, count = 0;
  for (int w = 0; w < kWarps; ++w) {
    if (w < warp) at += s_cnt[w];
    count += s_cnt[w];
  }
  for (int k0 = k_begin; k0 < k_begin + seg; k0 += 32) {
    const int k = k0 + lane;
    const T ip = k < n_maskers ? ip_r[k] : T(0);
    const bool peak = ip != T(0);
    const unsigned m = __ballot_sync(kFull, peak);
    if (peak) {
      const T lev = mul_rn(T(0.367), fmax(sub_rn(ms_r[k], T(40)), T(0)));
      const T c = kDouble ? T(kLog2_10_over_10_f64) : T(kLog2_10_over_10);
      M rec;
      rec.x = bark[k];
      rec.y = ip;
      rec.z = mul_rn(c, sub_rn(lev, T(27)));
      s_m[at + __popc(m & ((1u << lane) - 1u))] = rec;
    }
    at += __popc(m);
  }
  __syncthreads();

  for (int l0 = 0; l0 < n_lines; l0 += kLineTile) {
    int base[kSpans] = {l0 + 32 * warp, l0 + 32 * (2 * kWarps - 1 - warp),
                        l0 + 32 * (2 * kWarps + warp),
                        l0 + 32 * (4 * kWarps - 1 - warp)};
    T zv[kSpans], z_last[kSpans], acc[kSpans];
#pragma unroll
    for (int i = 0; i < kSpans; ++i) {
      const int l = base[i] + lane;
      zv[i] = l < n_lines ? zvec[l] : T(0);
      // a span past the last line reaches no masker
      z_last[i] = base[i] < n_lines ? zvec[min(base[i] + 31, n_lines - 1)]
                                    : T(-INFINITY);
      acc[i] = T(0);
    }
    // end[i]: the maskers that reach span i's last line, a prefix; deep:
    // those whose upslope runs more than kDeepBark to the warp's last line
    int end[kSpans] = {0, 0, 0, 0};
    int deep = 0;
    T z_top = T(-INFINITY);
#pragma unroll
    for (int i = 0; i < kSpans; ++i) z_top = fmax(z_top, z_last[i]);
    for (int j = lane; j < count; j += 32) {
      const T b = s_m[j].x;
      deep += kDouble || sub_rn(sub_rn(z_top, b), T(0.5)) > T(kDeepBark);
#pragma unroll
      for (int i = 0; i < kSpans; ++i)
        end[i] += sub_rn(z_last[i], b) > T(0.5);
    }
#pragma unroll
    for (int i = 0; i < kSpans; ++i) end[i] = __reduce_add_sync(kFull, end[i]);
    deep = __reduce_add_sync(kFull, deep);

    // masker order throughout: each stretch first its deep part (in
    // double every masker is "deep": one exp2 for all)
    accumulate<0, true>(s_m, 0, min(end[0], deep), zv, acc);
    accumulate<0, false>(s_m, deep, end[0], zv, acc);
    accumulate<1, true>(s_m, end[0], min(end[1], deep), zv, acc);
    accumulate<1, false>(s_m, max(end[0], deep), end[1], zv, acc);
    accumulate<2, true>(s_m, end[1], min(end[2], deep), zv, acc);
    accumulate<2, false>(s_m, max(end[1], deep), end[2], zv, acc);
    accumulate<3, true>(s_m, end[2], min(end[3], deep), zv, acc);
    accumulate<3, false>(s_m, max(end[2], deep), end[3], zv, acc);
#pragma unroll
    for (int i = 0; i < kSpans; ++i) {
      const int l = base[i] + lane;
      if (l < n_lines) out[row * n_lines + l] = acc[i];
    }
  }
}

template <typename T>
int launch(const T* iprime, const T* mspl, const T* bark, const T* zvec,
           T* out, int rows, int n_maskers, int n_lines,
           cudaStream_t stream) {
  const size_t smem =
      sizeof(typename Masker<T>::type) * static_cast<size_t>(n_maskers);
  if (smem > 48 * 1024) {       // past the default limit of a block
    const cudaError_t rc = cudaFuncSetAttribute(
        spread_up_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (rc != cudaSuccess) return static_cast<int>(rc);
  }
  spread_up_kernel<T><<<rows, kThreads, smem, stream>>>(
      iprime, mspl, bark, zvec, out, n_maskers, n_lines);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int pactpu_spread_up(const float* iprime, const float* mspl,
                                const float* bark, const float* zvec,
                                float* out, int rows, int n_maskers,
                                int n_lines, cudaStream_t stream) {
  return launch<float>(iprime, mspl, bark, zvec, out, rows, n_maskers,
                       n_lines, stream);
}

extern "C" int pactpu_spread_up_f64(const double* iprime, const double* mspl,
                                    const double* bark, const double* zvec,
                                    double* out, int rows, int n_maskers,
                                    int n_lines, cudaStream_t stream) {
  return launch<double>(iprime, mspl, bark, zvec, out, rows, n_maskers,
                        n_lines, stream);
}
