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
// Bound on the H100: operations.  Every (row, valid slot, line) triple costs
// one exp2 on the special-function unit (16 a clock an SM) and the float32
// instructions around it (one warp instruction a clock a scheduler); the
// inputs and the output are a few tens of MB.  Unlike K4 every valid slot
// reaches every line through one slope or the other, so no work can be
// skipped; the design spends as few instructions a term as the plain
// version's arithmetic allows:
//
// - One block a row.  Its eight warps compact the row's valid slots once
//   into shared memory (warp ballots and prefix popcounts, each warp one
//   contiguous eighth of the slots), one float4 {bark, mspl - drop, lev,
//   plateau term} a slot, fetched in the loop by one 16-byte broadcast load.
// - The list in ascending bark order.  On the aidan path the valid slots
//   arrive in descending order (a top-k over bin indices), so one vote
//   finds that and the list is reversed in place; an ascending list stays;
//   anything else goes through a bitonic sort in shared memory (the list is
//   padded to a power of two with slots at +inf).  The sum runs in that
//   order, not in slot order.
// - Four lines a thread: a warp owns 128 consecutive lines of a 1,024-line
//   tile as four 32-line spans (coalesced stores); a slot fetched once feeds
//   four sums in registers, and the four independent exp2 chains hide the
//   unit's latency.
// - Stretches of the list for a warp's 128 lines, found by counting (float32
//   subtraction is monotone, so the test at the group's lowest or highest
//   line holds for all of them): a prefix of slots that every line sees from
//   above by at least half a bark (upslope: no |dz|, no max, no select), a
//   suffix that every line sees from below (downslope: no lev term at all),
//   and the slots between, which take the general term, except those whose
//   plateau (|dz| <= 0.5) holds all 128 lines: their term is one value,
//   computed at compaction and added as it is.  High lines are dense in
//   bark (the last 128 of 1,024 span a quarter of a bark), so there this
//   stretch is most of what lies between.
// - exp2f without its denormal range where that is exact.  exp2f(x) is the
//   unit's ex2 plus three instructions that matter only for x < -126.  With
//   the row's lowest mspl - drop and lowest lev, an exponent stays above
//   -125 while the slot is less than `reach` bark past its plateau
//   (spread_kernel computes it); the slots farther than that from the
//   group's far line are a prefix of the upslope stretch and a suffix of
//   the downslope stretch, and only they, and the middle stretch of a group
//   wider than `reach`, pay for the full exp2f.
//
// Each term is computed with the plain version's unfused float32 operations
// in the plain version's order, so it has the plain version's bits up to
// exp2f's rounding (a fused form, one multiply-add a term, rounds single
// far terms differently by more than the tolerance: tools/
// k6_fused_rounding.py); only the order of the sum differs.  The TPU kernel
// needed a slot count that is a multiple of 128 lanes; this one takes any
// count up to 4,096, any line count and any slot order.  Barks must not be
// NaN (they have no order).
//
// The float64 form (precision="f64" with peak_mode "para" or "weighted",
// where pactpu runs its compact path in float64, psycho.py:275-310) is the
// same kernel on double: a slot is four doubles {bark, mspl - drop, lev,
// plateau term} (32 KB of shared memory for the 513 slots of a 2,048-point
// block, padded to 1,024 for the sort), every term takes the double exp2
// (ex2.approx is float32 only, and the -126 shortcut has no double
// counterpart), with the plain version's unfused double operations.

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
// the bare ex2 serves where every exponent stays above this (exp2f's
// denormal range begins at -126; the margin covers the rounding of the
// bound)
constexpr float kBareExponent = -125.0f;

enum Side { kUp, kBoth, kFlat, kDown };

// A compacted slot {bark, mspl - drop, lev, plateau term}: float4 (one
// 16-byte load) or four doubles.
template <typename T> struct Slot;
template <> struct Slot<float> { using type = float4; };
template <> struct Slot<double> { struct type { double x, y, z, w; }; };

template <typename T>
__device__ __forceinline__ typename Slot<T>::type make_slot(T x, T y, T z,
                                                            T w) {
  typename Slot<T>::type s;
  s.x = x;
  s.y = y;
  s.z = z;
  s.w = w;
  return s;
}

__device__ __forceinline__ float add_rn(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ double add_rn(double a, double b) {
  return __dadd_rn(a, b);
}
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

template <typename T> __device__ __forceinline__ T log2_10_over_10();
template <> __device__ __forceinline__ float log2_10_over_10<float>() {
  return kLog2_10_over_10;
}
template <> __device__ __forceinline__ double log2_10_over_10<double>() {
  return kLog2_10_over_10_f64;
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

// The sums of a warp's four spans over the slots [begin, end).  kSide: every
// line is on the slots' upslope, on their downslope, on their plateau
// (kFlat), or any of these; kDeep: some exponent may lie below -126.
template <Side kSide, bool kDeep, typename T>
__device__ __forceinline__ void accumulate(
    const typename Slot<T>::type* __restrict__ s_m, int begin, int end,
    const T (&zv)[kSpans], T (&acc)[kSpans]) {
  const T c = log2_10_over_10<T>();
  for (int j = begin; j < end; ++j) {
    const auto m = s_m[j];          // {bark, mspl - drop, lev, plateau term}
#pragma unroll
    for (int i = 0; i < kSpans; ++i) {
      if (kSide == kFlat) {                     // |dz| <= 0.5: on = 0
        acc[i] += m.w;
        continue;
      }
      const T dz = sub_rn(zv[i], T(m.x));
      T on, s_db;
      if (kSide == kUp) {                       // dz >= 0.5
        on = sub_rn(dz, T(0.5));
        s_db = add_rn(sub_rn(T(m.y), mul_rn(T(27), on)), mul_rn(T(m.z), on));
      } else if (kSide == kDown) {              // dz <= -0.5
        on = sub_rn(-dz, T(0.5));
        s_db = sub_rn(T(m.y), mul_rn(T(27), on));
      } else {
        on = fmax(sub_rn(fabs(dz), T(0.5)), T(0));
        s_db = add_rn(sub_rn(T(m.y), mul_rn(T(27), on)),
                      mul_rn(dz >= T(0) ? T(m.z) : T(0), on));
      }
      acc[i] += exp2_term<kDeep>(mul_rn(c, sub_rn(s_db, T(96))));
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
spread_kernel(const T* __restrict__ mspl, const T* __restrict__ lev,
              const T* __restrict__ bark, const T* __restrict__ valid,
              const T* __restrict__ drop, const T* __restrict__ zvec,
              T* __restrict__ out, int n_slots, int n_lines) {
  using M = typename Slot<T>::type;
  extern __shared__ __align__(16) unsigned char smem[];
  M* s_m = reinterpret_cast<M*>(smem);          // the row's slots, compacted
  __shared__ int s_cnt[kWarps];
  __shared__ T s_low[2][kWarps];                // lowest mspl - drop, lev
  constexpr bool kDouble = sizeof(T) == 8;
  const T c = log2_10_over_10<T>();
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x & 31;
  const int64_t row = blockIdx.x;
  const T* va_r = valid + row * n_slots;
  const T* ms_r = mspl + row * n_slots;
  const T* lv_r = lev + row * n_slots;
  const T* bk_r = bark + row * n_slots;
  const T d = drop[row];

  // compaction: warp w counts, then writes, the valid slots of its eighth
  const int seg = (n_slots + kThreads - 1) / kThreads * 32;
  const int k_begin = warp * seg;
  int mine = 0;
  for (int k0 = k_begin; k0 < k_begin + seg; k0 += 32) {
    const int k = k0 + lane;
    mine += __popc(__ballot_sync(kFull, k < n_slots && va_r[k] != T(0)));
  }
  if (lane == 0) s_cnt[warp] = mine;
  __syncthreads();
  int at = 0, count = 0;
  for (int w = 0; w < kWarps; ++w) {
    if (w < warp) at += s_cnt[w];
    count += s_cnt[w];
  }
  T low_base = T(INFINITY), low_lev = T(INFINITY);
  for (int k0 = k_begin; k0 < k_begin + seg; k0 += 32) {
    const int k = k0 + lane;
    const bool v = k < n_slots && va_r[k] != T(0);
    const unsigned m = __ballot_sync(kFull, v);
    if (v) {
      const T base = sub_rn(ms_r[k], d);
      const T lv = lv_r[k];
      // the term of a line on the plateau: on = 0 leaves mspl - drop
      s_m[at + __popc(m & ((1u << lane) - 1u))] = make_slot<T>(
          bk_r[k], base, lv, exp2_term<true>(mul_rn(c, sub_rn(base, T(96)))));
      low_base = fmin(low_base, base);
      low_lev = fmin(low_lev, lv);
    }
    at += __popc(m);
  }
#pragma unroll
  for (int s = 16; s > 0; s >>= 1) {
    low_base = fmin(low_base, __shfl_xor_sync(kFull, low_base, s));
    low_lev = fmin(low_lev, __shfl_xor_sync(kFull, low_lev, s));
  }
  if (lane == 0) {
    s_low[0][warp] = low_base;
    s_low[1][warp] = low_lev;
  }
  __syncthreads();

  // ascending bark order: as it is, by reversal, or by a bitonic sort
  int falls = 0, rises = 0;
  for (int j = threadIdx.x; j + 1 < count; j += kThreads) {
    falls |= s_m[j].x > s_m[j + 1].x;
    rises |= s_m[j].x < s_m[j + 1].x;
  }
  falls = __syncthreads_or(falls);
  rises = __syncthreads_or(rises);
  if (falls && !rises) {
    for (int j = threadIdx.x; j < count / 2; j += kThreads) {
      const M a = s_m[j];
      s_m[j] = s_m[count - 1 - j];
      s_m[count - 1 - j] = a;
    }
  } else if (falls) {
    int padded = 1;
    while (padded < count) padded <<= 1;
    for (int j = count + threadIdx.x; j < padded; j += kThreads)
      s_m[j] = make_slot<T>(T(INFINITY), T(0), T(0), T(0));
    for (int size = 2; size <= padded; size <<= 1) {
      for (int stride = size >> 1; stride > 0; stride >>= 1) {
        __syncthreads();
        for (int t = threadIdx.x; t < padded / 2; t += kThreads) {
          const int lo = 2 * t - (t & (stride - 1));
          const M a = s_m[lo], b = s_m[lo + stride];
          if ((a.x > b.x) == ((lo & size) == 0)) {
            s_m[lo] = b;
            s_m[lo + stride] = a;
          }
        }
      }
    }
  }
  __syncthreads();

  // an exponent is log2(10)/10 (mspl - drop - 96 - slope on) with a slope of
  // at most 27 - min(lev, 0): above kBareExponent while on < reach (in
  // double every slot is "far": every term takes exp2)
  low_base = s_low[0][0];
  low_lev = s_low[1][0];
  for (int w = 1; w < kWarps; ++w) {
    low_base = fmin(low_base, s_low[0][w]);
    low_lev = fmin(low_lev, s_low[1][w]);
  }
  const T reach =
      kDouble ? T(-INFINITY)
              : T((float(low_base) - 96.0f -
                   kBareExponent / kLog2_10_over_10) /
                  (27.0f - fminf(float(low_lev), 0.0f)));

  for (int l0 = 0; l0 < n_lines; l0 += kLineTile) {
    const int first = l0 + 32 * kSpans * warp;  // the warp's 128 lines
    if (first >= n_lines) continue;
    T zv[kSpans], acc[kSpans];
    T z_lo = T(INFINITY), z_hi = T(-INFINITY);
#pragma unroll
    for (int i = 0; i < kSpans; ++i) {
      const int l = first + 32 * i + lane;
      zv[i] = l < n_lines ? zvec[l] : T(0);
      if (l < n_lines) {
        z_lo = fmin(z_lo, zv[i]);
        z_hi = fmax(z_hi, zv[i]);
      }
      acc[i] = T(0);
    }
#pragma unroll
    for (int s = 16; s > 0; s >>= 1) {
      z_lo = fmin(z_lo, __shfl_xor_sync(kFull, z_lo, s));
      z_hi = fmax(z_hi, __shfl_xor_sync(kFull, z_hi, s));
    }
    // up: the slots at least half a bark below every line, a prefix; down:
    // those at least half a bark above every line, a suffix; far_*: those
    // of each whose farthest line is more than `reach` past the plateau
    // below/above: the slots whose plateau ends under the highest line or
    // begins over the lowest; between them, those whose plateau holds all
    // 128 lines (none if the lines span more than a bark)
    int up = 0, down = 0, far_up = 0, far_down = 0, below = 0, above = 0;
    for (int j = lane; j < count; j += 32) {
      const T b = s_m[j].x;
      up += sub_rn(z_lo, b) >= T(0.5);
      down += sub_rn(z_hi, b) <= T(-0.5);
      below += sub_rn(z_hi, b) > T(0.5);
      above += sub_rn(z_lo, b) < T(-0.5);
      far_up += !(sub_rn(sub_rn(z_hi, b), T(0.5)) < reach);
      far_down += !(sub_rn(sub_rn(b, z_lo), T(0.5)) < reach);
    }
    up = __reduce_add_sync(kFull, up);
    down = count - __reduce_add_sync(kFull, down);  // where the suffix begins
    far_up = min(__reduce_add_sync(kFull, far_up), up);
    far_down = max(count - __reduce_add_sync(kFull, far_down), down);
    int flat = max(__reduce_add_sync(kFull, below), up);
    int flat_end = min(count - __reduce_add_sync(kFull, above), down);
    if (flat >= flat_end) flat = flat_end = down;   // no such slot
    const bool far_both = !(sub_rn(z_hi, z_lo) < reach);

    accumulate<kUp, true, T>(s_m, 0, far_up, zv, acc);
    accumulate<kUp, false, T>(s_m, far_up, up, zv, acc);
    if (far_both) {
      accumulate<kBoth, true, T>(s_m, up, flat, zv, acc);
      accumulate<kBoth, true, T>(s_m, flat_end, down, zv, acc);
    } else {
      accumulate<kBoth, false, T>(s_m, up, flat, zv, acc);
      accumulate<kBoth, false, T>(s_m, flat_end, down, zv, acc);
    }
    accumulate<kFlat, false, T>(s_m, flat, flat_end, zv, acc);
    accumulate<kDown, false, T>(s_m, down, far_down, zv, acc);
    accumulate<kDown, true, T>(s_m, far_down, count, zv, acc);
#pragma unroll
    for (int i = 0; i < kSpans; ++i) {
      const int l = first + 32 * i + lane;
      if (l < n_lines) out[row * n_lines + l] = acc[i];
    }
  }
}

template <typename T>
int launch(const T* mspl, const T* lev, const T* bark, const T* valid,
           const T* drop, const T* zvec, T* out, int rows, int n_slots,
           int n_lines, cudaStream_t stream) {
  int padded = 1;               // room for the sort's padding
  while (padded < n_slots) padded <<= 1;
  const size_t smem =
      sizeof(typename Slot<T>::type) * static_cast<size_t>(padded);
  if (smem > 48 * 1024) {       // past the default limit of a block
    const cudaError_t rc = cudaFuncSetAttribute(
        spread_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (rc != cudaSuccess) return static_cast<int>(rc);
  }
  spread_kernel<T><<<rows, kThreads, smem, stream>>>(
      mspl, lev, bark, valid, drop, zvec, out, n_slots, n_lines);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int pactpu_spread(const float* mspl, const float* lev,
                             const float* bark, const float* valid,
                             const float* drop, const float* zvec, float* out,
                             int rows, int n_slots, int n_lines,
                             cudaStream_t stream) {
  return launch<float>(mspl, lev, bark, valid, drop, zvec, out, rows,
                       n_slots, n_lines, stream);
}

extern "C" int pactpu_spread_f64(const double* mspl, const double* lev,
                                 const double* bark, const double* valid,
                                 const double* drop, const double* zvec,
                                 double* out, int rows, int n_slots,
                                 int n_lines, cudaStream_t stream) {
  return launch<double>(mspl, lev, bark, valid, drop, zvec, out, rows,
                        n_slots, n_lines, stream);
}
