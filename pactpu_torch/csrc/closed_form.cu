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
// What bounds it on the H100: not bytes (a row is 100 bytes of SMRs) but
// latency.  Rows are independent: one warp a row, four warps a block, the
// bands in lanes as K2 lays them out (band b in lane b % 32, slot b / 32:
// S = 1, 2 or 4 slots in registers up to 128 bands, the wide form past
// that), so a chunk's 1,024 rows are 256 blocks, resident in one wave on
// the 132 SMs.  The kernel's time is then the launch, plus one row's init,
// plus the longest row's chain of take-back trips (11 on a real chunk, 3.4
// a row on average).  What the design does about each:
//
// - The launch: nothing.  Fusing the two channels' launches into one would
//   change the engine's channel chain for this allocator alone, while K2
//   and K9 keep their pairs; that belongs to the host-dispatch work
//   (ROADMAP queue 1).
// - The init: one coalesced read.  Each lane loads its slots' SMRs and
//   line counts, and the row's budget beside them, in one round trip;
//   XLA's dot order is rebuilt from registers with shuffles (lane l < 8
//   fuses bands l, l + 8, l + 16, ... in that order, then the pairwise
//   tree d = 1, 2, 4, then the tail bands fused one by one), and the line
//   count's sum and reciprocal run beside the dot.  No load depends on
//   another, and n_lines is read once by each lane's own slots, not walked
//   by the dot.
// - The chain: a trip in K2's shape.  The arg-min key is the SMR mapped to
//   an unsigned integer that orders as the floats do (NaN lowest, as
//   jnp.argmin takes the first NaN; -0.0 read as +0.0; a retired band at
//   +inf's key, tied with a live +inf band as the reference's
//   where(valid, smr, inf) ties them).  One warp minimum of the key; the
//   first-index tie-break is the lowest set bit of the ballot of the
//   holders (S = 1: up to 32 bands, the 44.1 kHz layout has 25), or a
//   warp minimum of the band index among the lanes whose best slot holds
//   it (S = 2, 4 and the wide form).  A float64 key is its high word's
//   minimum, then its low word's (wf::warp_min).  While the minimum is in
//   flight each slot works out what it would do as the candidate (its
//   decrement, its 1-bit zeroing, bits x lines given back, its SMR + 6,
//   its retire flag and next key), the last trip's give-back reaches
//   every lane by one shuffle and the live flags are voted on; once the
//   candidate is known only selects are left.  So a trip's take-back is
//   applied only where spent >= budget held after the trip before, as
//   pactpu applies it (apply = active & over, bitalloc.py:217): the exit
//   test runs one trip late, in the shadow of the next minimum.  No branch
//   in the trip but the loop's exit.
//
// What nvcc made of it (H100 80GB HBM3, tools/kernel_ab.py in turns; the
// SASS by cuobjdump): 67 ns a trip in float32 (the parent's 193), 97 in
// float64 (227).  The warp index comes from a shuffle and a warp past the
// last row leaves at once, so that the row's budget, and with it the exit,
// is warp-uniform for the compiler: with the index from threadIdx.x it
// guarded the loop's warp operations with BRA.DIV (float64: 131 ns a
// trip).  The vote on the live flags stays apart from the spent test: one
// vote on both waits for the give-back's shuffle (72 ns).  Slower, and not
// kept: the next trip's minimum issued at the end of the trip (82 ns: ptxas
// then waits for it before the loop's branch), a trip applied at once and
// undone when its test fails (72-83 ns), the loop unrolled twice (73 ns).
// The key of the next trip is a select, not a branch: min_key is worked
// out whether or not the band stays live.
//
// Not in this design: a K9-style jump over take-backs (rows take 3.4
// trips and at most 11 on a real chunk; a jump costs about 9 probes, more
// than the walk it saves), and one launch for both channels (above).

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
__global__ void __launch_bounds__(32 * kWarpsPerBlock)
closed_form_kernel(const int32_t* __restrict__ budget,
                   const T* __restrict__ smr,
                   const int32_t* __restrict__ n_lines,
                   int32_t* __restrict__ bits_out, int rows, int n_bands,
                   int max_mant) {
  using Key = decltype(wf::ordered(T(0)));
  const int lane = threadIdx.x & 31;
  // the warp index from a shuffle: warp-uniform for the compiler, which
  // then guards no warp-wide operation with a convergence check
  const int warp =
      __shfl_sync(wf::kFull, static_cast<int>(threadIdx.x >> 5), 0);
  const int row = blockIdx.x * kWarpsPerBlock + warp;
  if (row >= rows) return;  // the whole warp leaves together
  const T* s_r = smr + static_cast<int64_t>(row) * n_bands;
  const int ns = wf::n_slots<S, kWide>(n_bands);

  // the row, its line counts and its budget in one round trip
  const int bud = budget[row];
  T m[S];
  int nl[S];
  bool live[S];
  int lines = 0;
#pragma unroll
  for (int j = 0; j < ns; ++j) {
    const int b = lane + 32 * j;
    live[j] = b < n_bands;
    m[j] = live[j] ? s_r[b] : T(INFINITY);
    nl[j] = live[j] ? n_lines[b] : 0;
    lines += nl[j];
  }
  lines = __reduce_add_sync(wf::kFull, lines);

  // the weighted mean in the order of XLA's CPU dot: lane l < 8 fuses
  // bands l + 8k of the whole octets (band l + 8k sits in lane l + 8 (k %
  // 4), slot k / 4), the eight sums meet in adjacent pairs, the tail bands
  // are fused one by one into a second sum
  const int octets = n_bands / kDotLanes;
  T acc = T(0);
#pragma unroll
  for (int j = 0; j < ns; ++j) {
#pragma unroll
    for (int q = 0; q < 32 / kDotLanes; ++q) {
      const int src = (lane + kDotLanes * q) & 31;
      const T s = __shfl_sync(wf::kFull, m[j], src);
      const int n = __shfl_sync(wf::kFull, nl[j], src);
      if ((32 / kDotLanes) * j + q < octets)
        acc = fma_like(s, static_cast<T>(n), acc);
    }
  }
#pragma unroll
  for (int d = 1; d < kDotLanes; d <<= 1)
    acc = wf::add_rn(acc, __shfl_down_sync(wf::kFull, acc, d));
  // the tail: fewer than 8 bands, all in one slot, from lane first % 32
  const int first = octets * kDotLanes;
  T tail_m = m[0];
  int tail_n = nl[0];
  if constexpr (kWide) {
    const int tj = min(first / 32, ns - 1);   // past the last slot: no tail
    tail_m = m[tj];
    tail_n = nl[tj];
  } else {
#pragma unroll
    for (int j = 1; j < S; ++j) {
      tail_m = first / 32 == j ? m[j] : tail_m;
      tail_n = first / 32 == j ? nl[j] : tail_n;
    }
  }
  T tail = T(0);
  for (int b = first; b < n_bands; ++b) {
    const int src = b & 31;
    tail = fma_like(__shfl_sync(wf::kFull, tail_m, src),
                    static_cast<T>(__shfl_sync(wf::kFull, tail_n, src)),
                    tail);
  }
  const T dot = __shfl_sync(wf::kFull, wf::add_rn(acc, tail), 0);

  const T inv_lines = rcp_rn(static_cast<T>(lines));
  const T avg = mul_rn(dot, inv_lines);
  const T base = mul_rn(static_cast<T>(bud), inv_lines);
  const T sixth = T(1) / T(6);
  const Key dead = wf::ordered(T(INFINITY));
  int bits[S];
  Key key[S];
  int spent = 0;
#pragma unroll
  for (int j = 0; j < ns; ++j) {
    const T r = fma_like(wf::sub_rn(m[j], avg), sixth, base);
    bits[j] = !live[j] || isnan(r) || r < T(2)
                  ? 0
                  : static_cast<int>(floor(fmin(r, static_cast<T>(max_mant))));
    spent += bits[j] * nl[j];
    key[j] = live[j] ? min_key(m[j]) : dead;
  }
  spent = __reduce_add_sync(wf::kFull, spent);

  const int trips = n_bands * (max_mant + 1);
  int back = 0;             // what this lane's band gave back as the last
  int cand_lane = 0;        // trip's candidate, and that candidate's lane
  for (int t = 0; t < trips; ++t) {
    Key kb = key[0];        // this lane's least key, its lowest slot on ties
    int jb = 0;
#pragma unroll
    for (int j = 1; j < ns; ++j)
      if (key[j] < kb) {
        kb = key[j];
        jb = j;
      }
    const Key kmin = wf::warp_min(kb);
    // While the minimum is taken: the last trip's give-back, the vote on
    // the live flags, and what each slot does IF it is the candidate.
    spent -= __shfl_sync(wf::kFull, back, cand_lane);
    bool any = false;
    int dec[S], give[S];
    T m_next[S];
    Key key_next[S];
    bool live_next[S];
#pragma unroll
    for (int j = 0; j < ns; ++j) {
      any = any || live[j];
      const int cur = bits[j];
      dec[j] = cur > 2 ? cur - 1 : 0;               // 1-bit zeroing
      give[j] = (cur - dec[j]) * nl[j];
      m_next[j] = wf::add_rn(m[j], T(6));
      live_next[j] = live[j] && dec[j] != 0;
      const Key k = min_key(m_next[j]);   // worked out live or not: a select
      key_next[j] = live_next[j] ? k : dead;
    }
    if (!__any_sync(wf::kFull, any) || spent < bud) break;
    bool me[S];
    if constexpr (S == 1) {
      // the candidate: the first lane that holds the minimum
      const unsigned holders = __ballot_sync(wf::kFull, kb == kmin);
      const unsigned lowest = holders & (0u - holders);
      me[0] = lowest == (1u << lane);
      cand_lane = __popc(lowest - 1u);
      back = give[0];
    } else {
      // the candidate: the lowest band index among the lanes' bests that
      // hold the minimum
      const unsigned cand = __reduce_min_sync(
          wf::kFull, kb == kmin ? 32u * jb + lane : 0xffffffffu);
      cand_lane = static_cast<int>(cand & 31u);
      back = 0;
#pragma unroll
      for (int j = 0; j < ns; ++j) {
        me[j] = cand == 32u * j + lane;
        back = me[j] ? give[j] : back;
      }
    }
#pragma unroll
    for (int j = 0; j < ns; ++j) {
      bits[j] = me[j] ? dec[j] : bits[j];
      m[j] = me[j] ? m_next[j] : m[j];
      live[j] = me[j] ? live_next[j] : live[j];
      key[j] = me[j] ? key_next[j] : key[j];
    }
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
