// The greedy water-filling of one row by one warp, shared by K2
// (water_fill.cu: one row a warp, many rows) and K7 (exact_scan.cu: a
// chain of rows, one after the other, in one warp); its keys, warp
// reductions and rounded operations also serve K8 (closed_form.cu) and K9
// (grant_fill.cu), the other allocators' loops in the same layout.
//
// The reference's allocator (reference codec/bitalloc.py:129-184; the XLA
// loop of pactpu/ops/bitalloc.py:66-119): a step grants one bit to the
// first band of largest smr - 6 bits among the bands still in the running;
// the stop rule compares max over ALL bands of smr - 6 (bits - 1) with the
// candidate band's threshold (M/S or L/R); a band that cannot be paid for,
// reaches the cap, or stops the rule leaves the running; the 1-bit bands
// are refunded at the end.
//
// Band b lives in lane b % 32, slot b / 32 (S slots a lane, S = 1 for up
// to 32 bands), every slot's state (bits, 6 bits, key, stop statistic,
// retired flag) in registers for S = 1, 2 and 4 (up to 128 bands).  Wider
// layouts (up to 1,024 bands, none in the repo's configurations) take the
// wide form (n_slots): the same step over arrays of 32 slots with the
// count of slots read at run time, its loops rolled and its arrays in
// local memory, a slower step that compiles in seconds where an unrolled
// S = 32 spills and takes the build ten times as long.  A step is one warp
// maximum of the keys and
// the selects that follow; everything else runs in the maximum's shadow,
// on operands that were ready at the last step's end:
//
// - The arg-max: the key smr - 6 bits maps to an unsigned integer that
//   orders as the floats do.  For float, one __reduce_max_sync; for double
//   the 64-bit key's high word, then the low word among the lanes whose
//   high word is the maximum (__reduce_max_sync takes 32 bits).
// - The first-index tie-break, which the reference's arg-max takes (the
//   lowest band index among equal keys): with one slot a lane, the lowest
//   set bit of the ballot of the lanes that hold the maximum.  With several
//   slots a lane the lowest lane holding the maximum need not hold the
//   lowest band (band 33 in lane 1 comes after band 2 in lane 2), so each
//   lane takes its own best (its lowest slot on ties), and a warp minimum
//   of the global index among the lanes that hold the maximum names the
//   candidate.
// - The stop rule `max of the statistic < threshold` is the vote `every
//   slot's statistic < threshold`, taken for both thresholds; the
//   candidate's own M/S flag picks one.  What the last candidate paid
//   reaches the other lanes by one shuffle.  Each slot works out what it
//   would do as the candidate, so that once the candidate is known only
//   selects are left.
// - No branch in the step but the loop's exit (a vote on the live flags:
//   from there every step is a no-op), and no case for padding slots
//   (band >= n_bands): they hold -inf, never retire, and a real band
//   holds at least -inf too and a lower index, so padding never wins.
//
// -0.0 and +0.0 must tie: an SMR of -0.0 is read as +0.0 (x + 0 rounds
// it so), after which no key can be -0.0 (x - x is +0.0).  A NaN SMR, of
// either sign, has the largest key (above +inf's) and fails every `<`, as
// the plain version's arg-max and max treat it.
// A retired band's key is that of float32(-1e30), the reference's
// _NEG, in either type.
#pragma once

#include <math.h>

#include <cstdint>

namespace wf {

constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ unsigned ordered(float f) {
  const unsigned u = __float_as_uint(f);
  return u ^ (static_cast<unsigned>(static_cast<int>(u) >> 31) | 0x80000000u);
}

// Any NaN above +inf: float32 arithmetic on the card gives one canonical
// NaN (positive), float64 arithmetic keeps a NaN's sign and payload, so
// the double key maps every NaN to the largest key itself.
__device__ __forceinline__ unsigned long long ordered(double f) {
  if (isnan(f)) return ~0ull;
  const unsigned long long u =
      static_cast<unsigned long long>(__double_as_longlong(f));
  return u ^ (static_cast<unsigned long long>(static_cast<long long>(u) >> 63)
              | 0x8000000000000000ull);
}

__device__ __forceinline__ unsigned warp_max(unsigned k) {
  return __reduce_max_sync(kFull, k);
}

__device__ __forceinline__ unsigned long long warp_max(unsigned long long k) {
  const unsigned hi_k = static_cast<unsigned>(k >> 32);
  const unsigned hi = __reduce_max_sync(kFull, hi_k);
  const unsigned lo =
      __reduce_max_sync(kFull, hi_k == hi ? static_cast<unsigned>(k) : 0u);
  return (static_cast<unsigned long long>(hi) << 32) | lo;
}

__device__ __forceinline__ unsigned warp_min(unsigned k) {
  return __reduce_min_sync(kFull, k);
}

__device__ __forceinline__ unsigned long long warp_min(unsigned long long k) {
  const unsigned hi_k = static_cast<unsigned>(k >> 32);
  const unsigned hi = __reduce_min_sync(kFull, hi_k);
  const unsigned lo = __reduce_min_sync(
      kFull, hi_k == hi ? static_cast<unsigned>(k) : 0xffffffffu);
  return (static_cast<unsigned long long>(hi) << 32) | lo;
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

// Slots a lane: S in the register forms; in the wide form (kWide, S = 32)
// the count n_bands needs, unknown at compile time, so that a
// `#pragma unroll` loop over the slots is not unrolled.
template <int S, bool kWide>
__device__ __forceinline__ int n_slots(int n_bands) {
  return kWide ? (n_bands + 31) / 32 : S;
}

// The row's fill.  smr: slot j's SMR (anything for a padding slot); ms:
// bit j set if slot j's band is coded M/S; nl: slot j's line count (0 for
// padding).  Writes bits (slot j's allocation after the refund) and
// returns the leftover after the refund, on every lane.
template <typename T, int S, bool kWide>
__device__ __forceinline__ int fill_row(const T (&smr)[S], unsigned ms,
                                        const int (&nl)[S], int n_bands,
                                        int total, int max_mant, T ms_stop,
                                        T lr_stop, int (&bits)[S]) {
  using Key = decltype(ordered(T(0)));
  const int lane = threadIdx.x & 31;
  const Key dead_key = ordered(static_cast<T>(-1e30f));
  const int ns = n_slots<S, kWide>(n_bands);
  T s[S], six[S], stat[S];
  Key key[S];
  bool real[S], retired[S];
#pragma unroll
  for (int j = 0; j < ns; ++j) {
    real[j] = lane + 32 * j < n_bands;
    s[j] = real[j] ? add_rn(smr[j], T(0)) : T(-INFINITY);   // -0 -> +0
    bits[j] = 0;
    six[j] = T(0);            // 6 * bits, exact
    retired[j] = false;
    // candidate key smr - 6 bits (retired bands at -1e30); global stop
    // statistic smr - 6 (bits - 1) over all bands, retired ones too
    key[j] = ordered(s[j]);
    stat[j] = sub_rn(s[j], T(-6));
  }
  // one slot a lane: the lanes whose band is coded M/S, as a ballot
  const unsigned ms_lanes = __ballot_sync(kFull, real[0] && (ms & 1u));
  int paid = 0;             // the last grant's cost, on the lane that paid
  int cand_lane = 0;        // the last step's candidate
  const int max_iters = n_bands * (max_mant + 1);
  for (int it = 0; it < max_iters; ++it) {
    Key kb = key[0];        // this lane's best: the lowest slot on ties
    int jb = 0;
#pragma unroll
    for (int j = 1; j < ns; ++j)
      if (key[j] > kb) {
        kb = key[j];
        jb = j;
      }
    const Key key_max = warp_max(kb);
    // While the maximum is taken: the votes, the last grant's cost, and
    // what each slot does IF it is the candidate.
    bool live = false, ms_q = true, lr_q = true;
#pragma unroll
    for (int j = 0; j < ns; ++j) {
      live = live || (real[j] && !retired[j]);
      ms_q = ms_q && stat[j] < ms_stop;
      lr_q = lr_q && stat[j] < lr_stop;
    }
    const bool any_live = __any_sync(kFull, live);
    const bool ms_quiet = __all_sync(kFull, ms_q);
    const bool lr_quiet = __all_sync(kFull, lr_q);
    total -= __shfl_sync(kFull, paid, cand_lane);
    if (!any_live) {        // every later step is a no-op
      paid = 0;
      break;
    }
    bool pay[S], retire[S];
    T six_next[S], stat_next[S];
    Key key_next[S];
#pragma unroll
    for (int j = 0; j < ns; ++j) {
      pay[j] = total - nl[j] >= 0;
      six_next[j] = pay[j] ? add_rn(six[j], T(6)) : six[j];
      key_next[j] = ordered(sub_rn(s[j], six_next[j]));
      stat_next[j] = sub_rn(s[j], sub_rn(six_next[j], T(6)));
      retire[j] = !pay[j] || bits[j] + 1 >= max_mant;
    }
    bool me[S];
    bool kill_stop;
    if constexpr (S == 1) {
      // the candidate: the first lane that holds the maximum
      const unsigned holders = __ballot_sync(kFull, key[0] == key_max);
      const unsigned first = holders & (0u - holders);
      me[0] = first == (1u << lane);
      kill_stop = first & ms_lanes ? ms_quiet : lr_quiet;
      cand_lane = __popc(first - 1u);
    } else {
      // the candidate: the lowest band index among the lanes' bests that
      // hold the maximum
      const unsigned mine = kb == key_max ? 32u * jb + lane : 0xffffffffu;
      const unsigned cand = __reduce_min_sync(kFull, mine);
      cand_lane = static_cast<int>(cand & 31u);
#pragma unroll
      for (int j = 0; j < ns; ++j) me[j] = cand == 32u * j + lane;
      // read on the candidate's lane only, where jb is its slot
      kill_stop = (ms >> jb) & 1u ? ms_quiet : lr_quiet;
    }
    paid = 0;
#pragma unroll
    for (int j = 0; j < ns; ++j) {
      paid = me[j] && pay[j] ? nl[j] : paid;
      bits[j] += me[j] && pay[j];
      six[j] = me[j] ? six_next[j] : six[j];
      stat[j] = me[j] ? stat_next[j] : stat[j];
      retired[j] = retired[j] || (me[j] && (retire[j] || kill_stop));
      key[j] = !me[j] ? key[j] : retired[j] ? dead_key : key_next[j];
    }
  }
  total -= __shfl_sync(kFull, paid, cand_lane);   // the last step's grant

  // refund the 1-bit bands (the reference never codes 1-bit mantissas)
  int refund = 0;
#pragma unroll
  for (int j = 0; j < ns; ++j) {
    refund += bits[j] == 1 ? nl[j] : 0;
    bits[j] = bits[j] == 1 ? 0 : bits[j];
  }
  return total + __reduce_add_sync(kFull, refund);
}

}  // namespace wf
