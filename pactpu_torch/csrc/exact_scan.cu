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
//     (the cost table, kernel K10); savings = raw bits - (that + sign bits
//     + table id bits); chain = the fill's leftover
//   deposit += sum of savings - take; extra = the last chain
//
// for the chunk's valid blocks, a prefix that the kernel reads from the
// flags valid[blocks] in device memory (the rest are padding: extras 0,
// the carry untouched; pactpu's scan takes the same mask).  The carry
// (deposit, extra) comes in and goes out as int32[2] on the device, and
// nothing of a chunk is a launch argument that a file's chunks differ in,
// so chunks chain with no host round trip and one captured CUDA graph
// replays every chunk of a size, a file's padded last chunk too.  Both
// warps find the prefix's length at the start: each thread reads every
// 64th flag (independent loads, no early exit) and keeps the first
// false one, a warp minimum, then the two warps' minimum through shared
// memory before the first barrier.
//
// Bound on the H100: the chain of dependent fills.  Nothing of a block
// can start before the last block's savings are known, so the time is
// the chain's length, walked by one warp.  The first design (one warp
// doing everything) spent, by clock64() stamps in a copy of it
// (tools/k7_phase_clock.py), 92% of a fill in its greedy steps (198
// clocks a step against K2's 137: nvcc reloaded max_mant from the
// constant bank inside the loop) and about 1,900 clocks a fill around
// them: the gather of the cost rows from L2 (250) and ten dependent warp
// sums and a minimum (1,070).  This design (times in PERF.md, in turns
// against the first):
//
// - Two warps.  Warp 0 walks the chain.  Warp 1 takes channel 0's
//   accounting (its cost gather, table sums, minimum and savings) while
//   warp 0 fills channel 1, so only the last channel's accounting stays
//   on the chain; the two hand over through shared memory and named
//   barriers (bar.arrive / bar.sync, ids 1 and 2, 64 threads), one pair a
//   block.
// - The cost rows in shared memory.  Warp 1 stages each block's cost
//   rows (C x bands x 17 x tables int32, 34 KB for a stereo block of 25
//   bands and 10 tables) two blocks ahead with bulk copies
//   (cp.async.bulk into a ring of three slots, completed on an mbarrier),
//   so that a gather reads shared memory.  Rows that do not fit three
//   slots (or are not 16-byte multiples) are read from device memory
//   after an L2 prefetch one block ahead (the kStaged = false case).
// - One transposed butterfly for the tables' sums: each shuffle level
//   halves the values a lane holds (16 tables: 8, 4, 2, 1, then one more
//   level), 16 shuffles in five dependent levels instead of sixteen
//   dependent warp reductions, then one warp minimum.
// - A shorter chain: a fill jumps over the prefixes of its greedy grants
//   that nothing unforeseen can interrupt and takes the steps between
//   them (fill_row_jump below): on a real chunk it walks 20,069 of the
//   116,264 greedy steps one at a time.
// - What nvcc made of the loop: the warp index comes from a shuffle
//   (warp-uniform for the compiler: with threadIdx.x / 32 it guarded
//   every warp-wide operation of the chain with BRA.DIV and WARPSYNC), the
//   fill's parameters come through shared memory (from the constant bank
//   nvcc reloaded them inside the loop, where a vote waited for them), and
//   the loop tests for a jump after the step's chain, not before it.
//
// Exactness: the same operations in the same order as the plain version
// (kernels.exact_scan_plain): integer arithmetic (sums in any order), the
// fill bit-exact with K2's plain version, the total's addition and
// truncation in T.

#include "kernels.h"
#include "water_fill_step.cuh"

namespace {

constexpr int kAllocs = 17;     // allocation values 0..16 of the cost table
constexpr int kMaxTables = 16;  // Huffman tables (4 table id bits: 15)
constexpr int kSlots = 3;       // staged blocks: t, t + 1, t + 2
constexpr int kStageMax = 200 * 1024;  // shared memory for the ring
constexpr int kCopyPiece = 16 * 1024;  // bytes a bulk copy
constexpr int kBarBits = 1;     // warp 0 -> warp 1: channel 0's allocation
constexpr int kBarSavings = 2;  // warp 1 -> warp 0: channel 0's savings

__device__ __forceinline__ void bar_arrive(int id) {
  asm volatile("bar.arrive %0, 64;" ::"r"(id) : "memory");
}

__device__ __forceinline__ void bar_sync(int id) {
  asm volatile("bar.sync %0, 64;" ::"r"(id) : "memory");
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// block t's cost rows into its slot: one lane arms the slot's mbarrier
// with the bytes to come and issues the bulk copies
__device__ __forceinline__ void stage_row(unsigned char* slot, uint64_t* bar,
                                          const int32_t* src, int bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
  for (int off = 0; off < bytes; off += kCopyPiece) {
    const int n = bytes - off < kCopyPiece ? bytes - off : kCopyPiece;
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1], %2, [%3];" ::"r"(smem_addr(slot + off)),
        "l"(reinterpret_cast<const char*>(src) + off), "r"(n),
        "r"(smem_addr(bar))
        : "memory");
  }
}

__device__ __forceinline__ void wait_row(uint64_t* bar, int parity) {
  uint32_t done = 0;
  while (!done)
    asm volatile(
        "{ .reg .pred p;\n"
        "  mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "  selp.u32 %0, 1, 0, p; }"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
}

// K7's fill: water_fill_step.cuh's greedy steps (its fill_row, copied
// here so that K2, K8 and K9 keep their code) with jumps over the
// prefixes of grants that nothing unforeseen can interrupt (the plain
// version, kernels.water_fill_row_jump_plain, says why it is exact):
//
// - the greedy grants follow (key desc, band asc) over the keys
//   smr - 6 k, from a band's bits up to its top, so the grants of keys
//   above a level L are a prefix of them; a band's top is the cap, or its
//   bits + 1 once the stop statistic g is below the band's own threshold
//   (the step that next picks it grants it and stops it);
// - a probe of L counts each slot's keys above L, and one warp sum of
//   their lines and one warp maximum of g after them decide whether the
//   prefix fits the budget and leaves g at or above the highest threshold
//   of the bands still below it;
// - a jump takes that threshold (or the lowest key left) less
//   kJumpFloorDb if it passes, else the best of kJumpProbes bisections
//   up to the highest key left; then a band the leftover cannot pay for
//   leaves the running (its one step would retire it without a grant);
// - the steps go on until g falls below a threshold it was not below at
//   the last jump (the loop's own votes say so), and the next jump
//   starts there; a row with a NaN SMR or keys down to -1e30 (the retired
//   bands' key) takes the steps alone.
constexpr int kJumpProbes = 6;
constexpr float kJumpFloorDb = 12.0f;
constexpr int kMaxJumpCap = 16;  // the cost table's allocations 0..16

// The grants above `level` of each slot (its keys s - 6 k > level, k from
// bits to top) into cnt, their lines into cost (a warp sum); true if they
// fit the budget and leave g, over all bands, at or above need.
template <typename T, int S, bool kWide>
__device__ __forceinline__ bool jump_probe(
    const T (&s)[S], const bool (&live)[S], const bool (&real)[S],
    const int (&bits)[S], const int (&top)[S], const int (&nl)[S],
    int n_bands, T level, int total, decltype(wf::ordered(T(0))) need,
    int (&cnt)[S], int& cost) {
  using Key = decltype(wf::ordered(T(0)));
  const int ns = wf::n_slots<S, kWide>(n_bands);
  int lines = 0;
  bool up = false;              // a statistic at or above need
#pragma unroll
  for (int j = 0; j < ns; ++j) {
    int c = 0;
#pragma unroll
    for (int k = 0; k < kMaxJumpCap; ++k)
      c += k >= bits[j] && k < top[j] && wf::sub_rn(s[j], T(6 * k)) > level;
    cnt[j] = live[j] ? c : 0;
    lines += cnt[j] * nl[j];
    const Key st =
        wf::ordered(wf::sub_rn(s[j], T(6 * (bits[j] + cnt[j] - 1))));
    up = up || (real[j] && st >= need);
  }
  // (a vote for g's test: max >= need is any >= need)
  const bool g_up = __any_sync(wf::kFull, up);
  cost = __reduce_add_sync(wf::kFull, lines);
  return cost <= total && g_up;
}

// The value of the warp's largest (or, with `low`, smallest) key among
// the lanes' candidates v (keys -inf / +inf where a lane has none).
template <typename T>
__device__ __forceinline__ T warp_extreme(T v, bool low) {
  const auto k = wf::ordered(v);
  const auto e = low ? wf::warp_min(k) : wf::warp_max(k);
  const unsigned holder = __ballot_sync(wf::kFull, k == e);
  return __shfl_sync(wf::kFull, v, __ffs(holder) - 1);
}

// One jump from the state (bits, retired, total); ms_quiet / lr_quiet:
// whether g is below each threshold now.
template <typename T, int S, bool kWide>
__device__ __forceinline__ void jump(const T (&s)[S], const bool (&real)[S],
                                     const int (&nl)[S], unsigned ms,
                                     int n_bands, int max_mant, T ms_stop,
                                     T lr_stop, bool ms_quiet, bool lr_quiet,
                                     int (&bits)[S], bool (&retired)[S],
                                     int& total) {
  using Key = decltype(wf::ordered(T(0)));
  const int ns = wf::n_slots<S, kWide>(n_bands);
  const T neg = static_cast<T>(-1e30f);
  bool live[S];
  int top[S], cnt[S], best[S];
  Key need = 0;
  T hi = T(-INFINITY), low = T(INFINITY);
  bool free_band = false;
#pragma unroll
  for (int j = 0; j < ns; ++j) {
    live[j] = real[j] && !retired[j];
    const bool by_ms = (ms >> j) & 1u;
    const bool stopped = by_ms ? ms_quiet : lr_quiet;
    top[j] = stopped && bits[j] + 1 < max_mant ? bits[j] + 1 : max_mant;
    const Key t = wf::ordered(by_ms ? ms_stop : lr_stop);
    need = live[j] && !stopped && t > need ? t : need;
    free_band = free_band || (live[j] && !stopped);
    const T k_hi = wf::sub_rn(s[j], T(6 * bits[j]));
    const T k_low = wf::sub_rn(s[j], T(6 * (top[j] - 1)));
    hi = live[j] && k_hi > hi ? k_hi : hi;
    low = live[j] && k_low < low ? k_low : low;
  }
  need = wf::warp_max(need);
  hi = warp_extreme(hi, false);
  low = warp_extreme(low, true);
  if (!(hi > T(-INFINITY))) return;           // nothing left to grant
  // the search's bottom: the highest threshold of the bands still free of
  // the stop (need's), or the lowest key left, less the floor
  const bool any_free = __any_sync(wf::kFull, free_band);
  T lo = (any_free ? (need == wf::ordered(ms_stop) ? ms_stop : lr_stop)
                   : low) - static_cast<T>(kJumpFloorDb);
  lo = lo > neg ? lo : neg;
  int cost = 0, best_cost = 0;
  if (!jump_probe<T, S, kWide>(s, live, real, bits, top, nl, n_bands, lo,
                               total, need, best, best_cost)) {
    best_cost = 0;                             // hi: no grant
#pragma unroll
    for (int j = 0; j < ns; ++j) best[j] = 0;
    for (int p = 0; p < kJumpProbes; ++p) {
      const T mid = wf::add_rn(lo, wf::sub_rn(hi, lo) * T(0.5));
      if (jump_probe<T, S, kWide>(s, live, real, bits, top, nl, n_bands,
                                  mid, total, need, cnt, cost)) {
        hi = mid;
        best_cost = cost;
#pragma unroll
        for (int j = 0; j < ns; ++j) best[j] = cnt[j];
      } else {
        lo = mid;
      }
    }
  }
  total -= best_cost;
#pragma unroll
  for (int j = 0; j < ns; ++j) {
    bits[j] += best[j];
    retired[j] = retired[j] || (real[j] && (bits[j] >= top[j] ||
                                            nl[j] > total));
  }
}

// A slot's step state from its bits: 6 bits, its key (the retired bands'
// -1e30) and its stop statistic s - 6 (bits - 1).
template <typename T, int S, bool kWide>
__device__ __forceinline__ void restate(
    const T (&s)[S], const int (&bits)[S], const bool (&retired)[S],
    int n_bands, decltype(wf::ordered(T(0))) dead_key, T (&six)[S],
    decltype(wf::ordered(T(0))) (&key)[S], T (&stat)[S]) {
  const int ns = wf::n_slots<S, kWide>(n_bands);
#pragma unroll
  for (int j = 0; j < ns; ++j) {
    six[j] = T(6 * bits[j]);   // exact
    key[j] = retired[j] ? dead_key : wf::ordered(wf::sub_rn(s[j], six[j]));
    stat[j] = wf::sub_rn(s[j], wf::sub_rn(six[j], T(6)));
  }
}

// Whether g, the largest statistic over the bands, is below each
// threshold (the step loop's own votes).
template <typename T, int S, bool kWide>
__device__ __forceinline__ void quiet(const T (&stat)[S], int n_bands,
                                      T ms_stop, T lr_stop, bool& ms_q,
                                      bool& lr_q) {
  const int ns = wf::n_slots<S, kWide>(n_bands);
  bool m = true, l = true;
#pragma unroll
  for (int j = 0; j < ns; ++j) {
    m = m && stat[j] < ms_stop;
    l = l && stat[j] < lr_stop;
  }
  ms_q = __all_sync(wf::kFull, m);
  lr_q = __all_sync(wf::kFull, l);
}

template <typename T, int S, bool kWide>
__device__ __forceinline__ int fill_row_jump(const T (&smr)[S], unsigned ms,
                                             const int (&nl)[S], int n_bands,
                                             int total, int max_mant,
                                             T ms_stop, T lr_stop,
                                             int (&bits)[S]) {
  using Key = decltype(wf::ordered(T(0)));
  const int lane = threadIdx.x & 31;
  const T neg = static_cast<T>(-1e30f);
  const Key dead_key = wf::ordered(neg);
  const int ns = wf::n_slots<S, kWide>(n_bands);
  T s[S], six[S], stat[S];
  Key key[S];
  bool real[S], retired[S];
  bool ok = max_mant > 0 && max_mant <= kMaxJumpCap;
#pragma unroll
  for (int j = 0; j < ns; ++j) {
    real[j] = lane + 32 * j < n_bands;
    s[j] = real[j] ? wf::add_rn(smr[j], T(0)) : T(-INFINITY);   // -0 -> +0
    bits[j] = 0;
    retired[j] = false;
    ok = ok && (!real[j] || (!isnan(s[j]) &&
                             wf::sub_rn(s[j], T(6 * (max_mant - 1))) > neg));
  }
  const bool jumps = __all_sync(wf::kFull, ok);
  bool ms_q0 = false, lr_q0 = false;   // g below each threshold
  restate<T, S, kWide>(s, bits, retired, n_bands, dead_key, six, key, stat);
  if (jumps) {
    quiet<T, S, kWide>(stat, n_bands, ms_stop, lr_stop, ms_q0, lr_q0);
    jump<T, S, kWide>(s, real, nl, ms, n_bands, max_mant, ms_stop, lr_stop,
                      ms_q0, lr_q0, bits, retired, total);
    restate<T, S, kWide>(s, bits, retired, n_bands, dead_key, six, key, stat);
    quiet<T, S, kWide>(stat, n_bands, ms_stop, lr_stop, ms_q0, lr_q0);
  }

  // ---- the greedy steps (wf::fill_row's loop from this state) ----
  const unsigned ms_lanes = __ballot_sync(wf::kFull, real[0] && (ms & 1u));
  int paid = 0;
  int cand_lane = 0;
  // (two more passes: the loop's turns that jump take no step)
  const int max_iters = n_bands * (max_mant + 1) + 2;
  for (int it = 0; it < max_iters; ++it) {
    Key kb = key[0];
    int jb = 0;
#pragma unroll
    for (int j = 1; j < ns; ++j)
      if (key[j] > kb) {
        kb = key[j];
        jb = j;
      }
    const Key key_max = wf::warp_max(kb);
    bool live = false, ms_q = true, lr_q = true;
#pragma unroll
    for (int j = 0; j < ns; ++j) {
      live = live || (real[j] && !retired[j]);
      ms_q = ms_q && stat[j] < ms_stop;
      lr_q = lr_q && stat[j] < lr_stop;
    }
    const bool any_live = __any_sync(wf::kFull, live);
    const bool ms_quiet = __all_sync(wf::kFull, ms_q);
    const bool lr_quiet = __all_sync(wf::kFull, lr_q);
    total -= __shfl_sync(wf::kFull, paid, cand_lane);
    paid = 0;
    if (!any_live) break;
    bool pay[S], retire[S];
    T six_next[S], stat_next[S];
    Key key_next[S];
#pragma unroll
    for (int j = 0; j < ns; ++j) {
      pay[j] = total - nl[j] >= 0;
      six_next[j] = pay[j] ? wf::add_rn(six[j], T(6)) : six[j];
      key_next[j] = wf::ordered(wf::sub_rn(s[j], six_next[j]));
      stat_next[j] = wf::sub_rn(s[j], wf::sub_rn(six_next[j], T(6)));
      retire[j] = !pay[j] || bits[j] + 1 >= max_mant;
    }
    bool me[S];
    bool kill_stop;
    if constexpr (S == 1) {
      const unsigned holders = __ballot_sync(wf::kFull, key[0] == key_max);
      const unsigned first = holders & (0u - holders);
      me[0] = first == (1u << lane);
      kill_stop = first & ms_lanes ? ms_quiet : lr_quiet;
      cand_lane = __popc(first - 1u);
    } else {
      const unsigned mine = kb == key_max ? 32u * jb + lane : 0xffffffffu;
      const unsigned cand = __reduce_min_sync(wf::kFull, mine);
      cand_lane = static_cast<int>(cand & 31u);
#pragma unroll
      for (int j = 0; j < ns; ++j) me[j] = cand == 32u * j + lane;
      kill_stop = (ms >> jb) & 1u ? ms_quiet : lr_quiet;
    }
    // g fell below another threshold: jump again from here instead of
    // this step (tested here, when the step's chain is done with, so
    // that the votes it waits for are long in)
    if (jumps && (ms_quiet != ms_q0 || lr_quiet != lr_q0)) {
      ms_q0 = ms_quiet;
      lr_q0 = lr_quiet;
      jump<T, S, kWide>(s, real, nl, ms, n_bands, max_mant, ms_stop,
                        lr_stop, ms_q0, lr_q0, bits, retired, total);
      restate<T, S, kWide>(s, bits, retired, n_bands, dead_key, six, key,
                           stat);
      quiet<T, S, kWide>(stat, n_bands, ms_stop, lr_stop, ms_q0, lr_q0);
      continue;
    }
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
  total -= __shfl_sync(wf::kFull, paid, cand_lane);

  int refund = 0;
#pragma unroll
  for (int j = 0; j < ns; ++j) {
    refund += bits[j] == 1 ? nl[j] : 0;
    bits[j] = bits[j] == 1 ? 0 : bits[j];
  }
  return total + __reduce_add_sync(wf::kFull, refund);
}

// One channel's savings: raw bits - (the cheapest table's bits + sign
// bits + table id bits), of the allocation `bits` (slot j of this lane:
// band lane + 32 j) against the channel's cost rows [bands][17][n_tab]
// (shared or device memory), on one warp.
template <int S, bool kWide>
__device__ __forceinline__ int savings_of(const int32_t* rows,
                                          const int (&bits)[S],
                                          const int (&nl)[S], int n_bands,
                                          int n_tab, int tid_bits) {
  const int lane = threadIdx.x & 31;
  const int ns = wf::n_slots<S, kWide>(n_bands);
  int raw = 0, signs = 0;
  unsigned v[kMaxTables];
#pragma unroll
  for (int tb = 0; tb < kMaxTables; ++tb) v[tb] = 0;
#pragma unroll
  for (int j = 0; j < ns; ++j) {
    const int band = lane + 32 * j;
    if (band < n_bands) {
      raw += bits[j] * nl[j];
      signs += bits[j] > 0 ? nl[j] : 0;
      const int32_t* c = rows + (band * kAllocs + bits[j]) * n_tab;
#pragma unroll
      for (int tb = 0; tb < kMaxTables; ++tb)
        if (tb < n_tab) v[tb] += static_cast<unsigned>(c[tb]);
    }
  }
  raw = __reduce_add_sync(wf::kFull, raw);
  signs = __reduce_add_sync(wf::kFull, signs);
  // the transposed butterfly: at offset o a lane keeps the upper half of
  // its values if its bit o is set, else the lower, and adds its
  // partner's; after o = 16, 8, 4, 2 it holds one table's sum over 16
  // lanes, idx = its bits 4..1
#pragma unroll
  for (int tb = 0; tb < 8; ++tb) {
    const bool up = lane & 16;
    const unsigned keep = up ? v[tb + 8] : v[tb];
    v[tb] = keep + __shfl_xor_sync(wf::kFull, up ? v[tb] : v[tb + 8], 16);
  }
#pragma unroll
  for (int tb = 0; tb < 4; ++tb) {
    const bool up = lane & 8;
    const unsigned keep = up ? v[tb + 4] : v[tb];
    v[tb] = keep + __shfl_xor_sync(wf::kFull, up ? v[tb] : v[tb + 4], 8);
  }
#pragma unroll
  for (int tb = 0; tb < 2; ++tb) {
    const bool up = lane & 4;
    const unsigned keep = up ? v[tb + 2] : v[tb];
    v[tb] = keep + __shfl_xor_sync(wf::kFull, up ? v[tb] : v[tb + 2], 4);
  }
  {
    const bool up = lane & 2;
    const unsigned keep = up ? v[1] : v[0];
    v[0] = keep + __shfl_xor_sync(wf::kFull, up ? v[0] : v[1], 2);
  }
  v[0] += __shfl_xor_sync(wf::kFull, v[0], 1);
  const int idx = ((lane >> 4) & 1) * 8 + ((lane >> 3) & 1) * 4 +
                  ((lane >> 2) & 1) * 2 + ((lane >> 1) & 1);
  const unsigned best =
      __reduce_min_sync(wf::kFull, idx < n_tab ? v[0] : 0xffffffffu);
  return raw - (static_cast<int>(best) + signs + tid_bits);
}

template <typename T, int S, bool kWide, bool kStaged>
__global__ void __launch_bounds__(64)
exact_scan_kernel(const T* __restrict__ smr, const uint8_t* __restrict__ lrms,
                  const uint8_t* __restrict__ valid,
                  const int32_t* __restrict__ cost,
                  const int32_t* __restrict__ n_lines,
                  const int32_t* __restrict__ carry_in,
                  int32_t* __restrict__ carry_out,
                  int32_t* __restrict__ extras, int blocks,
                  int channels, int n_bands, int n_tab, double budget,
                  int max_mant_arg, T ms_stop_arg, T lr_stop_arg,
                  int tid_bits,
                  int divisor) {
  extern __shared__ __align__(128) unsigned char ring[];
  __shared__ uint64_t row_bar[kSlots];
  __shared__ uint8_t bits0_s[32 * S];
  __shared__ int sav0_s;
  __shared__ T stop_s[2];
  __shared__ int cap_s[2];
  __shared__ int first_s[2];
  const int lane = threadIdx.x & 31;
  // warp-uniform for the compiler (a shuffle of lane 0's), so that the
  // role split below is no divergent branch around warp-wide operations
  const int warp = __shfl_sync(wf::kFull, static_cast<int>(threadIdx.x >> 5),
                               0);
  // the valid prefix: the first block whose flag is false (blocks if none)
  int first = blocks;
#pragma unroll 4
  for (int t = threadIdx.x; t < blocks; t += 64)
    if (valid[t] == 0) first = min(first, t);
  first = __reduce_min_sync(wf::kFull, first);
  if (lane == 0) first_s[warp] = first;
  const int64_t cost_block =
      static_cast<int64_t>(channels) * n_bands * kAllocs * n_tab;
  const int row_bytes = static_cast<int>(cost_block * 4);
  const int64_t chan_stride = static_cast<int64_t>(n_bands) * kAllocs * n_tab;
  const int ns = wf::n_slots<S, kWide>(n_bands);
  int nl[S];
#pragma unroll
  for (int j = 0; j < ns; ++j)
    nl[j] = lane + 32 * j < n_bands ? n_lines[lane + 32 * j] : 0;
  // the fill's parameters through shared memory, so that the chain's
  // loop holds them in registers (nvcc reloaded them from the constant
  // bank inside the loop, where a warp vote waited for them every step)
  if (threadIdx.x == 0) {
    stop_s[0] = ms_stop_arg;
    stop_s[1] = lr_stop_arg;
    cap_s[0] = max_mant_arg;
    cap_s[1] = n_bands;
  }
  __syncthreads();
  const int n_valid = min(first_s[0], first_s[1]);
  if constexpr (kStaged) {
    if (threadIdx.x == 32) {
      for (int k = 0; k < kSlots; ++k)
        asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(
                         smem_addr(row_bar + k))
                     : "memory");
      asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    }
    __syncthreads();
  }
  // block t's cost rows: its slot in shared memory, or device memory
  auto rows_of = [&](int t) -> const int32_t* {
    if constexpr (kStaged)
      return reinterpret_cast<const int32_t*>(ring +
                                              (t % kSlots) * row_bytes);
    else
      return cost + t * cost_block;
  };
  auto wait = [&](int t) {
    if constexpr (kStaged) wait_row(row_bar + t % kSlots, (t / kSlots) & 1);
  };

  if (warp == 1) {
    // ---- warp 1: stages the rows, channel 0's accounting ----
    auto stage = [&](int t) {
      if (t >= n_valid) return;
      if constexpr (kStaged) {
        if (lane == 0)
          stage_row(ring + (t % kSlots) * row_bytes, row_bar + t % kSlots,
                    cost + t * cost_block, row_bytes);
      } else {   // into L2, 128-byte lines spread over the lanes
        const char* base = reinterpret_cast<const char*>(cost + t * cost_block);
        for (int64_t b = 128 * lane; b < cost_block * 4; b += 128 * 32)
          asm volatile("prefetch.global.L2 [%0];" ::"l"(base + b));
      }
    };
    stage(0);
    if constexpr (kStaged) stage(1);
    for (int t = 0; t < n_valid; ++t) {
      bar_sync(kBarBits);              // channel 0 of block t is filled
      stage(kStaged ? t + 2 : t + 1);  // its slot was block t - 1's
      if (channels == 2) {
        int bits[S];
#pragma unroll
        for (int j = 0; j < ns; ++j)
          bits[j] = lane + 32 * j < n_bands ? bits0_s[lane + 32 * j] : 0;
        wait(t);
        const int s0 =
            savings_of<S, kWide>(rows_of(t), bits, nl, n_bands, n_tab,
                                 tid_bits);
        if (lane == 0) sav0_s = s0;
      }
      bar_arrive(kBarSavings);
    }
    return;
  }

  // ---- warp 0: the chain ----
  const T budget_t = static_cast<T>(budget);
  const T ms_stop = stop_s[0], lr_stop = stop_s[1];
  const int max_mant = cap_s[0], nb = cap_s[1];
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

  int deposit = carry_in[0];
  int extra = carry_in[1];
  if (n_valid > 0) load(0);
  for (int t = 0; t < n_valid; ++t) {
    T s0[S], s1[S];
#pragma unroll
    for (int j = 0; j < ns; ++j) {
      s0[j] = s_next[0][j];
      s1[j] = s_next[1][j];
    }
    const unsigned ms = ms_next;
    if (t + 1 < n_valid) load(t + 1);
    const int take = (deposit > 10 ? deposit / divisor : 0) +
                     (deposit < 0 ? deposit : 0);
    const int granted = extra + take;
    int bits[S];
    int total = static_cast<int>(
        wf::add_rn(budget_t, static_cast<T>(granted)));   // truncates
    int chain = fill_row_jump<T, S, kWide>(s0, ms, nl, nb, total,
                                           max_mant, ms_stop, lr_stop, bits);
    int savings;
    if (channels == 2) {
#pragma unroll
      for (int j = 0; j < ns; ++j)
        if (lane + 32 * j < n_bands) bits0_s[lane + 32 * j] = bits[j];
      bar_arrive(kBarBits);            // warp 1 takes channel 0 from here
      total = static_cast<int>(wf::add_rn(budget_t, static_cast<T>(chain)));
      chain = fill_row_jump<T, S, kWide>(s1, ms, nl, nb, total,
                                         max_mant, ms_stop, lr_stop, bits);
      wait(t);
      const int s1_sav = savings_of<S, kWide>(rows_of(t) + chan_stride, bits,
                                              nl, n_bands, n_tab, tid_bits);
      bar_sync(kBarSavings);
      savings = s1_sav + sav0_s;
    } else {
      bar_arrive(kBarBits);
      wait(t);
      savings = savings_of<S, kWide>(rows_of(t), bits, nl, n_bands, n_tab,
                                     tid_bits);
      bar_sync(kBarSavings);           // warp 1 has staged block t + 2
    }
    if (lane == 0) extras[t] = granted;
    deposit = deposit - take + savings;
    extra = chain;
  }
  for (int t = n_valid + lane; t < blocks; t += 32) extras[t] = 0;
  if (lane == 0) {
    carry_out[0] = deposit;
    carry_out[1] = extra;
  }
}

template <typename T, int S, bool kWide = false>
int launch(const T* smr, const uint8_t* lrms, const uint8_t* valid,
           const int32_t* cost, const int32_t* n_lines,
           const int32_t* carry_in, int32_t* carry_out, int32_t* extras,
           int blocks, int channels, int n_bands, int n_tab, double budget, int max_mant,
           double ms_stop, double lr_stop, int tid_bits, int divisor,
           cudaStream_t stream) {
  const int64_t row_bytes =
      int64_t{channels} * n_bands * kAllocs * n_tab * 4;
  const bool staged = !kWide && row_bytes % 16 == 0 &&
                      kSlots * row_bytes <= kStageMax &&
                      reinterpret_cast<uintptr_t>(cost) % 16 == 0;
  if (staged) {
    const int smem = static_cast<int>(kSlots * row_bytes);
    auto kernel = exact_scan_kernel<T, S, kWide, !kWide>;
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    kernel<<<1, 64, smem, stream>>>(
        smr, lrms, valid, cost, n_lines, carry_in, carry_out, extras, blocks,
        channels, n_bands, n_tab, budget, max_mant,
        static_cast<T>(ms_stop), static_cast<T>(lr_stop), tid_bits, divisor);
  } else {
    exact_scan_kernel<T, S, kWide, false><<<1, 64, 0, stream>>>(
        smr, lrms, valid, cost, n_lines, carry_in, carry_out, extras, blocks,
        channels, n_bands, n_tab, budget, max_mant,
        static_cast<T>(ms_stop), static_cast<T>(lr_stop), tid_bits, divisor);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const T* smr, const uint8_t* lrms, const uint8_t* valid,
             const int32_t* cost, const int32_t* n_lines,
             const int32_t* carry_in, int32_t* carry_out, int32_t* extras,
             int blocks, int channels, int n_bands, int n_tab, double budget,
             int max_mant, double ms_stop, double lr_stop, int tid_bits,
             int divisor, cudaStream_t stream) {
  if (channels < 1 || channels > 2 || divisor == 0 || n_tab < 1 ||
      n_tab > kMaxTables)
    return static_cast<int>(cudaErrorInvalidValue);
  const int slots = (n_bands + 31) / 32;
#define PACTPU_K7_CASE(S)                                                   \
  if (slots <= S)                                                           \
    return launch<T, S>(smr, lrms, valid, cost, n_lines, carry_in,          \
                        carry_out, extras, blocks, channels, n_bands,       \
                        n_tab, budget, max_mant, ms_stop, lr_stop,          \
                        tid_bits, divisor, stream);
  PACTPU_K7_CASE(1)
  PACTPU_K7_CASE(2)
  PACTPU_K7_CASE(4)
#undef PACTPU_K7_CASE
  if (slots <= 32)
    return launch<T, 32, true>(smr, lrms, valid, cost, n_lines, carry_in,
                               carry_out, extras, blocks, channels, n_bands,
                               n_tab, budget, max_mant, ms_stop, lr_stop,
                               tid_bits, divisor, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" int pactpu_exact_scan_valid(
    const float* smr, const uint8_t* lrms, const uint8_t* valid,
    const int32_t* cost, const int32_t* n_lines, const int32_t* carry_in,
    int32_t* carry_out, int32_t* extras, int blocks, int channels,
    int n_bands, int n_tab, double budget, int max_mant, double ms_stop,
    double lr_stop, int tid_bits, int divisor, cudaStream_t stream) {
  return dispatch<float>(smr, lrms, valid, cost, n_lines, carry_in,
                         carry_out, extras, blocks, channels, n_bands, n_tab,
                         budget, max_mant, ms_stop, lr_stop, tid_bits,
                         divisor, stream);
}

extern "C" int pactpu_exact_scan_valid_f64(
    const double* smr, const uint8_t* lrms, const uint8_t* valid,
    const int32_t* cost, const int32_t* n_lines, const int32_t* carry_in,
    int32_t* carry_out, int32_t* extras, int blocks, int channels,
    int n_bands, int n_tab, double budget, int max_mant, double ms_stop,
    double lr_stop, int tid_bits, int divisor, cudaStream_t stream) {
  return dispatch<double>(smr, lrms, valid, cost, n_lines, carry_in,
                          carry_out, extras, blocks, channels, n_bands, n_tab,
                          budget, max_mant, ms_stop, lr_stop, tid_bits,
                          divisor, stream);
}
