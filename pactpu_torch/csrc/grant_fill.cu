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
// Bound on the H100: latency of a serial loop, one grant a step, in K2's
// layout (one warp a row, band b in lane b % 32, slot b / 32, S = 1, 2 or
// 4 slots in registers, the wide form past 128 bands).  The design
// shortens the chain two ways:
//
// - A jump (kernels.grant_fill_jump_plain, the same walk in Python).  The
//   grants follow (level desc, band index asc) over each band's keys lev,
//   lev - 6, ... (float32 steps, up to max_mant a band), and only the
//   budget interrupts them: a band leaves once it can no longer be paid
//   for, and remaining only falls.  So the grants of the keys above a
//   level L, over the bands payable now, all happen if their lines fit
//   the budget (with something left, or no zero-line band among them: the
//   `remaining > 0` guard before each) and their count fits the steps
//   left.  All three are monotone in L: the row's walk starts with the
//   lowest L of kProbes bisections between the lowest key and the highest
//   (every key at once if they all fit).  Each slot's keys are worked out
//   once, in registers, so that a probe is compares of them and three warp
//   sums (kernels.grant_fill_jump_plain counts the probes).  Rows with a
//   NaN or an infinite level take the steps alone, so that the arg-max's
//   NaN rule and the stall decide them.
// - K2's step discipline for what is left (water_fill_step.cuh): a step is
//   one warp maximum of the keys, the first holder by one ballot (S = 1;
//   a warp minimum of the band index past one slot), and selects.  Each
//   slot works out in the maximum's shadow what it does if it is the
//   candidate, and its key for the next step: its level's key if the
//   remaining before this step could pay for it, else -inf.  What the grant
//   cost reaches the other lanes by one shuffle, off the keys' chain, so
//   the keys lag the budget by one step: a band that the last grant made
//   too dear can still win the maximum once, and that step only drops it
//   (no grant, no step of the cap).  One exit: the step cap, or a
//   maximum of -inf whose first holder cannot be paid (pactpu's fixed
//   point).
//
// Registers (ptxas): 38, 56 and 100 for S = 1, 2 and 4 (a slot holds its
// level, key, allocation, threshold and line count, and for the jump its
// 17 keys), 32 in the wide form (its slots in local memory).  4 warps a
// CTA; a chunk's 1,024 rows are all resident at once, so the kernel's time
// is its longest row's chain (PERF.md: ns a walked step, grants jumped,
// probes).

#include "kernels.h"
#include "water_fill_step.cuh"

namespace {

constexpr int kWarpsPerBlock = 4;
constexpr int kProbes = 8;        // kernels.GRANT_PROBES
constexpr int kKeys = 16;         // keys a slot the jump holds in registers
constexpr int kNever = 0x7fffffff;

// the float of an ordered key (wf::ordered's inverse)
__device__ __forceinline__ float unordered(unsigned k) {
  return __uint_as_float(k & 0x80000000u ? k ^ 0x80000000u : ~k);
}

// keys lev, lev - 6, ... (float32 steps, at most `left`) above L: their
// count, and the key after them
__device__ __forceinline__ int keys_above(float lev, int left, float L,
                                          float& after) {
  int c = 0;
  while (c < left && lev > L) {
    lev = __fsub_rn(lev, 6.0f);
    ++c;
  }
  after = lev;
  return c;
}

// The jump: the grants of every key above the lowest level that passes
// (their lines fit remaining, something left or no zero-line band among
// them, their count fits the steps left), over the slots payable now.
// In the register forms (S <= 4) with a cap of at most kKeys bits, each
// slot's keys are worked out once, and a probe's counts are compares of
// them; otherwise (the wide form, or a larger cap) each probe walks them.
template <int S, bool kWide>
__device__ __forceinline__ void jump(float (&lev)[S], int (&alloc)[S],
                                     const int (&nl)[S], const bool (&real)[S],
                                     int ns, int max_mant, int max_steps,
                                     int& remaining, int& grants) {
  constexpr int kRows = kWide ? 1 : S;
  const bool in_regs = !kWide && max_mant <= kKeys;
  bool pay[S];
  bool any = false;
  float keys[kRows][kKeys + 1];   // slot j's keys from its allocation on
  unsigned hi_k = 0, lo_k = 0xffffffffu;
#pragma unroll
  for (int j = 0; j < ns; ++j) {
    pay[j] = real[j] && alloc[j] < max_mant && remaining >= nl[j] &&
             remaining > 0;
    any = any || pay[j];
    float last;                   // the key after the slot's last
    if (in_regs) {
      keys[j][0] = lev[j];
#pragma unroll
      for (int k = 0; k < kKeys; ++k)
        keys[j][k + 1] = __fsub_rn(keys[j][k], 6.0f);
      last = keys[j][0];
#pragma unroll
      for (int k = 1; k <= kKeys; ++k)
        last = k <= max_mant - alloc[j] ? keys[j][k] : last;
    } else {
      keys_above(lev[j], max_mant - alloc[j], -INFINITY, last);
    }
    if (pay[j]) {
      hi_k = max(hi_k, wf::ordered(lev[j]));
      lo_k = min(lo_k, wf::ordered(last));
    }
  }
  if (!__any_sync(wf::kFull, any)) return;
  float hi = unordered(wf::warp_max(hi_k));     // no key above it
  float lo = unordered(wf::warp_min(lo_k));     // the lowest key - 6

  // slot j's keys above `level`, and (with `after`) the key past them
  auto above = [&](int j, float level, float& after) {
    if (!in_regs)
      return keys_above(lev[j], max_mant - alloc[j], level, after);
    const int left = max_mant - alloc[j];
    int c = 0;
#pragma unroll
    for (int k = 0; k < kKeys; ++k)
      c += k < left && keys[j][k] > level;
    after = keys[j][0];
#pragma unroll
    for (int k = 1; k <= kKeys; ++k) after = k == c ? keys[j][k] : after;
    return c;
  };
  auto passes = [&](float level) {
    long long cost = 0;
    int count = 0, zero_lines = 0;
#pragma unroll
    for (int j = 0; j < ns; ++j) {
      float after;
      const int c = pay[j] ? above(j, level, after) : 0;
      cost += static_cast<long long>(c) * nl[j];
      count += c;
      zero_lines += nl[j] == 0 ? c : 0;
    }
    // a lane's cost past what a warp sum of ints holds passes nothing
    const bool big = cost > kNever / 32;
    const int sum =
        __reduce_add_sync(wf::kFull, big ? 0 : static_cast<int>(cost));
    count = __reduce_add_sync(wf::kFull, count);
    zero_lines = __reduce_add_sync(wf::kFull, zero_lines);
    return !__any_sync(wf::kFull, big) && count <= max_steps - grants &&
           (sum < remaining || (sum == remaining && zero_lines == 0));
  };
  if (!passes(lo)) {           // hi always passes: no grant
    for (int p = 0; p < kProbes; ++p) {
      const float mid = __fadd_rn(lo, __fmul_rn(__fsub_rn(hi, lo), 0.5f));
      if (passes(mid)) hi = mid; else lo = mid;
    }
    lo = hi;
  }
  int cost = 0, count = 0;
#pragma unroll
  for (int j = 0; j < ns; ++j) {
    if (!pay[j]) continue;
    float after;
    const int c = above(j, lo, after);
    lev[j] = after;
    alloc[j] += c;
    cost += c * nl[j];
    count += c;
  }
  remaining -= __reduce_add_sync(wf::kFull, cost);
  grants += __reduce_add_sync(wf::kFull, count);
}

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
  bool finite = true;
#pragma unroll
  for (int j = 0; j < ns; ++j) {
    real[j] = lane + 32 * j < n_bands;
    // x + 0: -0.0 reads as +0.0 and a NaN of either sign as the card's
    // positive NaN, whose key is above +inf's
    lev[j] = real[j] ? __fadd_rn(level[at + 32 * j], 0.0f) : -INFINITY;
    nl[j] = real[j] ? n_lines[lane + 32 * j] : 0;
    alloc[j] = 0;
    finite = finite && (!real[j] || isfinite(lev[j]));
  }
  int remaining = total[row];
  int grants = 0;
  if (__all_sync(wf::kFull, finite) && max_steps > 0)
    jump<S, kWide>(lev, alloc, nl, real, ns, max_mant, max_steps, remaining,
                   grants);

  // the steps.  thr: the remaining a slot needs (never, at its cap);
  // key: its level's key if the remaining before the last step could pay
  // for it, else -inf's
  const unsigned ninf = wf::ordered(-INFINITY);
  unsigned ord[S], key[S];
  int thr[S];
#pragma unroll
  for (int j = 0; j < ns; ++j) {
    thr[j] = real[j] && alloc[j] < max_mant ? max(nl[j], 1) : kNever;
    ord[j] = wf::ordered(lev[j]);
    key[j] = remaining >= thr[j] ? ord[j] : ninf;
  }
  bool done = grants >= max_steps;
  while (!done) {
    unsigned kb = key[0];   // this lane's largest key, its lowest slot on ties
    int jb = 0;
#pragma unroll
    for (int j = 1; j < ns; ++j)
      if (key[j] > kb) {
        kb = key[j];
        jb = j;
      }
    const unsigned kmax = wf::warp_max(kb);
    // While the maximum is taken: what each slot does as the candidate,
    // and its key next step either way
    bool pay[S];
    float lev_next[S];
    unsigned ord_next[S], keep[S], take[S];
    int thr_next[S];
#pragma unroll
    for (int j = 0; j < ns; ++j) {
      pay[j] = remaining >= thr[j];
      lev_next[j] = __fsub_rn(lev[j], 6.0f);
      ord_next[j] = wf::ordered(lev_next[j]);
      thr_next[j] = alloc[j] + 1 < max_mant ? thr[j] : kNever;
      keep[j] = pay[j] ? ord[j] : ninf;
      take[j] = remaining >= thr_next[j] ? ord_next[j] : ninf;
    }
    bool me[S];
    int cand_lane;
    bool ok;
    if constexpr (S == 1) {
      // the candidate: the first lane that holds the maximum
      const unsigned holders = __ballot_sync(wf::kFull, key[0] == kmax);
      const unsigned first = holders & (0u - holders);
      me[0] = first == (1u << lane);
      cand_lane = __ffs(holders) - 1;
      ok = (__ballot_sync(wf::kFull, pay[0]) & first) != 0;
    } else {
      // the lowest band index among the lanes' bests that hold it
      const unsigned mine = kb == kmax ? 32u * jb + lane : 0xffffffffu;
      const unsigned cand = wf::warp_min(mine);
      cand_lane = static_cast<int>(cand & 31u);
      bool mine_ok = false;
#pragma unroll
      for (int j = 0; j < ns; ++j) {
        me[j] = cand == 32u * j + lane;
        mine_ok = mine_ok || (me[j] && pay[j]);
      }
      ok = __any_sync(wf::kFull, mine_ok);
    }
    int paid = 0;
#pragma unroll
    for (int j = 0; j < ns; ++j) {
      const bool grant = me[j] && pay[j];
      paid = grant ? nl[j] : paid;
      alloc[j] += grant;
      lev[j] = grant ? lev_next[j] : lev[j];
      ord[j] = grant ? ord_next[j] : ord[j];
      thr[j] = grant ? thr_next[j] : thr[j];
      key[j] = !me[j] ? keep[j] : pay[j] ? take[j] : ninf;
    }
    remaining -= __shfl_sync(wf::kFull, paid, cand_lane);
    grants += ok;
    done = grants >= max_steps || (!ok && kmax == ninf);
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
