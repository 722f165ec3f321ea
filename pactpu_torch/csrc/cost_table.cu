// K10 cost_table: the Huffman bits of every band of every block at every
// allocation under every table, for Engine(rate_mode="exact").
//
// Replaces the XLA computation of pactpu/codec/exact.py:cost_table_body
// (the jax.lax.map over allocations at exact.py:106), which the JAX package
// runs as XLA operations, not as a Pallas kernel; on the port it was some
// 200 tensor operations a chunk (pactpu_torch/ops/kernels.py:
// cost_table_plain, 16 quantize passes).  It computes
//
//   cost[b, ch, band, a, t] = sum over the band's lines of the code length
//       of table t for the line's unsigned BFP mantissa at allocation a
//       (that table's escape length + a where the table has no code),
//
// int32 [B, C, bands, 17, T], allocation 0 (and any above max_mant) zero.
//
// Design.  A persistent CTA (one an SM) walks the (block, channel) items
// one at a time; warp w takes allocations w + 1, w + 1 + warps, ... of
// each (16 warps: one allocation each).  Per item:
//
// - its lines arrive in shared memory by cp.async, one item ahead, lane l's
//   lines [l lpl, (l + 1) lpl) at a stride of lpl | 1 (odd: a warp's reads
//   of one line a lane hit 32 banks);
// - the band peaks (psycho.band_max with fill 0): the warps split each
//   lane's lines, a shared-memory maximum of the bit patterns a run;
// - a warp's allocation: the bands' scale factors, 2^k and clip levels in
//   its shared memory, then the line loop: lane l walks its lines in order,
//   quantizes each (the band, and so its parameters, from the lane's
//   band-start bits by a population count: no branch, no search), reads the
//   symbol's entry of the packed table set and adds it to the lane's
//   running sums, recording them at each line that starts a band; one warp
//   scan turns the lane sums into the row's prefix, and each band's sum is
//   the difference of the prefixes at its two ends;
// - the item's whole cost block is assembled in shared memory and leaves as
//   contiguous 16-byte stores (full sectors, once), while the next item's
//   peaks are taken: two CTA barriers an item.
//
// The packed table set (kernels.pack_tables, built once a table set and
// kept with the exact mode's device tables, exact.packed_tables): W
// 32-bit words a symbol (W = 2 up to 10 tables, 4 up to 16), table t's
// length (its escape length where it has no code, 5 bits: lengths are at
// most 31) at word t / 6, bit 5 (t % 6), and its escape flag at bit t of
// the flag word (word 1 from bit 20 for W = 2, word 3 for W = 4).  It
// covers the symbols up to the last one any table codes (17,906 in the
// shipped set: 143 KB at 8 bytes) plus one entry of escapes in every
// table, which every later symbol reads: the line loop loads one entry a
// line and makes no other load of the tables.  A CTA copies the set into
// its shared memory in one bulk copy (cp.async.bulk, completed on an
// mbarrier) while it loads its first lines and peaks; a set that does not
// fit (codes on every symbol, more than 10 tables) is read from device
// memory by the same loop.
//
// The sums: a lane adds the lengths as 5-bit fields into 10-bit lanes of
// two words a length word (the even fields, and the odd ones shifted down),
// and the escape flags as five 6-bit lanes a word (spread by one multiply):
// 32 lines a lane cost at most 992 and 32 escapes, so nothing carries.
// Before the scan each table's sum becomes length + a x escapes (at most
// 1,024 x 47 = 48,128 a row) in 16-bit halves.  Integer sums: exact in any
// order.
//
// Exactness: the mantissas are pactpu_torch/ops/quantize.py's, operation
// for operation: 2^k from the table the wrapper computes with
// quantize.exp2i on the card, a * b + c as quantize.fma32 (float64
// product and sum, one rounding to float32) or quantize.fma64 (Dekker's
// product and Knuth's sum; the split of the band's 2^k is taken once a
// band, the same values), every other product and sum written with the
// _rn intrinsics so that nvcc contracts nothing, the msb of the quantized
// peak from its integer value (frexp's exponent of an exact int32).
//
// Bound on the H100 (a 512-block stereo chunk, 25 bands, 10 tables): 4.2
// MB of lines and 1.3 MB of tables in, 17.4 MB of cost out, 0.0068 ms at
// 3.35 TB/s; the operations, 16 allocations x 1.05 M lines x ~18, 0.0045
// ms.  What bounds this kernel is issue and latency: a line step is about
// 48 instructions a warp (3 conversions to and from float64 for fma32, one
// 8-byte table load, the 20 of the sums), one CTA of 16 warps an SM (118
// to 128 registers in every form, 512 threads: the register file and the
// table's 143 KB allow no more), 4 warps a scheduler.  A warp's line steps
// overlap little (ptxas keeps each shared load behind the band-start
// stores before it), so a step takes about 295 clocks a warp where the
// instructions of 16 warps need 192 (PERF.md: tools/k10_phase_clock.py).
// It runs on a second stream beside K7 (codec/exact.py), so the exact
// mode's chain waits for it on a file's first chunk only.

#include "kernels.h"

#include <math.h>

namespace {

constexpr int kAllocs = 17;
constexpr int kMaxTables = 16;
constexpr int kLaneLines = 32;     // lines a lane: 1,024 lines a block
constexpr int kMaxWarps = 16;      // one an allocation
constexpr unsigned kFull = 0xffffffffu;

template <typename T>
struct Arith;

template <>
struct Arith<float> {
  using Bits = unsigned;
  static __device__ __forceinline__ float sub(float a, float b) {
    return __fsub_rn(a, b);
  }
  static __device__ __forceinline__ float mul(float a, float b) {
    return __fmul_rn(a, b);
  }
  // quantize.fma32: the product exact in float64, the sum rounded there,
  // then rounded to float32
  static __device__ __forceinline__ float fma(float a, float b, float c) {
    return __double2float_rn(__dadd_rn(
        __dmul_rn(static_cast<double>(a), static_cast<double>(b)),
        static_cast<double>(c)));
  }
  static __device__ __forceinline__ Bits bits(float x) {
    return __float_as_uint(x);
  }
  static __device__ __forceinline__ float from_bits(Bits b) {
    return __uint_as_float(b);
  }
  static __device__ __forceinline__ float floor(float x) { return floorf(x); }
  static __device__ __forceinline__ int to_int(float x) {
    return __float2int_rz(x);
  }
  static __device__ __forceinline__ float abs(float x) { return fabsf(x); }
};

template <>
struct Arith<double> {
  using Bits = unsigned long long;
  static __device__ __forceinline__ double sub(double a, double b) {
    return __dsub_rn(a, b);
  }
  static __device__ __forceinline__ double mul(double a, double b) {
    return __dmul_rn(a, b);
  }
  // quantize._split: Veltkamp's split with 2^27 + 1
  static __device__ __forceinline__ void split(double x, double& hi,
                                               double& lo) {
    const double t = __dmul_rn(134217729.0, x);
    hi = __dsub_rn(t, __dsub_rn(t, x));
    lo = __dsub_rn(x, hi);
  }
  // quantize.fma64, in its order of operations, b's split (bh, bl) given
  static __device__ __forceinline__ double fma(double a, double b, double bh,
                                               double bl, double c) {
    const double p = __dmul_rn(a, b);
    double ah, al;
    split(a, ah, al);
    const double e = __dadd_rn(
        __dadd_rn(__dadd_rn(__dsub_rn(__dmul_rn(ah, bh), p),
                            __dmul_rn(ah, bl)),
                  __dmul_rn(al, bh)),
        __dmul_rn(al, bl));
    const double s = __dadd_rn(p, c);
    const double bb = __dsub_rn(s, p);
    const double t = __dadd_rn(__dsub_rn(p, __dsub_rn(s, bb)),
                               __dsub_rn(c, bb));
    return __dadd_rn(s, __dadd_rn(t, e));
  }
  static __device__ __forceinline__ double fma(double a, double b,
                                               double c) {
    double bh, bl;
    split(b, bh, bl);
    return fma(a, b, bh, bl, c);
  }
  static __device__ __forceinline__ Bits bits(double x) {
    return static_cast<Bits>(__double_as_longlong(x));
  }
  static __device__ __forceinline__ double from_bits(Bits b) {
    return __longlong_as_double(static_cast<long long>(b));
  }
  static __device__ __forceinline__ double floor(double x) {
    return ::floor(x);
  }
  static __device__ __forceinline__ int to_int(double x) {
    return __double2int_rz(x);
  }
  static __device__ __forceinline__ double abs(double x) { return fabs(x); }
};

// A band's quantizer at a warp's allocation: 2^(a + scale - 1) (float64
// for fma32's product; with its split for fma64), 2^(scale - L - 1), and
// the overload level.
template <typename T>
struct Param;

template <>
struct Param<float> {
  double e_hi;
  float e_low;
  int clip;
};

template <>
struct Param<double> {
  double e_hi, e_hi_h, e_hi_l, e_low;
  int clip;
};

// The packed table set's shape for W words a symbol: words of lengths,
// groups of five escape flags, the flag word and its first bit, the most
// tables.
template <int W>
struct Pack;

template <>
struct Pack<2> {
  static constexpr int kLenWords = 2, kFlagGroups = 2, kFlagWord = 1,
                       kFlagBit = 20, kTables = 10;
  using Vec = uint2;
};

template <>
struct Pack<4> {
  static constexpr int kLenWords = 3, kFlagGroups = 4, kFlagWord = 3,
                       kFlagBit = 0, kTables = 16;
  using Vec = uint4;
};

__host__ __device__ inline int align16(int n) { return (n + 15) & ~15; }

// Shared memory: the CTA's part, then each warp's.
struct Smem {
  int tab, lines, e2, peak, rlo, rown, rband, rank, mbar, ranks,  // CTA
      block, shared;
  int prm, eb, ex, pre, per_warp;            // a warp, from its base
  int total(int warps) const { return shared + warps * per_warp; }
};

// narrow sums a band start records: the even and odd length lanes of each
// length word, then the flag groups
template <int W>
__host__ __device__ constexpr int narrow_words() {
  return 2 * Pack<W>::kLenWords + Pack<W>::kFlagGroups;
}

// 16-bit halves of the wide sums: two tables a word
template <int W>
__host__ __device__ constexpr int wide_words() {
  return Pack<W>::kTables / 2;
}

template <typename T, int W>
__host__ __device__ inline Smem smem_layout(int n_bands, int tab_rows,
                                            int half, int n_tab, int n_e2,
                                            bool tab_smem, bool staged) {
  Smem s;
  const int lpl = (half + 31) / 32;
  s.tab = 0;
  s.lines = s.tab + (tab_smem ? align16(tab_rows * W * 4) : 0);
  s.e2 = s.lines + align16(2 * 32 * (lpl | 1) * static_cast<int>(sizeof(T)));
  s.peak = s.e2 + align16(n_e2 * static_cast<int>(sizeof(T)));
  s.rlo = s.peak + align16(2 * n_bands * static_cast<int>(sizeof(T)));
  s.rown = s.rlo + align16((n_bands + 1) * 4);
  s.rband = s.rown + align16((n_bands + 1) * 4);
  s.rank = s.rband + align16(n_bands * 4);
  s.mbar = s.rank + align16(n_bands * 4);
  s.ranks = s.mbar + 8;
  s.block = s.mbar + 16;
  s.shared = s.block + (staged ? align16(n_bands * kAllocs * n_tab * 4) : 0);
  s.prm = 0;
  s.eb = s.prm + align16(n_bands * static_cast<int>(sizeof(Param<T>)));
  s.ex = s.eb + align16(n_bands * narrow_words<W>() * 4);
  s.pre = s.ex + align16(32 * wide_words<W>() * 4);
  s.per_warp = s.pre + align16((n_bands + 1) * wide_words<W>() * 4);
  return s;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// cp.async of one line (4 or 8 bytes) into shared memory
template <typename T>
__device__ __forceinline__ void cp_async_line(T* dst, const T* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "n"(sizeof(T))
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile(
      "mbarrier.init.shared::cta.b64 [%0], 1;\n"
      "fence.mbarrier_init.release.cluster;\n" ::"r"(smem_addr(bar))
      : "memory");
}

// one bulk copy of `bytes` (a multiple of 16) into shared memory, completed
// on `bar`
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%2], [%3], %1, [%0];\n" ::"r"(smem_addr(bar)),
      "r"(bytes), "r"(smem_addr(dst)), "l"(src)
      : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done)
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
}

// quantize.scale_factor of a band peak at allocation a
template <typename T>
__device__ __forceinline__ int scale_factor(T peak, int a, int L,
                                            const T* e2) {
  using A = Arith<T>;
  const int r = a + L;
  int q;
  if (peak >= T(1)) {
    q = (1 << (r - 1)) - 1;                     // the overload level
  } else {
    const T largest = A::sub(e2[r + L + 1], T(1));
    q = static_cast<int>(
        A::floor(A::mul(A::fma(largest, peak, T(1)), T(0.5))));
  }
  const int msb = q > 0 ? 31 - __clz(q) : -1;
  return min(max(r - 2 - msb, 0), L);
}

template <typename T>
__device__ __forceinline__ Param<T> make_param(int scale, int a, int L,
                                               const T* e2);

template <>
__device__ __forceinline__ Param<float> make_param<float>(int scale, int a,
                                                          int L,
                                                          const float* e2) {
  Param<float> p;
  p.e_hi = static_cast<double>(e2[a + scale + L]);
  p.e_low = e2[scale];
  p.clip = ((1 << (a + L - 1)) - 1) >> (L - scale);
  return p;
}

template <>
__device__ __forceinline__ Param<double> make_param<double>(
    int scale, int a, int L, const double* e2) {
  Param<double> p;
  p.e_hi = e2[a + scale + L];
  Arith<double>::split(p.e_hi, p.e_hi_h, p.e_hi_l);
  p.e_low = e2[scale];
  p.clip = ((1 << (a + L - 1)) - 1) >> (L - scale);
  return p;
}

// quantize.bfp_mantissa's magnitude of |x| under a band's quantizer
__device__ __forceinline__ int magnitude(float ax, const Param<float>& p) {
  using A = Arith<float>;
  const float low = A::mul(A::sub(1.0f, ax), p.e_low);
  const int q = A::to_int(A::floor(__double2float_rn(__dadd_rn(
      __dmul_rn(static_cast<double>(ax), p.e_hi),
      static_cast<double>(low)))));
  return ax >= 1.0f ? p.clip : q;
}

__device__ __forceinline__ int magnitude(double ax, const Param<double>& p) {
  using A = Arith<double>;
  const double low = A::mul(A::sub(1.0, ax), p.e_low);
  const int q =
      A::to_int(A::floor(A::fma(ax, p.e_hi, p.e_hi_h, p.e_hi_l, low)));
  return ax >= 1.0 ? p.clip : q;
}

template <int W>
__device__ __forceinline__ void table_load(const uint32_t* tab, int idx,
                                           uint32_t (&w)[W], bool global) {
  using Vec = typename Pack<W>::Vec;
  const Vec* p = reinterpret_cast<const Vec*>(tab) + idx;
  const Vec v = global ? __ldg(p) : *p;
  w[0] = v.x;
  w[1] = v.y;
  if constexpr (W == 4) {
    w[2] = v.z;
    w[3] = v.w;
  }
}

// Narrow sums (even and odd length lanes, flag groups) to each table's
// length + a x escapes, two tables a word in 16-bit halves.
template <int W>
__device__ __forceinline__ void widen(
    const uint32_t (&even)[Pack<W>::kLenWords],
    const uint32_t (&odd)[Pack<W>::kLenWords],
    const uint32_t (&flag)[Pack<W>::kFlagGroups], int n_tab, int a,
    uint32_t (&wide)[wide_words<W>()]) {
#pragma unroll
  for (int k = 0; k < wide_words<W>(); ++k) wide[k] = 0;
#pragma unroll
  for (int t = 0; t < Pack<W>::kTables; ++t) {
    const int k = t / 6, i = t % 6;
    const uint32_t v =
        ((i & 1 ? odd[k] : even[k]) >> (10 * (i >> 1))) & 0x3ffu;
    const uint32_t e = (flag[t / 5] >> (6 * (t % 5))) & 0x3fu;
    wide[t >> 1] += t < n_tab ? (v + a * e) << (16 * (t & 1)) : 0u;
  }
}

// A lane's running sums over its lines at one allocation (the line loop),
// recorded at each line that starts a band (rank r: eb[r]).  No branch:
// the band of line j is r0 + the starts in 1..j, the band start's record
// is a predicated store, and a line past the lane's count adds a zero
// entry, so that the 32 line steps are one block the compiler interleaves
// (the records' stores provably miss the lines, parameters and table it
// loads: __restrict__).
template <typename T, int W, bool kTabSmem>
__device__ __forceinline__ void line_sums(
    const T* __restrict__ xs, const Param<T>* __restrict__ prm,
    const uint32_t* __restrict__ tab, uint32_t* __restrict__ eb, int count,
    int r0, unsigned starts, int mask, int n_sym, int n_pack,
    const uint32_t (&m_even)[Pack<W>::kLenWords],
    const uint32_t (&m_odd)[Pack<W>::kLenWords],
    uint32_t (&even)[Pack<W>::kLenWords], uint32_t (&odd)[Pack<W>::kLenWords],
    uint32_t (&flag)[Pack<W>::kFlagGroups]) {
  using A = Arith<T>;
  using P = Pack<W>;
  constexpr int kLen = P::kLenWords, kGroups = P::kFlagGroups;
  constexpr int kNarrow = narrow_words<W>();
#pragma unroll
  for (int k = 0; k < kLen; ++k) even[k] = odd[k] = 0;
#pragma unroll
  for (int g = 0; g < kGroups; ++g) flag[g] = 0;
#pragma unroll
  for (int j = 0; j < kLaneLines; ++j) {
    const int r = r0 + __popc(starts & ((2u << j) - 2u));
    if ((starts >> j) & 1u) {              // a band starts here
      uint32_t* rec = eb + r * kNarrow;
#pragma unroll
      for (int k = 0; k < kLen; ++k) {
        rec[k] = even[k];
        rec[kLen + k] = odd[k];
      }
#pragma unroll
      for (int g = 0; g < kGroups; ++g) rec[2 * kLen + g] = flag[g];
    }
    // quantize.bfp_mantissa and huffman.split_sign: the unsigned symbol
    // does not depend on the sign; past the packed entries, the escapes'
    // entry
    const int mag = magnitude(A::abs(xs[j]), prm[r]);
    const int idx = min(min(mag & mask, n_sym - 1), n_pack);
    uint32_t w[W];
    table_load<W>(tab, idx, w, !kTabSmem);
    const uint32_t live = j < count ? 0xffffffffu : 0u;
#pragma unroll
    for (int k = 0; k < W; ++k) w[k] &= live;
#pragma unroll
    for (int k = 0; k < kLen; ++k) {
      even[k] += w[k] & m_even[k];
      odd[k] += (w[k] >> 5) & m_odd[k];
    }
    const uint32_t f = w[P::kFlagWord] >> P::kFlagBit;
#pragma unroll
    for (int g = 0; g < kGroups; ++g)
      flag[g] += (((f >> (5 * g)) & 0x1fu) * 0x108421u) & 0x01041041u;
  }
}

// Each band's sums at allocation a into the item's block.  pre: rank r's
// prefix at its first line (its record, widened, plus its lane's exclusive
// prefix ex), and at rank n_ranks the row's total, already there; each
// band's sums are the next rank's prefix less its own, two 16-bit
// differences in one subtraction (no borrow: both prefixes only grow).
template <int W>
__device__ __forceinline__ void band_sums(
    const int* __restrict__ rown, const int* __restrict__ rband,
    const uint32_t* __restrict__ eb, const uint32_t* __restrict__ ex,
    uint32_t* __restrict__ pre, int32_t* __restrict__ dst, int n_ranks,
    int n_tab, int a, int lane) {
  using P = Pack<W>;
  constexpr int kLen = P::kLenWords, kGroups = P::kFlagGroups;
  constexpr int kNarrow = narrow_words<W>(), kWide = wide_words<W>();
  for (int r = lane; r < n_ranks; r += 32) {
    const uint32_t* rec = eb + r * kNarrow;
    uint32_t even[kLen], odd[kLen], flag[kGroups], wide[kWide];
#pragma unroll
    for (int k = 0; k < kLen; ++k) {
      even[k] = rec[k];
      odd[k] = rec[kLen + k];
    }
#pragma unroll
    for (int g = 0; g < kGroups; ++g) flag[g] = rec[2 * kLen + g];
    widen<W>(even, odd, flag, n_tab, a, wide);
#pragma unroll
    for (int k = 0; k < kWide; ++k)
      pre[r * kWide + k] = wide[k] + ex[rown[r] * kWide + k];
  }
  __syncwarp();
  for (int r = lane; r < n_ranks; r += 32) {
    int32_t* o = dst + (rband[r] * kAllocs + a) * n_tab;
#pragma unroll
    for (int k = 0; k < kWide; ++k) {
      const uint32_t v = pre[(r + 1) * kWide + k] - pre[r * kWide + k];
      if (2 * k < n_tab) o[2 * k] = static_cast<int32_t>(v & 0xffffu);
      if (2 * k + 1 < n_tab) o[2 * k + 1] = static_cast<int32_t>(v >> 16);
    }
  }
}

template <typename T, int W, bool kTabSmem>
__global__ void __launch_bounds__(32 * kMaxWarps, 1)
cost_table_kernel(const T* __restrict__ mixed,
                  const int32_t* __restrict__ n_lines,
                  const uint32_t* __restrict__ packed,
                  const T* __restrict__ exp2_tab, int32_t* __restrict__ cost,
                  int items, int half, int n_bands, int n_tab, int n_sym,
                  int n_pack, int tab_rows, int L, int max_mant, int n_e2,
                  int staged) {
  using A = Arith<T>;
  using Bits = typename A::Bits;
  using P = Pack<W>;
  constexpr int kLen = P::kLenWords, kGroups = P::kFlagGroups;
  constexpr int kWide = wide_words<W>();
  extern __shared__ __align__(16) unsigned char smem[];
  const Smem lay = smem_layout<T, W>(n_bands, tab_rows, half, n_tab, n_e2,
                                     kTabSmem, staged != 0);
  const uint32_t* tab =
      kTabSmem ? reinterpret_cast<const uint32_t*>(smem + lay.tab) : packed;
  T* lines = reinterpret_cast<T*>(smem + lay.lines);
  T* e2 = reinterpret_cast<T*>(smem + lay.e2);
  Bits* peak = reinterpret_cast<Bits*>(smem + lay.peak);
  int* rlo = reinterpret_cast<int*>(smem + lay.rlo);    // a rank's 1st line
  int* rown = reinterpret_cast<int*>(smem + lay.rown);  // ... its lane
  int* rband = reinterpret_cast<int*>(smem + lay.rband);  // ... its band
  int* rank = reinterpret_cast<int*>(smem + lay.rank);  // band -> rank, -1
  uint64_t* mbar = reinterpret_cast<uint64_t*>(smem + lay.mbar);
  int* n_ranks_s = reinterpret_cast<int*>(smem + lay.ranks);
  int32_t* block = reinterpret_cast<int32_t*>(smem + lay.block);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  unsigned char* mine = smem + lay.shared + warp * lay.per_warp;
  Param<T>* prm = reinterpret_cast<Param<T>*>(mine + lay.prm);
  uint32_t* eb = reinterpret_cast<uint32_t*>(mine + lay.eb);
  uint32_t* ex = reinterpret_cast<uint32_t*>(mine + lay.ex);
  uint32_t* pre = reinterpret_cast<uint32_t*>(mine + lay.pre);
  const int lpl = (half + 31) / 32, stride = lpl | 1;
  const int n_out = n_bands * kAllocs * n_tab;

  // each thread's lines of an item: line x to lane x / lpl's run
  auto load_lines = [&](int item, int buf) {
    const T* row = mixed + static_cast<int64_t>(item) * half;
    T* dst = lines + buf * 32 * stride;
    for (int x = threadIdx.x; x < half; x += blockDim.x)
      cp_async_line(dst + (x / lpl) * stride + x % lpl, row + x);
    cp_async_commit();
  };

  // the table set: one bulk copy, waited for before the first line loop
  if (kTabSmem && threadIdx.x == 0) mbar_init(mbar);
  __syncthreads();
  if (kTabSmem && threadIdx.x == 0)
    bulk_load(smem + lay.tab, packed,
              static_cast<uint32_t>(tab_rows * W * 4), mbar);
  load_lines(blockIdx.x, 0);
  for (int k = threadIdx.x; k < n_e2; k += blockDim.x) e2[k] = exp2_tab[k];
  for (int b = threadIdx.x; b < 2 * n_bands; b += blockDim.x) peak[b] = 0;
  if (staged)
    for (int k = threadIdx.x; k < n_out; k += blockDim.x) block[k] = 0;
  // the non-empty bands in order ("ranks"): first lines, owner lanes
  if (warp == 0) {
    int carry = 0, ranks = 0;
    for (int base = 0; base < n_bands; base += 32) {
      const int b = base + lane;
      const int v = b < n_bands ? n_lines[b] : 0;
      int incl = v;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int u = __shfl_up_sync(kFull, incl, o);
        if (lane >= o) incl += u;
      }
      const int lo = carry + incl - v;
      const bool live = b < n_bands && v > 0 && lo < half;
      const unsigned alive = __ballot_sync(kFull, live);
      const int r = ranks + __popc(alive & ((1u << lane) - 1u));
      if (b < n_bands) rank[b] = live ? r : -1;
      if (live) {
        rlo[r] = lo;
        rown[r] = lo / lpl;
        rband[r] = b;
      }
      carry += __shfl_sync(kFull, incl, 31);
      ranks += __popc(alive);
    }
    if (lane == 0) {
      rlo[ranks] = min(carry, half);
      *n_ranks_s = ranks;
    }
  }
  __syncthreads();

  // this lane's lines [x0, x0 + count), the rank of the first (r0), and
  // which of them start a rank: line j's rank is r0 + the starts in 1..j
  const int n_ranks = *n_ranks_s;
  const int total = rlo[n_ranks];
  const int x0 = lane * lpl;
  const int count = max(0, min(lpl, total - x0));
  int r0 = 0;
  unsigned starts = 0;
  if (count > 0) {
    int lo = 0, hi = n_ranks - 1;          // the last rank starting <= x0
    while (lo < hi) {
      const int m = (lo + hi + 1) >> 1;
      if (rlo[m] <= x0) lo = m; else hi = m - 1;
    }
    r0 = lo;
    for (int r = r0; r < n_ranks && rlo[r] < x0 + count; ++r)
      if (rlo[r] >= x0) starts |= 1u << (rlo[r] - x0);
  }
  // the length lanes of each length word (even fields, and odd ones after
  // the shift by 5) that hold one of the n_tab tables
  uint32_t m_even[kLen], m_odd[kLen];
#pragma unroll
  for (int k = 0; k < kLen; ++k) {
    m_even[k] = m_odd[k] = 0;
#pragma unroll
    for (int i = 0; i < 6; ++i)
      if (6 * k + i < n_tab) {
        if (i & 1) m_odd[k] |= 0x1fu << (5 * (i - 1));
        else m_even[k] |= 0x1fu << (5 * i);
      }
  }
  const int peak_span = (lpl + warps - 1) / warps;   // lines a lane a warp

  // the band peaks of the lines in buffer `buf` into pk: warp w takes
  // lines [w span, (w + 1) span) of each lane's, a shared-memory maximum of
  // each run's bit patterns (|x| >= 0)
  auto band_peaks = [&](int buf, Bits* pk) {
    const T* xs = lines + buf * 32 * stride + lane * stride;
    const int j1 = min((warp + 1) * peak_span, count);
    Bits run = 0;
    int at = -1;
    for (int j = warp * peak_span; j < j1; ++j) {
      const int r = r0 + __popc(starts & ((2u << j) - 2u));
      if (r != at) {
        if (at >= 0) atomicMax(pk + at, run);
        run = 0;
        at = r;
      }
      run = max(run, A::bits(A::abs(xs[j])));
    }
    if (at >= 0) atomicMax(pk + at, run);
  };

  // Two barriers an item: the item's peaks before its allocations, and its
  // block whole (and the next item's lines in) before the block leaves
  // while the next item's peaks are taken.  An item's lines and peaks
  // alternate between two buffers.
  cp_async_wait_all();
  __syncthreads();
  if (blockIdx.x + gridDim.x < items) load_lines(blockIdx.x + gridDim.x, 1);
  band_peaks(0, peak);
  if (kTabSmem) mbar_wait(mbar, 0);
  for (int item = blockIdx.x, buf = 0; item < items;
       item += gridDim.x, buf ^= 1) {
    __syncthreads();
    const T* xs = lines + buf * 32 * stride + lane * stride;
    Bits* pk = peak + buf * n_bands;
    int32_t* dst = staged ? block : cost + static_cast<int64_t>(item) * n_out;
    if (!staged) {  // allocation 0, those past max_mant, empty bands: zero
      for (int i = threadIdx.x; i < n_out; i += blockDim.x) {
        const int a = i / n_tab % kAllocs, b = i / (n_tab * kAllocs);
        if (a == 0 || a > max_mant || rank[b] < 0) dst[i] = 0;
      }
    }
    for (int a = warp + 1; a <= max_mant; a += warps) {
      for (int r = lane; r < n_ranks; r += 32)
        prm[r] = make_param<T>(scale_factor<T>(A::from_bits(pk[r]), a, L,
                                               e2),
                               a, L, e2);
      const int mask = (1 << (a - 1)) - 1;
      __syncwarp();

      uint32_t even[kLen], odd[kLen], flag[kGroups];
      line_sums<T, W, kTabSmem>(xs, prm, tab, eb, count, r0, starts, mask,
                                n_sym, n_pack, m_even, m_odd, even, odd,
                                flag);

      // each table's length + a x escapes in 16-bit halves, then the lanes'
      // sums into the row's prefix: one exclusive warp scan
      uint32_t wide[kWide];
      widen<W>(even, odd, flag, n_tab, a, wide);
#pragma unroll
      for (int k = 0; k < kWide; ++k) {
        uint32_t incl = wide[k];
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
          const uint32_t u = __shfl_up_sync(kFull, incl, o);
          if (lane >= o) incl += u;
        }
        ex[lane * kWide + k] = incl - wide[k];
        if (lane == 31) pre[n_ranks * kWide + k] = incl;
      }
      __syncwarp();
      band_sums<W>(rown, rband, eb, ex, pre, dst, n_ranks, n_tab, a, lane);
      __syncwarp();
    }
    cp_async_wait_all();
    __syncthreads();

    // the item after next into this buffer; these peaks start from zero
    // for it; the block leaves whole; the next item's peaks
    const int next = item + gridDim.x;
    if (next + gridDim.x < items) load_lines(next + gridDim.x, buf);
    for (int r = threadIdx.x; r < n_ranks; r += blockDim.x) pk[r] = 0;
    if (staged) {
      int32_t* g = cost + static_cast<int64_t>(item) * n_out;
      const int head = min(n_out, static_cast<int>(
          (0u - static_cast<unsigned>(reinterpret_cast<uintptr_t>(g) >> 2))
          & 3u));
      const int vecs = (n_out - head) >> 2;
      int4* gv = reinterpret_cast<int4*>(g + head);
      for (int k = threadIdx.x; k < head; k += blockDim.x) g[k] = block[k];
      for (int v = threadIdx.x; v < vecs; v += blockDim.x) {
        const int32_t* s = block + head + 4 * v;
        gv[v] = make_int4(s[0], s[1], s[2], s[3]);
      }
      for (int k = head + 4 * vecs + threadIdx.x; k < n_out;
           k += blockDim.x)
        g[k] = block[k];
    }
    if (next < items) band_peaks(buf ^ 1, peak + (buf ^ 1) * n_bands);
  }
}

template <typename T, int W, bool kTabSmem>
int start(const T* mixed, const int32_t* n_lines, const uint32_t* packed,
          const T* exp2_tab, int32_t* cost, int items, int half, int n_bands,
          int n_tab, int n_sym, int n_pack, int tab_rows, int L, int max_mant,
          int n_e2, int warps, int staged, int smem, int sms,
          cudaStream_t stream) {
  auto kernel = cost_table_kernel<T, W, kTabSmem>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  int per_sm = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                    32 * warps, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int64_t slots = static_cast<int64_t>(per_sm < 1 ? 1 : per_sm) * sms;
  const int grid = static_cast<int>(items < slots ? items : slots);
  kernel<<<grid, 32 * warps, smem, stream>>>(
      mixed, n_lines, packed, exp2_tab, cost, items, half, n_bands, n_tab,
      n_sym, n_pack, tab_rows, L, max_mant, n_e2, staged);
  return static_cast<int>(cudaGetLastError());
}

// The first layout that fits the card's shared memory, in this order: the
// table set and the item's block in shared memory, the block stored
// directly, the table read from device memory (with and without the
// block); the same with fewer warps (many bands).
template <typename T, int W>
int launch(const T* mixed, const int32_t* n_lines, const uint32_t* packed,
           const T* exp2_tab, int32_t* cost, int items, int half,
           int n_bands, int n_tab, int n_sym, int n_pack, int tab_rows, int L,
           int max_mant, cudaStream_t stream) {
  const int n_e2 = 2 * L + max_mant + 2;
  int dev = 0, sms = 0, max_smem = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                         dev);
  const int want = max_mant < kMaxWarps ? max_mant : kMaxWarps;
  for (int warps = want; warps >= 1; --warps)
    for (int form = 0; form < 4; ++form) {
      const bool tab_smem = form < 2, staged = form % 2 == 0;
      const Smem lay = smem_layout<T, W>(n_bands, tab_rows, half, n_tab,
                                         n_e2, tab_smem, staged);
      const int smem = lay.total(warps);
      if (smem > max_smem) continue;
      return tab_smem
                 ? start<T, W, true>(mixed, n_lines, packed, exp2_tab, cost,
                                     items, half, n_bands, n_tab, n_sym,
                                     n_pack, tab_rows, L, max_mant, n_e2,
                                     warps, staged, smem, sms, stream)
                 : start<T, W, false>(mixed, n_lines, packed, exp2_tab, cost,
                                      items, half, n_bands, n_tab, n_sym,
                                      n_pack, tab_rows, L, max_mant, n_e2,
                                      warps, staged, smem, sms, stream);
    }
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename T>
int dispatch(const T* mixed, const int32_t* n_lines, const uint32_t* packed,
             const T* exp2_tab, int32_t* cost, int items, int half,
             int n_bands, int n_tab, int n_sym, int n_pack, int tab_rows,
             int n_scale_bits, int max_mant, cudaStream_t stream) {
  const int L = (1 << n_scale_bits) - 1;
  if (n_tab < 1 || n_tab > kMaxTables || half < 1 ||
      half > 32 * kLaneLines || n_bands < 1 || n_sym < 1 || n_pack < 0 ||
      n_pack > n_sym || tab_rows < n_pack + 1 || max_mant < 1 ||
      max_mant >= kAllocs || L + max_mant > 31 ||
      (tab_rows * (n_tab > Pack<2>::kTables ? 4 : 2)) % 4 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (items == 0) return 0;
  if (n_tab <= Pack<2>::kTables)
    return launch<T, 2>(mixed, n_lines, packed, exp2_tab, cost, items, half,
                        n_bands, n_tab, n_sym, n_pack, tab_rows, L, max_mant,
                        stream);
  return launch<T, 4>(mixed, n_lines, packed, exp2_tab, cost, items, half,
                      n_bands, n_tab, n_sym, n_pack, tab_rows, L, max_mant,
                      stream);
}

}  // namespace

extern "C" int pactpu_cost_table_packed(
    const float* mixed, const int32_t* n_lines, const uint32_t* packed,
    const float* exp2_tab, int32_t* cost, int items, int half, int n_bands,
    int n_tab, int n_sym, int n_pack, int tab_rows, int n_scale_bits,
    int max_mant, cudaStream_t stream) {
  return dispatch<float>(mixed, n_lines, packed, exp2_tab, cost, items, half,
                         n_bands, n_tab, n_sym, n_pack, tab_rows,
                         n_scale_bits, max_mant, stream);
}

extern "C" int pactpu_cost_table_packed_f64(
    const double* mixed, const int32_t* n_lines, const uint32_t* packed,
    const double* exp2_tab, int32_t* cost, int items, int half, int n_bands,
    int n_tab, int n_sym, int n_pack, int tab_rows, int n_scale_bits,
    int max_mant, cudaStream_t stream) {
  return dispatch<double>(mixed, n_lines, packed, exp2_tab, cost, items, half,
                          n_bands, n_tab, n_sym, n_pack, tab_rows,
                          n_scale_bits, max_mant, stream);
}
