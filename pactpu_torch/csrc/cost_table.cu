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
// Design: one warp walks one (block, channel) item for a share of the
// allocations (items x split warps, `split` allocations apart), persistent
// CTAs of up to eight warps.  A lane holds 32 consecutive lines (1,024
// lines a block) in registers; each CTA stages the hot prefix of the
// symbols (the first 4,096) of the table set in shared memory as 4 bytes
// a word (one byte a table, up to 16 tables in one 16-byte load); a colder
// symbol reads its lengths from device memory.  Per allocation a lane
// adds its lines' lengths four at a time as bytes (an escape byte is 0 in
// the table: __vcmpeq4 selects the table's escape length + a instead),
// widens them to 16-bit pairs, and records its running prefix at each line
// that starts a band; one warp scan of the pairs turns the lane prefixes
// into the block's, and each band's sum is the difference of the prefixes
// at its two ends.  Integer sums: any order is exact.  Bounds of the
// packing: a line costs at most 31 + 16 bits, so four lines fit a byte and
// 1,024 lines a 16-bit field.
//
// Exactness: the mantissas are pactpu_torch/ops/quantize.py's, operation
// for operation: 2^k from the table the wrapper computes with
// quantize.exp2i on the card, a * b + c as quantize.fma32 (float64
// product and sum, one rounding to float32) or quantize.fma64 (Dekker's
// product and Knuth's sum), every other product and sum written with the
// _rn intrinsics so that nvcc contracts nothing, the msb of the quantized
// peak from its integer value (frexp's exponent of an exact int32).
//
// Bound on the H100 (a 512-block stereo chunk, 25 bands, 10 tables): 4.2
// MB of lines and 1.3 MB of tables in, 17.4 MB of cost out, 0.0068 ms at
// 3.35 TB/s; the operations, 16 allocations x 1.05 M lines x ~18, 0.0045
// ms.  It takes 0.20 ms alone (PERF.md), 29 times that, and is not yet
// profiled.  It runs on a second stream beside K7 (codec/exact.py), so
// the exact mode's chain waits for it on a file's first chunk only.

#include "kernels.h"

#include <math.h>

namespace {

constexpr int kAllocs = 17;
constexpr int kMaxTables = 16;
constexpr int kLineSlots = 32;     // lines a lane: 1,024 lines a block
constexpr int kHot = 4096;         // symbols staged in shared memory
constexpr int kWarps = 8;          // warps a CTA (fewer for wide layouts)
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
  // quantize.fma64, in its order of operations
  static __device__ __forceinline__ double fma(double a, double b,
                                               double c) {
    const double p = __dmul_rn(a, b);
    double ah, al, bh, bl;
    split(a, ah, al);
    split(b, bh, bl);
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
  static __device__ __forceinline__ Bits bits(double x) {
    return static_cast<Bits>(__double_as_longlong(x));
  }
  static __device__ __forceinline__ double from_bits(Bits b) {
    return __longlong_as_double(static_cast<long long>(b));
  }
  static __device__ __forceinline__ double floor(double x) {
    return ::floor(x);
  }
  static __device__ __forceinline__ double abs(double x) { return fabs(x); }
};

__host__ __device__ inline int align16(int n) { return (n + 15) & ~15; }

// Shared memory: a CTA's part, then each warp's.
struct Smem {
  int hot, e2, lo, nxt, shared;                  // CTA
  int peak, sf, eb, ex, per_warp;                // a warp, from its base
};

__host__ __device__ inline Smem smem_layout(int n_bands, int hot, int n_e2,
                                            int w4, int tsize) {
  Smem s;
  const int hs = w4 == 3 ? 4 : w4;               // words a hot symbol
  s.hot = 0;
  s.e2 = s.hot + align16(hot * hs * 4);
  s.lo = s.e2 + align16(n_e2 * tsize);
  s.nxt = s.lo + align16((n_bands + 1) * 4);
  s.shared = s.nxt + align16(n_bands * 4);
  s.peak = 0;
  s.sf = s.peak + align16(n_bands * tsize);
  s.eb = s.sf + align16(n_bands * 4);
  s.ex = s.eb + align16(n_bands * 2 * w4 * 4);
  s.per_warp = s.ex + align16(32 * 2 * w4 * 4);
  return s;
}

// The last band whose first line is at or before line x (the band that
// holds x, past any empty band that starts there).
__device__ __forceinline__ int band_of(const int* lo, int n_bands, int x) {
  int a = 0, b = n_bands - 1;
  while (a < b) {
    const int m = (a + b + 1) >> 1;
    if (lo[m] <= x) a = m; else b = m - 1;
  }
  return a;
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

template <int W4>
__device__ __forceinline__ void hot_load(const uint32_t* hot, int sym,
                                         uint32_t (&w)[W4]) {
  if constexpr (W4 == 1) {
    w[0] = hot[sym];
  } else if constexpr (W4 == 2) {
    const uint2 v = reinterpret_cast<const uint2*>(hot)[sym];
    w[0] = v.x;
    w[1] = v.y;
  } else {
    const uint4 v = reinterpret_cast<const uint4*>(hot)[sym];
    w[0] = v.x;
    w[1] = v.y;
    w[2] = v.z;
    if constexpr (W4 == 4) w[3] = v.w;
  }
}

template <int W4>
struct Words {
  uint32_t w[W4];
};

// a symbol past the staged prefix: its lengths from device memory (a call,
// so that the hot path does not carry its loads as predicated
// instructions)
template <int W4>
__device__ __noinline__ Words<W4> cold_load(
    const int32_t* __restrict__ tab_lens, int n_tab, int n_sym, int sym) {
  Words<W4> r;
#pragma unroll
  for (int k = 0; k < W4; ++k) r.w[k] = 0;
#pragma unroll
  for (int t = 0; t < 4 * W4; ++t)
    if (t < n_tab)
      r.w[t >> 2] |= static_cast<uint32_t>(
          __ldg(tab_lens + static_cast<int64_t>(t) * n_sym + sym) & 255)
          << (8 * (t & 3));
  return r;
}

template <typename T, int W4>
__global__ void __launch_bounds__(32 * kWarps)
cost_table_kernel(const T* __restrict__ mixed,
                  const int32_t* __restrict__ n_lines,
                  const int32_t* __restrict__ tab_lens,
                  const int32_t* __restrict__ esc_len,
                  const T* __restrict__ exp2_tab, int32_t* __restrict__ cost,
                  int items, int split, int half, int n_bands, int n_tab,
                  int n_sym, int L, int max_mant, int hot, int n_e2) {
  using A = Arith<T>;
  using Bits = typename A::Bits;
  constexpr int NP = 2 * W4;                       // 16-bit pair words
  extern __shared__ __align__(16) unsigned char smem[];
  const Smem lay = smem_layout(n_bands, hot, n_e2, W4, sizeof(T));
  uint32_t* hot_s = reinterpret_cast<uint32_t*>(smem + lay.hot);
  T* e2 = reinterpret_cast<T*>(smem + lay.e2);
  int* lo = reinterpret_cast<int*>(smem + lay.lo);
  int* nxt = reinterpret_cast<int*>(smem + lay.nxt);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  unsigned char* mine = smem + lay.shared + warp * lay.per_warp;
  Bits* peak = reinterpret_cast<Bits*>(mine + lay.peak);
  int* sf = reinterpret_cast<int*>(mine + lay.sf);
  uint32_t* eb = reinterpret_cast<uint32_t*>(mine + lay.eb);
  uint32_t* ex = reinterpret_cast<uint32_t*>(mine + lay.ex);

  // the CTA's tables: the hot symbols' lengths a byte a table, 2^k, the
  // bands' first lines and each band's next non-empty band
  constexpr int hs = W4 == 3 ? 4 : W4;
  for (int s = threadIdx.x; s < hot; s += blockDim.x) {
    uint32_t w[hs];
#pragma unroll
    for (int k = 0; k < hs; ++k) w[k] = 0;
#pragma unroll
    for (int t = 0; t < 4 * W4; ++t)
      if (t < n_tab)
        w[t >> 2] |= static_cast<uint32_t>(
            tab_lens[static_cast<int64_t>(t) * n_sym + s] & 255)
            << (8 * (t & 3));
#pragma unroll
    for (int k = 0; k < hs; ++k) hot_s[s * hs + k] = w[k];
  }
  for (int k = threadIdx.x; k < n_e2; k += blockDim.x) e2[k] = exp2_tab[k];
  if (warp == 0) {
    int carry = 0;
    for (int base = 0; base < n_bands; base += 32) {
      const int b = base + lane;
      const int v = b < n_bands ? n_lines[b] : 0;
      int incl = v;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int u = __shfl_up_sync(kFull, incl, o);
        if (lane >= o) incl += u;
      }
      if (b < n_bands) lo[b] = carry + incl - v;
      carry += __shfl_sync(kFull, incl, 31);
    }
    if (lane == 0) lo[n_bands] = carry;
    __syncwarp();
    for (int b = lane; b < n_bands; b += 32)
      nxt[b] = lo[b + 1] >= carry || lo[b + 1] == lo[b]
                   ? n_bands : band_of(lo, n_bands, lo[b + 1]);
  }
  // escape bytes: table t's escape length in byte t, and a 1 in each
  // real table's byte (the escape costs esc + a)
  uint32_t esc4[W4], one4[W4];
#pragma unroll
  for (int k = 0; k < W4; ++k) esc4[k] = one4[k] = 0;
#pragma unroll
  for (int t = 0; t < 4 * W4; ++t)
    if (t < n_tab) {
      esc4[t >> 2] |= static_cast<uint32_t>(esc_len[t] & 255)
                      << (8 * (t & 3));
      one4[t >> 2] |= 1u << (8 * (t & 3));
    }
  __syncthreads();

  // this lane's lines: [x0, x0 + count), the band of the first, and which
  // of them start a band
  const int total = min(lo[n_bands], half);
  const int lpl = (half + 31) / 32;
  const int x0 = lane * lpl;
  const int count = max(0, min(lpl, total - x0));
  const int band0 = count > 0 ? band_of(lo, n_bands, x0) : 0;
  // entry lane of the band sums' loop, and its step of 32 entries
  const int band_i0 = lane / n_tab, tab_i0 = lane % n_tab;
  const int band_step = 32 / n_tab, tab_step = 32 % n_tab;
  unsigned starts = 0;
  {
    int b = band0;
    for (int j = 0; j < count; ++j) {
      const int x = x0 + j;
      if (j > 0 && x == lo[b + 1]) b = nxt[b];
      if (x == lo[b]) starts |= 1u << j;
    }
  }
  for (int gw = blockIdx.x * warps + warp; gw < items * split;
       gw += gridDim.x * warps) {
    const int item = gw / split, part = gw % split;
    const T* row = mixed + static_cast<int64_t>(item) * half + x0;
    int32_t* out = cost + static_cast<int64_t>(item) * n_bands * kAllocs *
                              n_tab;
    T ax[kLineSlots];
#pragma unroll
    for (int j = 0; j < kLineSlots; ++j)
      ax[j] = j < count ? A::abs(row[j]) : T(0);

    // the band peaks (psycho.band_max with fill 0): each lane's runs,
    // then a shared-memory maximum of the bit patterns (|x| >= 0)
    for (int b = lane; b < n_bands; b += 32) peak[b] = 0;
    __syncwarp();
    {
      int b = band0;
      Bits run = 0;
#pragma unroll
      for (int j = 0; j < kLineSlots; ++j) {
        if (j < count) {
          if (j > 0 && ((starts >> j) & 1u)) {
            atomicMax(peak + b, run);
            run = 0;
            b = nxt[b];
          }
          run = max(run, A::bits(ax[j]));
        }
      }
      if (count > 0) atomicMax(peak + b, run);
    }
    // allocation 0 and those past max_mant: zero
    if (part == 0) {
      const int nz = kAllocs - max_mant;
      for (int i = lane; i < n_bands * nz * n_tab; i += 32) {
        const int t = i % n_tab, z = (i / n_tab) % nz, b = i / (n_tab * nz);
        const int a = z == 0 ? 0 : max_mant + z;
        out[(static_cast<int64_t>(b) * kAllocs + a) * n_tab + t] = 0;
      }
    }
    __syncwarp();

    for (int a = 1 + part; a <= max_mant; a += split) {
      for (int b = lane; b < n_bands; b += 32)
        sf[b] = scale_factor<T>(A::from_bits(peak[b]), a, L, e2);
      uint32_t e4[W4];
#pragma unroll
      for (int k = 0; k < W4; ++k) e4[k] = esc4[k] + one4[k] * a;
      const int mask = (1 << (a - 1)) - 1;
      const int clip_full = (1 << (a + L - 1)) - 1;
      __syncwarp();

      uint32_t pre[NP], run[W4];
#pragma unroll
      for (int k = 0; k < NP; ++k) pre[k] = 0;
#pragma unroll
      for (int k = 0; k < W4; ++k) run[k] = 0;
      int b = band0;
      int scale = sf[b];
      T e_low = e2[scale], e_hi = e2[a + scale + L];
      int clip = clip_full >> (L - scale);
#pragma unroll
      for (int j = 0; j < kLineSlots; ++j) {
        if (j < count) {
          if ((starts >> j) & 1u) {
            if (j > 0) {
              b = nxt[b];
              scale = sf[b];
              e_low = e2[scale];
              e_hi = e2[a + scale + L];
              clip = clip_full >> (L - scale);
            }
            // the lane's prefix at the band's first line
#pragma unroll
            for (int k = 0; k < W4; ++k) {
              pre[2 * k] += run[k] & 0x00ff00ffu;
              pre[2 * k + 1] += (run[k] >> 8) & 0x00ff00ffu;
              run[k] = 0;
            }
#pragma unroll
            for (int k = 0; k < NP; ++k) eb[b * NP + k] = pre[k];
          }
          // quantize.bfp_mantissa and huffman.split_sign: the unsigned
          // symbol does not depend on the sign
          int mag;
          if (ax[j] >= T(1)) {
            mag = clip;
          } else {
            const T low = A::mul(A::sub(T(1), ax[j]), e_low);
            mag = static_cast<int>(A::floor(A::fma(ax[j], e_hi, low)));
          }
          const int sym = min(mag & mask, n_sym - 1);
          uint32_t w[W4];
          if (sym < hot) {
            hot_load<W4>(hot_s, sym, w);
          } else {
            const Words<W4> c = cold_load<W4>(tab_lens, n_tab, n_sym, sym);
#pragma unroll
            for (int k = 0; k < W4; ++k) w[k] = c.w[k];
          }
#pragma unroll
          for (int k = 0; k < W4; ++k)
            run[k] += w[k] | (__vcmpeq4(w[k], 0u) & e4[k]);
          if ((j & 3) == 3) {
#pragma unroll
            for (int k = 0; k < W4; ++k) {
              pre[2 * k] += run[k] & 0x00ff00ffu;
              pre[2 * k + 1] += (run[k] >> 8) & 0x00ff00ffu;
              run[k] = 0;
            }
          }
        }
      }
#pragma unroll
      for (int k = 0; k < W4; ++k) {
        pre[2 * k] += run[k] & 0x00ff00ffu;
        pre[2 * k + 1] += (run[k] >> 8) & 0x00ff00ffu;
      }
      // the lanes' prefixes into the block's: one exclusive warp scan
      uint32_t tot[NP];
#pragma unroll
      for (int k = 0; k < NP; ++k) {
        uint32_t incl = pre[k];
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
          const uint32_t u = __shfl_up_sync(kFull, incl, o);
          if (lane >= o) incl += u;
        }
        ex[lane * NP + k] = incl - pre[k];
        tot[k] = __shfl_sync(kFull, incl, 31);
      }
      __syncwarp();
      // each band's sum: the prefix at its end less the prefix at its
      // first line (the owner lane's exclusive prefix added to both);
      // entry i = band * n_tab + table a lane, so that a warp's stores
      // are consecutive, (band, table) stepped by 32 entries without a
      // division
      for (int i = lane, bb = band_i0, t = tab_i0; i < n_bands * n_tab;
           i += 32) {
        const int k = 2 * (t >> 2) + (t & 1), sh = 16 * ((t >> 1) & 1);
        uint32_t v = 0;
        if (lo[bb + 1] > lo[bb]) {
          const int hb = nxt[bb];
          uint32_t top = 0;
#pragma unroll
          for (int kk = 0; kk < NP; ++kk)
            if (kk == k) top = tot[kk];
          if (hb < n_bands) top = eb[hb * NP + k] + ex[(lo[hb] / lpl) * NP + k];
          const uint32_t bottom = eb[bb * NP + k] + ex[(lo[bb] / lpl) * NP + k];
          v = ((top - bottom) >> sh) & 0xffffu;
        }
        out[(static_cast<int64_t>(bb) * kAllocs + a) * n_tab + t] =
            static_cast<int32_t>(v);
        bb += band_step;
        t += tab_step;
        if (t >= n_tab) {
          t -= n_tab;
          ++bb;
        }
      }
      __syncwarp();
    }
  }
}

template <typename T, int W4>
int launch(const T* mixed, const int32_t* n_lines, const int32_t* tab_lens,
           const int32_t* esc_len, const T* exp2_tab, int32_t* cost,
           int items, int half, int n_bands, int n_tab, int n_sym, int L,
           int max_mant, cudaStream_t stream) {
  const int hot = n_sym < kHot ? n_sym : kHot;
  const int n_e2 = 2 * L + max_mant + 2;
  const Smem lay = smem_layout(n_bands, hot, n_e2, W4, sizeof(T));
  int dev = 0, sms = 0, max_smem = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                         dev);
  const int fit = (max_smem - lay.shared) / lay.per_warp;
  const int warps = fit < kWarps ? fit : kWarps;
  if (warps < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int smem = lay.shared + warps * lay.per_warp;
  auto kernel = cost_table_kernel<T, W4>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  int per_sm = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                    32 * warps, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  per_sm = max(per_sm, 1);
  // warps an item: enough for one wave of the card, a power of two so
  // that each warp takes as many allocations
  int split = 1;
  while (split < max_mant &&
         static_cast<int64_t>(items) * split < int64_t{per_sm} * sms * warps)
    split *= 2;
  const int64_t units = static_cast<int64_t>(items) * split;
  const int64_t waves = (units + warps - 1) / warps;
  const int grid = static_cast<int>(
      waves < int64_t{per_sm} * sms ? waves : int64_t{per_sm} * sms);
  kernel<<<grid, 32 * warps, smem, stream>>>(
      mixed, n_lines, tab_lens, esc_len, exp2_tab, cost, items, split, half,
      n_bands, n_tab, n_sym, L, max_mant, hot, n_e2);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const T* mixed, const int32_t* n_lines, const int32_t* tab_lens,
             const int32_t* esc_len, const T* exp2_tab, int32_t* cost,
             int items, int half, int n_bands, int n_tab, int n_sym,
             int n_scale_bits, int max_mant, cudaStream_t stream) {
  const int L = (1 << n_scale_bits) - 1;
  if (n_tab < 1 || n_tab > kMaxTables || half < 1 || half > 32 * kLineSlots ||
      n_bands < 1 || n_sym < 1 || max_mant < 1 || max_mant >= kAllocs ||
      L + max_mant > 31)
    return static_cast<int>(cudaErrorInvalidValue);
  if (items == 0) return 0;
  switch ((n_tab + 3) / 4) {
    case 1:
      return launch<T, 1>(mixed, n_lines, tab_lens, esc_len, exp2_tab, cost,
                          items, half, n_bands, n_tab, n_sym, L, max_mant,
                          stream);
    case 2:
      return launch<T, 2>(mixed, n_lines, tab_lens, esc_len, exp2_tab, cost,
                          items, half, n_bands, n_tab, n_sym, L, max_mant,
                          stream);
    case 3:
      return launch<T, 3>(mixed, n_lines, tab_lens, esc_len, exp2_tab, cost,
                          items, half, n_bands, n_tab, n_sym, L, max_mant,
                          stream);
    default:
      return launch<T, 4>(mixed, n_lines, tab_lens, esc_len, exp2_tab, cost,
                          items, half, n_bands, n_tab, n_sym, L, max_mant,
                          stream);
  }
}

}  // namespace

extern "C" int pactpu_cost_table(const float* mixed, const int32_t* n_lines,
                                 const int32_t* tab_lens,
                                 const int32_t* esc_len,
                                 const float* exp2_tab, int32_t* cost,
                                 int items, int half, int n_bands, int n_tab,
                                 int n_sym, int n_scale_bits, int max_mant,
                                 cudaStream_t stream) {
  return dispatch<float>(mixed, n_lines, tab_lens, esc_len, exp2_tab, cost,
                         items, half, n_bands, n_tab, n_sym, n_scale_bits,
                         max_mant, stream);
}

extern "C" int pactpu_cost_table_f64(const double* mixed,
                                     const int32_t* n_lines,
                                     const int32_t* tab_lens,
                                     const int32_t* esc_len,
                                     const double* exp2_tab, int32_t* cost,
                                     int items, int half, int n_bands,
                                     int n_tab, int n_sym, int n_scale_bits,
                                     int max_mant, cudaStream_t stream) {
  return dispatch<double>(mixed, n_lines, tab_lens, esc_len, exp2_tab, cost,
                          items, half, n_bands, n_tab, n_sym, n_scale_bits,
                          max_mant, stream);
}
