// K3: a channel-block payload's MSB-first u32 words, in two entries.
//
// pack_payload (the engine's) replaces pactpu/ops/bitpack.py:
// pack_payload_bits whole: the item stream's values and widths, their bit
// offsets, the parts each item puts in its one or two words, and the
// Pallas accumulation it ends in (pactpu/ops/pallas_ops.py:pack_words,
// body _pack_words_kernel).  pack_words is the TPU kernel's own contract,
// the accumulation alone of parts the caller has shifted into place.  Both
// sum parts into a row's words through the same WordPairAcc.
//
// pack_payload, bit-exact with the int64 arithmetic of its plain version
// (pactpu_torch/ops/bitpack.py:pack_payload_bits_plain):
//
//   source row  = [overall, tid, ba - 1 where ba > 0 else 0 (nb), sf (nb),
//                  sign (L), codes (L), lrms (nb), sign groups (G)]
//   item m      = source perm[m], its value mod 2^32 but not cut to its
//                 width (a wider value spills into the bits before it, as
//                 the scatter-add does); its width the plan's constant, or
//                 (kind 2, 3) the code line's lens or the sign group's len
//                 where its band has ba > 0
//   sign group  = sum over i < len of sign[start + i] << (len - 1 - i)
//   offsets     = exclusive prefix sum of the widths; nbits = the row's sum,
//                 past n_words too (the engine packs such a row again,
//                 wider)
//   parts       = pactpu's part0 / part1 (shifts in [0, 31]), summed mod
//                 2^32 into words w0 and w0 + 1; words outside [0, n_words)
//                 dropped.
//
// The plan (bitpack.device_plan, built once a layout and device) is one
// int32 an item, perm << 8 | kind << 6 | const_width, and one a sign group,
// start << 16 | len << 10 | band; device_plan refuses a dynamic width read
// from anything but a code line or a sign group.
//
// What bounds it on the H100 (NVIDIA H100 80GB HBM3, 700 W; a real
// 512-block stereo chunk: 1,024 rows of 1,148 items into 256 words;
// PERF.md section 6, PR 14):
//
// 1. The launch.  A one-element fill_ alone takes 0.0048-0.0049 ms under
//    chip_smoke.device_ms, the floor of any launch.  The parent's pack step
//    was 71 device launches a chunk (70 of the int64 prologue's torch ops,
//    then K3 on its pre-shifted parts) and 0.38 ms of device time in the
//    engine; this is one launch, 0.0086-0.0091 ms there.
// 2. Bytes: the chunk's fields are 12.9 MB (1,024 rows of three int32
//    lines of 1,024 and three of 25 bands) and its words 1.05 MB, 13.9 MB
//    once over 3.35 TB/s = 4.2 us.  Each is read or written once: a CTA
//    issues all of its row's loads (16-byte quads of the lines, its plan
//    words, its band and group) before any store, and the words leave in
//    one coalesced store.  In phase 1 and tools/kernel_ab.py the fields sit
//    in L2 (the same 13.9 MB each call), so the byte bound there is a
//    floor, not the wall: the staging phase of a CTA takes 4.5 K clocks
//    at eight CTAs an SM against 1.9 K alone on its SM.
// 3. Issue and shared-memory traffic of eight CTAs an SM.  One CTA of 128
//    threads a row, 19 KB of shared memory (22 KB at 968 words) and 62
//    registers: eight CTAs an SM, a chunk's 1,024 rows in one wave on 132
//    SMs.  tools/k3_phase_clock.py (clocks a CTA, the mean; alone on its
//    SM / eight an SM): stage 1.9 K / 4.5 K, sign groups 0.3 K / 0.7 K,
//    widths and scan 0.4 K / 1.9 K, parts 1.3 K / 2.3 K, store 0.3 K /
//    0.4 K; the launch's span 2.2 us / 6.8 us.
//
// A row in one CTA:
//   - stage: sign, codes and lens into shared memory by 16-byte quads,
//     ba - 1, sf, lrms, the band flags, the plan and the group plan beside
//     them; while the sign quads are in registers each lane makes a nibble
//     of them and three shuffles OR eight lanes' nibbles into a bit word
//     (bit l % 32 of word l / 32 = line l's sign); zero the words.  The
//     barrier's OR tells whether every sign of the row is 0 or 1;
//   - sign groups, a thread a group: with 0/1 signs a funnel shift of two
//     bit words and a bit reversal (two shared loads), else the sum itself
//     over the group's lines (32 loads, the order rotated by the group so
//     that a band's groups, whose starts share a bank, do not collide);
//   - widths and scan: thread t takes items [9 t, 9 t + 9) (9 = ceil(1,148
//     / 128); odd, so the strided shared reads do not conflict; forms of
//     16 and 32 items a thread take longer plans, up to 4,096 items), its
//     plan words and widths in registers, and a warp shuffle scan plus a
//     scan of the four warp totals give its first offset and nbits;
//   - parts: one 64-bit shift an item puts its value at its place in the
//     pair of words (part0 the high word, part1 the low one), and
//     WordPairAcc sums a thread's consecutive parts in two registers,
//     adding to the shared words with predicated reductions only when the
//     run moves past a word: about one shared add a word a thread touches
//     and no branch;
//   - store: the words, coalesced, and nbits.
// The adds wrap mod 2^32 like the scatter-add they replace (an add, not an
// OR: parts of a value wider than its width overlap).
//
// Tried and not kept (device time alone in turns, tools/kernel_ab.py, ms):
// the first form (a warp reduction a sign group, global plan reads,
// strided items through a one-word accumulator) 0.0147; the plan and group
// plan in shared memory, a thread a group, 16-byte staging 0.0150; the
// same at 256 threads and 32 registers 0.0160; all loads first, the plan in
// registers, one 64-bit shift an item 0.0133-0.0137 (an empty asm holding
// the loads before the barrier: the same SASS, 0.0133); predicated
// reductions with the plan in registers, spilling 0.0138-0.0140; the plan
// in shared memory with an unrotated Horner sum a group (a band's groups
// read one bank up to ten ways) 0.0132-0.0134; rotated, 0.0123-0.0126; sign
// bit words built by ballots after the staging barrier and groups read
// inline in the parts loop 0.0145-0.0146; groups beside the widths pass
// in one phase 0.0125; this form 0.0118.
//
// pack_words keeps the TPU kernel's contract (part0 / part1 / w0 in,
// words out) and its layout: a CTA of 256 threads a row, item j of the
// row in thread j mod 256, so consecutive items of a thread land in
// different words and each part is one shared add, as before.

#include "kernels.h"

namespace {

constexpr int kPackWordsThreads = 256;
constexpr int kPayloadThreads = 128;
constexpr int kPayloadWarps = kPayloadThreads / 32;
// items a thread of pack_payload_kernel holds in registers, by form
constexpr int kPayloadPer[] = {9, 16, 32};

// acc[w] += sum in shared memory where `p` holds, as one predicated
// reduction (no branch); w must lie in the accumulator when p holds.
__device__ __forceinline__ void red_add_if(bool p, uint32_t* acc, long long w,
                                           uint32_t sum) {
  const unsigned addr = static_cast<unsigned>(
      __cvta_generic_to_shared(acc + (p ? w : 0)));
  asm volatile(
      "{\n\t.reg .pred q;\n\tsetp.ne.u32 q, %0, 0;\n\t"
      "@q red.shared.add.u32 [%1], %2;\n\t}" ::"r"(static_cast<unsigned>(p)),
      "r"(addr), "r"(sum)
      : "memory");
}

// A thread's running sums for two neighbouring words of a row's shared
// accumulator: an item's part0 goes to its word w0 and its part1 to w0 + 1,
// and the sums are added to the accumulator (words outside [0, n_words)
// dropped) only when an item starts past them.  Sums wrap mod 2^32, as the
// adds they stand for.  Any order of words is exact; a thread walking
// consecutive items adds about once a word it touches.  Branch-free: each
// item is two predicated reductions and a few selects.
struct WordPairAcc {
  long long word = -2;      // `cur` holds word, `next` word + 1
  uint32_t cur = 0u, next = 0u;

  __device__ __forceinline__ static void put(bool p, uint32_t* acc,
                                             int n_words, long long w,
                                             uint32_t sum) {
    red_add_if(p && sum != 0u && w >= 0 && w < n_words, acc, w, sum);
  }

  __device__ __forceinline__ void add(uint32_t* acc, int n_words,
                                      long long w0, uint32_t part0,
                                      uint32_t part1) {
    const bool moved = w0 != word, adjacent = w0 == word + 1;
    put(moved, acc, n_words, word, cur);
    put(moved && !adjacent, acc, n_words, word + 1, next);
    cur = (moved ? (adjacent ? next : 0u) : cur) + part0;
    next = (moved ? 0u : next) + part1;
    word = w0;
  }

  __device__ __forceinline__ void flush(uint32_t* acc, int n_words) {
    put(true, acc, n_words, word, cur);
    put(true, acc, n_words, word + 1, next);
    cur = next = 0u;
  }
};

__device__ __forceinline__ void zero_words(uint32_t* acc, int n_words) {
  for (int w = threadIdx.x; w < n_words; w += blockDim.x) acc[w] = 0u;
}

__device__ __forceinline__ void store_words(uint32_t* __restrict__ dst,
                                            const uint32_t* acc,
                                            int n_words) {
  for (int w = threadIdx.x; w < n_words; w += blockDim.x) dst[w] = acc[w];
}

__global__ void __launch_bounds__(kPackWordsThreads)
pack_words_kernel(const uint32_t* __restrict__ part0,
                  const uint32_t* __restrict__ part1,
                  const int32_t* __restrict__ w0, uint32_t* __restrict__ out,
                  int items, int n_words) {
  extern __shared__ uint32_t acc[];
  const int64_t row = blockIdx.x;
  zero_words(acc, n_words);
  __syncthreads();
  const int64_t base = row * items;
  WordPairAcc a;
  for (int j = threadIdx.x; j < items; j += blockDim.x)
    a.add(acc, n_words, w0[base + j], part0[base + j], part1[base + j]);
  a.flush(acc, n_words);
  __syncthreads();
  store_words(out + row * n_words, acc, n_words);
}

// pactpu's two parts of item (value v, width w) at bit offset `sh` of its
// word: one 64-bit shift puts v's last bit at bit 64 - sh - w of the word
// pair, part0 the high word and part1 the low one, the bits of a value
// wider than w spilling into the bits before it.  Past the pair (a spill
// of more than 32 bits) pactpu's part0 is 0 and part1 is v; an item of no
// bits (w <= 0) has neither.
__device__ __forceinline__ void item_parts(uint32_t v, int w, int sh,
                                           uint32_t& part0,
                                           uint32_t& part1) {
  const int s = 64 - sh - w;
  const unsigned long long x = static_cast<unsigned long long>(v)
                               << (s < 0 ? 0 : s > 63 ? 63 : s);
  part0 = w <= 0 || s < 0 ? 0u : static_cast<uint32_t>(x >> 32);
  part1 = w <= 0 ? 0u : s < 0 ? v : static_cast<uint32_t>(x);
}

// The value of sign group p (start << 16 | len << 10 | band): the sum of
// its lines' signs each at its place, sign[start + i] << (len - 1 - i),
// mod 2^32.
//
// group_bits, where every sign of the row is 0 or 1: the group's len bits
// of the row's sign bit words (bit l % 32 of word l / 32 is line l's
// sign), reversed into MSB-first order.
__device__ __forceinline__ uint32_t group_bits(int p, const uint32_t* bitw) {
  const int len = (p >> 10) & 63, start = p >> 16;
  const uint32_t x = __funnelshift_r(bitw[start >> 5], bitw[(start >> 5) + 1],
                                     start & 31);
  const uint32_t mask = len >= 32 ? 0xffffffffu : (1u << len) - 1u;
  return len == 0 ? 0u : __brev(x & mask) >> (32 - len);
}

// group_sum, for any signs: the sum itself, the lines taken in an order
// rotated by g (the sum wraps mod 2^32 in any order): a band's groups
// start 32 lines apart, on one bank, and in line order the ten groups of
// a 304-line band would read it ten ways at once.  Every load is issued,
// in bounds, whatever len is.
__device__ __forceinline__ uint32_t group_sum(int g, int p,
                                              const uint32_t* sign_s) {
  const int len = (p >> 10) & 63;
  const uint32_t* s = sign_s + (p >> 16);
  uint32_t v = 0u;
#pragma unroll
  for (int k = 0; k < 32; ++k) {
    const int i = (k + g) & 31;
    const uint32_t x = s[i < len ? i : 0];
    v += i < len ? x << (len - 1 - i) : 0u;
  }
  return v;
}

// Sign group g of plan word p: its value (group_bits where `binary`, else
// group_sum) into val[o_group + g], and its width (len where its band has
// bits) into dynw[o_gw + g].
__device__ __forceinline__ void sign_group(int g, int p, bool binary,
                                           const uint32_t* bitw,
                                           uint32_t* val, int* dynw,
                                           const int* band_on, int o_sign,
                                           int o_group, int o_gw) {
  val[o_group + g] = binary ? group_bits(p, bitw)
                            : group_sum(g, p, val + o_sign);
  dynw[o_gw + g] = band_on[p & 1023] ? (p >> 10) & 63 : 0;
}

// Shared memory of pack_payload_kernel, in 32-bit words: the source row
// (its sign and code lines on a 16-byte boundary), the dynamic widths
// (code lines, then past nb unused slots the sign groups), band flags,
// the sign bit words and a zero word, warp totals, the plan and the
// words.
__host__ __device__ inline size_t payload_smem_words(int nb, int lines,
                                                      int items, int groups,
                                                      int n_words) {
  const size_t n_src = 2 + 3 * static_cast<size_t>(nb) + 2 * lines + groups;
  return 3 + n_src + 3 + lines + 2 * static_cast<size_t>(nb) + groups +
         (lines + 31) / 32 + 1 + kPayloadWarps + items + n_words;
}

template <int PER>
__global__ void __launch_bounds__(kPayloadThreads, PER <= 9 ? 8 : 4)
pack_payload_kernel(const int32_t* __restrict__ overall,
                    const int32_t* __restrict__ tid,
                    const int32_t* __restrict__ ba,
                    const int32_t* __restrict__ sf,
                    const int32_t* __restrict__ sign,
                    const int32_t* __restrict__ codes,
                    const int32_t* __restrict__ lens,
                    const int32_t* __restrict__ lrms,
                    const int32_t* __restrict__ item_plan,
                    const int32_t* __restrict__ group_plan,
                    uint32_t* __restrict__ words, int32_t* __restrict__ nbits,
                    int nb, int lines, int items, int groups, int n_words) {
  extern __shared__ uint32_t smem[];
  const int o_sign = 2 + 2 * nb, o_code = o_sign + lines;
  const int o_lrms = o_code + lines, o_group = o_lrms + nb;
  const int n_src = o_group + groups;
  uint32_t* val = smem + ((4 - (o_sign & 3)) & 3);          // [n_src]
  int* dynw = reinterpret_cast<int*>(                       // by src - o_code
      smem + ((((val - smem) + n_src) + 3) & ~3));
  int* band_on = dynw + lines + nb + groups;                // [nb]
  const int n_bitw = (lines + 31) / 32;
  uint32_t* bitw = reinterpret_cast<uint32_t*>(band_on + nb);  // [n_bitw+1]
  int* warp_tot = reinterpret_cast<int*>(bitw + n_bitw + 1);   // [warps]
  int* plan = warp_tot + kPayloadWarps;                     // [items]
  uint32_t* acc = reinterpret_cast<uint32_t*>(plan + items);
  const int64_t row = blockIdx.x;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;

  // stage: every load of the thread first (PER words of the plan, two
  // 16-byte quads of each line field, its band and group), then the
  // shared stores and the sign bit words (each warp's 32 x 4 lines of a
  // quad, a nibble a lane, OR-ed across each 8 lanes); zero the words.
  // The barrier also tells every thread whether the bit words hold the
  // row's signs: every sign 0 or 1, all of them in the quads.
  int pl[PER];
#pragma unroll
  for (int j = 0; j < PER; ++j) {
    const int m = t + j * kPayloadThreads;
    pl[j] = m < items ? item_plan[m] : 0;
  }
  const int32_t* s_row = sign + row * lines;
  const int32_t* c_row = codes + row * lines;
  const int32_t* l_row = lens + row * lines;
  const bool quads = (lines & 3) == 0 &&
      ((reinterpret_cast<uintptr_t>(sign) |
        reinterpret_cast<uintptr_t>(codes) |
        reinterpret_cast<uintptr_t>(lens)) & 15) == 0;
  const int nq = quads ? lines / 4 : 0;
  const int4* s4 = reinterpret_cast<const int4*>(s_row);
  const int4* c4 = reinterpret_cast<const int4*>(c_row);
  const int4* l4 = reinterpret_cast<const int4*>(l_row);
  int4 qs[2], qc[2], ql[2];
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const int q = t + k * kPayloadThreads;
    if (q < nq) {
      qs[k] = s4[q];
      qc[k] = c4[q];
      ql[k] = l4[q];
    }
  }
  const int bits = t < nb ? ba[row * nb + t] : 0;
  const int scale = t < nb ? sf[row * nb + t] : 0;
  const int flag = t < nb ? lrms[row * nb + t] : 0;
  const int head = t == 0 ? overall[row] : t == 1 ? tid[row] : 0;
  const int gp = t < groups ? group_plan[t] : 0;

  int4* vs = reinterpret_cast<int4*>(val + o_sign);
  int4* vc = reinterpret_cast<int4*>(val + o_code);
  int4* vl = reinterpret_cast<int4*>(dynw);
  // a sign outside {0, 1}, or lines past the quads held here
  unsigned wide = quads && lines <= 8 * kPayloadThreads ? 0u : 1u;
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const int q = t + k * kPayloadThreads;
    uint32_t nib = 0u;
    if (q < nq) {
      vs[q] = qs[k];
      vc[q] = qc[k];
      vl[q] = ql[k];
      const int4 x = qs[k];
      wide |= static_cast<unsigned>(x.x | x.y | x.z | x.w) & ~1u;
      nib = (x.x != 0) | (x.y != 0) << 1 | (x.z != 0) << 2 | (x.w != 0) << 3;
    }
    nib <<= 4 * (lane & 7);
    nib |= __shfl_xor_sync(0xffffffffu, nib, 1);
    nib |= __shfl_xor_sync(0xffffffffu, nib, 2);
    nib |= __shfl_xor_sync(0xffffffffu, nib, 4);
    const int j = (t + k * kPayloadThreads) >> 3;   // lines 32 j ..
    if ((lane & 7) == 0 && j < n_bitw) bitw[j] = nib;
  }
  for (int q = t + 2 * kPayloadThreads; q < nq; q += kPayloadThreads) {
    vs[q] = s4[q];
    vc[q] = c4[q];
    vl[q] = l4[q];
  }
  if (!quads) {
    for (int l = t; l < lines; l += kPayloadThreads) {
      val[o_sign + l] = static_cast<uint32_t>(s_row[l]);
      val[o_code + l] = static_cast<uint32_t>(c_row[l]);
      dynw[l] = l_row[l];
    }
  }
  for (int b = t; b < nb; b += kPayloadThreads) {
    const int ab = b == t ? bits : ba[row * nb + b];
    band_on[b] = ab > 0;
    val[2 + b] = static_cast<uint32_t>(ab > 0 ? ab - 1 : 0);
    val[2 + nb + b] = static_cast<uint32_t>(b == t ? scale
                                                   : sf[row * nb + b]);
    val[o_lrms + b] = static_cast<uint32_t>(b == t ? flag
                                                   : lrms[row * nb + b]);
  }
  if (t < 2) val[t] = static_cast<uint32_t>(head);
#pragma unroll
  for (int j = 0; j < PER; ++j) {
    const int m = t + j * kPayloadThreads;
    if (m < items) plan[m] = pl[j];
  }
  if (t == 0) bitw[n_bitw] = 0u;
  zero_words(acc, n_words);
  const bool binary = !__syncthreads_or(wide != 0u);

  // sign groups, a thread a group (sign_group)
  if (t < groups) sign_group(t, gp, binary, bitw, val, dynw, band_on, o_sign,
                             o_group, lines + nb);
  for (int g = t + kPayloadThreads; g < groups; g += kPayloadThreads)
    sign_group(g, group_plan[g], binary, bitw, val, dynw, band_on, o_sign,
               o_group, lines + nb);
  __syncthreads();

  // the thread's run of PER items (a plan word of 0 has no bits), their
  // widths (kind 0: the plan's; else the code line's or the group's) and
  // their sum, then the block's scan
  const int m0 = t * PER;
  int desc[PER], width[PER];
  int own = 0;
#pragma unroll
  for (int j = 0; j < PER; ++j) {
    const int d = desc[j] = m0 + j < items ? plan[m0 + j] : 0;
    width[j] = ((d >> 6) & 3) == 0 ? (d & 63) : dynw[(d >> 8) - o_code];
    own += width[j];
  }
  int incl = own;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int up = __shfl_up_sync(0xffffffffu, incl, d);
    if (lane >= d) incl += up;
  }
  if (lane == 31) warp_tot[warp] = incl;
  __syncthreads();
  int off = incl - own, total = 0;
#pragma unroll
  for (int k = 0; k < kPayloadWarps; ++k) {
    const int w = warp_tot[k];
    off += k < warp ? w : 0;
    total += w;
  }

  // the run's parts, summed into the words
  WordPairAcc a;
#pragma unroll
  for (int j = 0; j < PER; ++j) {
    uint32_t part0, part1;
    item_parts(val[desc[j] >> 8], width[j], off & 31, part0, part1);
    a.add(acc, n_words, off >> 5, part0, part1);
    off += width[j];
  }
  a.flush(acc, n_words);
  __syncthreads();
  store_words(words + row * n_words, acc, n_words);
  if (t == 0) nbits[row] = total;
}

template <int PER>
void launch_payload(const int32_t* overall, const int32_t* tid,
                    const int32_t* ba, const int32_t* sf,
                    const int32_t* sign, const int32_t* codes,
                    const int32_t* lens, const int32_t* lrms,
                    const int32_t* item_plan, const int32_t* group_plan,
                    uint32_t* words, int32_t* nbits, int rows, int nb,
                    int lines, int items, int groups, int n_words,
                    cudaStream_t stream) {
  const size_t smem = sizeof(uint32_t) *
                      payload_smem_words(nb, lines, items, groups, n_words);
  pack_payload_kernel<PER><<<rows, kPayloadThreads, smem, stream>>>(
      overall, tid, ba, sf, sign, codes, lens, lrms, item_plan, group_plan,
      words, nbits, nb, lines, items, groups, n_words);
}

}  // namespace

extern "C" int pactpu_pack_words(const uint32_t* part0, const uint32_t* part1,
                                 const int32_t* w0, uint32_t* out, int rows,
                                 int items, int n_words,
                                 cudaStream_t stream) {
  const size_t smem = sizeof(uint32_t) * static_cast<size_t>(n_words);
  pack_words_kernel<<<rows, kPackWordsThreads, smem, stream>>>(
      part0, part1, w0, out, items, n_words);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int pactpu_pack_payload(
    const int32_t* overall, const int32_t* tid, const int32_t* ba,
    const int32_t* sf, const int32_t* sign, const int32_t* codes,
    const int32_t* lens, const int32_t* lrms, const int32_t* item_plan,
    const int32_t* group_plan, uint32_t* words, int32_t* nbits, int rows,
    int nb, int lines, int items, int groups, int n_words,
    cudaStream_t stream) {
  const int per = (items + kPayloadThreads - 1) / kPayloadThreads;
  if (per <= kPayloadPer[0]) {
    launch_payload<kPayloadPer[0]>(overall, tid, ba, sf, sign, codes, lens,
                                   lrms, item_plan, group_plan, words, nbits,
                                   rows, nb, lines, items, groups, n_words,
                                   stream);
  } else if (per <= kPayloadPer[1]) {
    launch_payload<kPayloadPer[1]>(overall, tid, ba, sf, sign, codes, lens,
                                   lrms, item_plan, group_plan, words, nbits,
                                   rows, nb, lines, items, groups, n_words,
                                   stream);
  } else if (per <= kPayloadPer[2]) {
    launch_payload<kPayloadPer[2]>(overall, tid, ba, sf, sign, codes, lens,
                                   lrms, item_plan, group_plan, words, nbits,
                                   rows, nb, lines, items, groups, n_words,
                                   stream);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
