// K5 huffman_walk: the serial Huffman bit-walk of a channel-block row.
//
// Replaces pactpu/ops/huffman_walk.py:_walk_kernel (via _walk_call), the
// parser of the device-parse decode route.  Per row: read overall and the
// table id; per band read ba (stored minus one) and sf, record where the
// band's sign bits start and skip them if the band is active; per line of
// an active band decode one code through the two-level LUT (an escape code
// is followed by the raw ba-bit mantissa).  Signs and LRMS flags are sliced
// afterwards in bulk by kernel K1 from the offsets recorded here.
//
// Bound on the H100: neither bytes nor operations but latency.  A row is
// one chain of up to 1,024 lines + 25 bands of dependent lookups (payload
// words -> level-1 entry -> side table and level-2 entry for a deep prefix
// -> next bit offset); the bytes (a chunk's payload rows in, 4 MB of codes
// out) would take a few microseconds.  The TPU kernel kept 128 rows of one
// table in lockstep lanes and swept its VMEM-resident LUT with lane
// gathers, because a per-lane dynamic load does not exist there.  Here a
// dynamic load is a plain load, so: one thread per row, no lockstep, a
// thread walks only the bands its own row has bits in; every peek is two
// bounds-checked word loads joined by a funnel shift at the absolute bit
// offset (no shift by 32, words past the row read as zero, so a corrupt
// row's cursor can run anywhere); the LUT of the row's table is read from
// global memory through the read-only path (all ten tables are 0.6 MB and
// stay in L1/L2), so rows need no grouping by table and the outputs come
// back in the caller's order.  Blocks of 32 rows spread a 1,024-row chunk
// over 32 SMs.  What holds this first version back: a thread's word loads
// and its code[row, line] stores are W*4 and 4 KB apart from its
// neighbours' (uncoalesced), and 1,024 threads fill a small part of the
// card.
//
// Exactness: bit-identical to kernels.huffman_walk_plain on every input.

#include "kernels.h"

namespace {

constexpr int kRootBits = 11;   // kernels.WALK_ROOT_BITS
constexpr int kThreads = 32;

struct Bands {
  int32_t n[kWalkMaxBands];
};

// the 32 bits at bit offset `off` of the row, MSB-aligned
__device__ __forceinline__ uint32_t peek(const uint32_t* __restrict__ row,
                                         int n_words, int off) {
  const int w0 = off >> 5;
  const uint32_t hi = (w0 >= 0 && w0 < n_words) ? row[w0] : 0u;
  const uint32_t lo = (w0 + 1 >= 0 && w0 + 1 < n_words) ? row[w0 + 1] : 0u;
  return __funnelshift_l(lo, hi, off & 31);
}

// top n bits of a peek, n in [0, 32]
__device__ __forceinline__ uint32_t top_bits(uint32_t pk, int n) {
  return n > 0 ? pk >> (32 - n) : 0u;
}

__global__ void huffman_walk_kernel(
    const uint32_t* __restrict__ words, const uint32_t* __restrict__ l1,
    const uint32_t* __restrict__ l1b, const uint32_t* __restrict__ l2,
    Bands bands, int32_t* __restrict__ code, int32_t* __restrict__ basf,
    int32_t* __restrict__ soff, int32_t* __restrict__ misc, int rows,
    int n_words, int n_bands, int total_lines, int n_tab, int l2_width,
    int n_scale_bits, int n_mant_size_bits, int n_table_id_bits) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= rows) return;
  const uint32_t* row = words + static_cast<int64_t>(r) * n_words;
  int32_t* code_r = code + static_cast<int64_t>(r) * total_lines;

  int off = 0;
  const int overall = top_bits(peek(row, n_words, off), n_scale_bits);
  off += n_scale_bits;
  const int tid = top_bits(peek(row, n_words, off), n_table_id_bits);
  off += n_table_id_bits;
  const int t = min(max(tid, 1), n_tab) - 1;
  int bad = tid != t + 1;
  const uint32_t* l1_t = l1 + static_cast<int64_t>(t) * (1 << kRootBits);
  const uint32_t* l1b_t = l1b + static_cast<int64_t>(t) * 128;
  const uint32_t* l2_t = l2 + static_cast<int64_t>(t) * l2_width;

  int line = 0;
  for (int b = 0; b < n_bands; ++b) {
    const int nl = bands.n[b];
    const int ba_raw = top_bits(peek(row, n_words, off), n_mant_size_bits);
    off += n_mant_size_bits;
    const int sf = top_bits(peek(row, n_words, off), n_scale_bits);
    off += n_scale_bits;
    basf[r * n_bands + b] = ba_raw | (sf << 8);
    soff[r * n_bands + b] = off;
    const int ba = ba_raw > 0 ? ba_raw + 1 : 0;   // Q6: stored minus one
    if (ba > 0) {
      off += nl;                                  // the band's sign bits
      for (int i = 0; i < nl; ++i) {
        const uint32_t pk = peek(row, n_words, off);
        uint32_t e = __ldg(l1_t + (pk >> (32 - kRootBits)));
        if (e & 0x80000000u) {                    // deep prefix
          const uint32_t b2 = __ldg(l1b_t + (e & 0x7Fu));
          const int k2 = b2 & 15u;
          const uint32_t tail = top_bits(pk << kRootBits, k2);
          e = __ldg(l2_t + (b2 >> 4) + tail);
        }
        const int ln = e & 31u;
        uint32_t val = (e >> 6) & 0x7FFFu;
        int adv = ln;
        if (e & 0x20u) {                          // escape: raw mantissa
          val = top_bits(peek(row, n_words, off + ln), ba);
          adv += ba;
        }
        bad |= ln == 0;                           // no such codeword
        code_r[line + i] = static_cast<int32_t>(val);
        off += adv;
      }
    }
    line += nl;
  }
  int32_t* m = misc + static_cast<int64_t>(r) * 5;
  m[0] = overall;
  m[1] = tid;
  m[2] = bad;
  m[3] = off;
  m[4] = off + n_bands;
}

}  // namespace

extern "C" int pactpu_huffman_walk(
    const uint32_t* words, const uint32_t* l1, const uint32_t* l1b,
    const uint32_t* l2, const int32_t* n_lines_host, int32_t* code,
    int32_t* basf, int32_t* soff, int32_t* misc, int rows, int n_words,
    int n_bands, int total_lines, int n_tab, int l2_width, int n_scale_bits,
    int n_mant_size_bits, int n_table_id_bits, cudaStream_t stream) {
  if (n_bands > kWalkMaxBands) return static_cast<int>(cudaErrorInvalidValue);
  Bands bands;
  for (int b = 0; b < kWalkMaxBands; ++b)
    bands.n[b] = b < n_bands ? n_lines_host[b] : 0;
  const int blocks = (rows + kThreads - 1) / kThreads;
  huffman_walk_kernel<<<blocks, kThreads, 0, stream>>>(
      words, l1, l1b, l2, bands, code, basf, soff, misc, rows, n_words,
      n_bands, total_lines, n_tab, l2_width, n_scale_bits, n_mant_size_bits,
      n_table_id_bits);
  return static_cast<int>(cudaGetLastError());
}
