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
// one chain of up to 1,024 lines + 25 bands of dependent steps (bits at the
// cursor -> level-1 entry -> side table and level-2 entry for a deep prefix
// -> next cursor); the bytes (a chunk's payload rows in, 4 MB of codes out)
// would take a few microseconds.  The TPU kernel kept 128 rows of one table
// in lockstep lanes and swept its VMEM-resident LUT with lane gathers,
// because a per-lane dynamic load does not exist there.  Here a dynamic
// load is a plain load and the card holds 8,448 warps at once, eight times
// the rows of a chunk, so:
//
// - One row a warp, no lockstep between rows.  Lane 0 walks the row; the
//   other lanes walk a row of zeros beside it (no band of theirs is active,
//   so they wait at each band's end) and join in for the copies and the
//   stores.  With 32 rows in the lanes of a warp a line costs its slowest
//   lane: 3% of a stream's lines have a code past the level-1 table, so
//   most lines of such a warp wait for a level-2 load.  Rows a warp
//   against the kernel's time on a chunk, and all 32 lanes in step on the
//   one row (6% slower): PERF.md.
// - The row's words in shared memory (cp.async), three zero words behind
//   them: a peek is a clamped word index, no bounds test, and a corrupt
//   row's cursor can run anywhere.  The three words at the cursor stay in
//   registers; a code is at most 31 bits, so the next code's bits are two
//   funnel shifts and a select of those registers, and the loads at the
//   new cursor are for the step after: the chain from one code to the next
//   holds one shared load, the level-1 entry's.  Rows too wide for shared
//   memory (tens of thousands of words) are read from global memory with
//   bounds-checked loads.
// - The level-1 tables and the side tables of all tables in shared memory
//   (85 KB for the ten shipped ones), so rows need no grouping by table
//   and keep the caller's order.  The level-2 pool (up to 52 KB a table)
//   stays in global memory behind the read-only path.
// - One branch a line.  An escape or a deep prefix is rare; both hide
//   behind one test of the level-1 entry, and the level-2 lookup is a
//   call, which nvcc cannot turn into predicated instructions that every
//   line would pay for.
// - Coalesced stores, no fill.  Lane 0 stages the codes in shared memory
//   (zero where the row's band has no bits) and, every 128 lines, the warp
//   writes the stage out, 16 bytes a lane, every line of the output once.
// - The band layout (each band's line count) is a device array that every
//   block stages in shared memory beside the tables, so a layout may have
//   any number of bands.
// - kMaxWarps = 8 rows a block: every block copies the tables, two blocks
//   fit an SM, and a chunk's 1,024 rows are 128 blocks, one wave on 132
//   SMs; with 4 a block a chunk needs two waves.
//
// Exactness: bit-identical to kernels.huffman_walk_plain on every input.

#include "kernels.h"

namespace {

constexpr int kRootBits = 11;   // kernels.WALK_ROOT_BITS
constexpr int kRootSize = 1 << kRootBits;
constexpr int kSideSize = 128;
constexpr int kMaxWarps = 8;                // rows a block, one a warp
constexpr int kStage = 128;                 // lines staged between flushes
constexpr size_t kMaxShared = 227 * 1024;   // what a block may ask for

// cp.async of kBytes (4 or 16, both pointers aligned to that)
template <int kBytes>
__device__ __forceinline__ void copy_async(uint32_t* to_shared,
                                           const uint32_t* from_global) {
  const unsigned to =
      static_cast<unsigned>(__cvta_generic_to_shared(to_shared));
  if (kBytes == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;"
                 :: "r"(to), "l"(from_global) : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;"
                 :: "r"(to), "l"(from_global) : "memory");
  }
}

// n words of a table by all threads of the block, 16 bytes a copy (a
// table's rows are multiples of 512 bytes in a tensor of its own)
__device__ __forceinline__ void copy_table(uint32_t* to_shared,
                                           const uint32_t* from_global,
                                           int n) {
  for (int i = 4 * threadIdx.x; i < n; i += 4 * blockDim.x)
    copy_async<16>(to_shared + i, from_global + i);
}

// words of shared memory the band layout takes: n_bands, rounded up to 16
// bytes so that the tables behind it stay aligned for their 16-byte copies
__host__ __device__ __forceinline__ int band_words(int n_bands) {
  return (n_bands + 3) & ~3;
}

// top n bits of 32, n in [0, 32]
__device__ __forceinline__ uint32_t top_bits(uint32_t pk, int n) {
  return n > 0 ? pk >> (32 - n) : 0u;
}

// A row's payload words.  kShared: in shared memory, with three zero words
// behind the row's n_words, so that a clamped index reads zeros past the
// row; else in global memory, every load bounds-checked.
template <bool kShared>
struct Row {
  const uint32_t* words;
  int n_words;

  // the three words from the one that holds bit `off` (>= 0) on
  __device__ __forceinline__ void load(int off, uint32_t& w0, uint32_t& w1,
                                       uint32_t& w2) const {
    if (kShared) {
      const uint32_t* p = words + min(off >> 5, n_words);
      w0 = p[0];
      w1 = p[1];
      w2 = p[2];
    } else {
      const int w = off >> 5;
      w0 = w < n_words ? __ldg(words + w) : 0u;
      w1 = w + 1 < n_words ? __ldg(words + w + 1) : 0u;
      w2 = w + 2 < n_words ? __ldg(words + w + 2) : 0u;
    }
  }
  // the 32 bits at bit offset off, MSB-aligned; zero past the row
  __device__ __forceinline__ uint32_t peek(int off) const {
    uint32_t w0, w1, w2;
    load(off, w0, w1, w2);
    return __funnelshift_l(w1, w0, off);
  }
};

// Write the first n <= kStage staged lines to to[0..n) and zero the stage
// again.  A full stage at an aligned address goes out 16 bytes a lane.
__device__ __forceinline__ void flush(uint32_t* stage, int32_t* to, int n,
                                      int lane) {
  static_assert(kStage == 4 * 32, "a full stage is one uint4 a lane");
  __syncwarp();
  if (n == kStage && (reinterpret_cast<uintptr_t>(to) & 15u) == 0) {
    uint4* from = reinterpret_cast<uint4*>(stage) + lane;
    reinterpret_cast<uint4*>(to)[lane] = *from;
    *from = make_uint4(0u, 0u, 0u, 0u);
  } else {
    for (int j = lane; j < n; j += 32) {
      to[j] = static_cast<int32_t>(stage[j]);
      stage[j] = 0u;
    }
  }
  __syncwarp();
}

// The level-2 entry of a deep prefix (a code past the root table's 11
// bits).  Not inlined: as a call it is a branch that a line with no such
// code skips; inlined, nvcc predicates it and every line pays its chain.
template <bool kSharedRoot>
__device__ __noinline__ uint32_t deep_entry(const uint32_t* side,
                                            const uint32_t* l2_t, uint32_t e,
                                            uint32_t pk) {
  const uint32_t rank = e & 0x7Fu;
  const uint32_t b2 = kSharedRoot ? side[rank] : __ldg(side + rank);
  const uint32_t tail = top_bits(pk << kRootBits, b2 & 15u);
  return __ldg(l2_t + (b2 >> 4) + tail);
}

template <bool kSharedWords, bool kSharedRoot>
__global__ void huffman_walk_kernel(
    const uint32_t* __restrict__ words, const uint32_t* __restrict__ l1,
    const uint32_t* __restrict__ l1b, const uint32_t* __restrict__ l2,
    const int32_t* __restrict__ n_lines, int32_t* __restrict__ code,
    int32_t* __restrict__ basf,
    int32_t* __restrict__ soff, int32_t* __restrict__ misc, int rows,
    int n_words, int n_bands, int total_lines, int n_tab, int l2_width,
    int n_scale_bits, int n_mant_size_bits, int n_table_id_bits) {
  extern __shared__ __align__(16) uint32_t smem[];
  const int warps = blockDim.x / 32;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x & 31;
  const int r = blockIdx.x * warps + warp;      // the warp's row
  // shared memory: the band layout, the tables, a stage a warp, the row's
  // words a warp
  int32_t* s_bands = reinterpret_cast<int32_t*>(smem);
  uint32_t* s_l1 = smem + band_words(n_bands);
  uint32_t* s_l1b = s_l1 + (kSharedRoot ? n_tab * kRootSize : 0);
  uint32_t* stage = s_l1b + (kSharedRoot ? n_tab * kSideSize : 0) +
                    warp * kStage;
  uint32_t* s_words = stage + (warps - warp) * kStage + warp * (n_words + 3);

  for (int b = threadIdx.x; b < n_bands; b += blockDim.x)
    s_bands[b] = n_lines[b];
  if (kSharedRoot) {
    copy_table(s_l1, l1, n_tab * kRootSize);
    copy_table(s_l1b, l1b, n_tab * kSideSize);
  }
  if (kSharedWords && r < rows) {
    const uint32_t* from = words + static_cast<int64_t>(r) * n_words;
    for (int w = lane; w < n_words; w += 32)
      copy_async<4>(s_words + w, from + w);
    if (lane < 3) s_words[n_words + lane] = 0u;
  }
  for (int i = lane; i < kStage; i += 32) stage[i] = 0u;
  asm volatile("cp.async.wait_all;" ::: "memory");
  __syncthreads();
  if (r >= rows) return;

  // lane 0 walks the row, the others the zero words behind it
  Row<kSharedWords> row;
  row.n_words = lane == 0 ? n_words : 0;
  row.words = kSharedWords ? s_words + (lane == 0 ? 0 : n_words)
                           : words + static_cast<int64_t>(r) * n_words;
  int off = 0;
  auto read = [&](int n) {
    const uint32_t v = top_bits(row.peek(off), n);
    off += n;
    return static_cast<int>(v);
  };
  const int overall = read(n_scale_bits);
  const int tid = read(n_table_id_bits);
  const int t = min(max(tid, 1), n_tab) - 1;
  const uint32_t* root = kSharedRoot
                             ? s_l1 + t * kRootSize
                             : l1 + static_cast<int64_t>(t) * kRootSize;
  const uint32_t* side = kSharedRoot
                             ? s_l1b + t * kSideSize
                             : l1b + static_cast<int64_t>(t) * kSideSize;
  const uint32_t* l2_t = l2 + static_cast<int64_t>(t) * l2_width;
  int32_t* code_r = code + static_cast<int64_t>(r) * total_lines;

  int shortest = 31;            // of the codes met: 0 = no such codeword
  int line = 0, staged = 0;     // lines written out, lines in the stage
  for (int b = 0; b < n_bands; ++b) {
    const int nl = s_bands[b];
    const int ba_raw = read(n_mant_size_bits);
    const int sf = read(n_scale_bits);
    if (lane == 0) {
      basf[r * n_bands + b] = ba_raw | (sf << 8);
      soff[r * n_bands + b] = off;
    }
    const int ba = ba_raw > 0 ? ba_raw + 1 : 0;   // Q6: stored minus one
    uint32_t w0, w1, w2, pk;    // the words at the cursor, the bits there
    if (ba > 0) {
      off += nl;                                  // the band's sign bits
      row.load(off, w0, w1, w2);
      pk = __funnelshift_l(w1, w0, off);
    }
    for (int i0 = 0, n; i0 < nl; i0 += n) {       // in pieces the stage holds
      n = min(nl - i0, kStage - staged);
      if (ba > 0) {
        uint32_t* mine = stage + staged;
        for (int i = 0; i < n; ++i) {
          const uint32_t slot = pk >> (32 - kRootBits);
          uint32_t e = kSharedRoot ? root[slot] : __ldg(root + slot);
          uint32_t val;
          if (e & 0x80000020u) {                  // the rare codes, one branch
            if (e & 0x80000000u)                  // deep prefix
              e = deep_entry<kSharedRoot>(side, l2_t, e, pk);
            val = (e >> 6) & 0x7FFFu;
            off += e & 31u;
            if (e & 0x20u) {                      // escape: raw mantissa
              val = top_bits(row.peek(off), ba);
              off += ba;
            }
            row.load(off, w0, w1, w2);
            pk = __funnelshift_l(w1, w0, off);
          } else {
            // the next code's bits from the words in registers (a code is
            // at most 31 bits: the cursor stays within w0..w2); the words
            // at the new cursor are loaded for the step after
            val = e >> 6;
            const int s = (off & 31) + (e & 31u);
            off += e & 31u;
            const uint32_t f0 = __funnelshift_l(w1, w0, s);
            const uint32_t f1 = __funnelshift_l(w2, w1, s);
            pk = s >= 32 ? f1 : f0;
            row.load(off, w0, w1, w2);
          }
          shortest = min(shortest, static_cast<int>(e & 31u));
          mine[i] = val;                          // lane 0: see above
        }
      }
      staged += n;
      if (staged == kStage) {
        flush(stage, code_r + line, staged, lane);
        line += staged;
        staged = 0;
      }
    }
  }
  flush(stage, code_r + line, staged, lane);
  if (lane == 0) {
    int32_t* m = misc + static_cast<int64_t>(r) * 5;
    m[0] = overall;
    m[1] = tid;
    m[2] = tid != t + 1 || shortest == 0;
    m[3] = off;
    m[4] = off + n_bands;
  }
}

}  // namespace

extern "C" int pactpu_huffman_walk(
    const uint32_t* words, const uint32_t* l1, const uint32_t* l1b,
    const uint32_t* l2, const int32_t* n_lines, int32_t* code,
    int32_t* basf, int32_t* soff, int32_t* misc, int rows, int n_words,
    int n_bands, int total_lines, int n_tab, int l2_width, int n_scale_bits,
    int n_mant_size_bits, int n_table_id_bits, cudaStream_t stream) {
  // what goes into shared memory: the band layout, the tables if they
  // leave room for a warp, then the words of as many warps' rows as fit
  // beside them
  const size_t stage = sizeof(uint32_t) * kStage;
  const size_t row_words =
      sizeof(uint32_t) * (static_cast<size_t>(n_words) + 3);
  const size_t bands = sizeof(uint32_t) * band_words(n_bands);
  const size_t tables =
      sizeof(uint32_t) * static_cast<size_t>(n_tab) * (kRootSize + kSideSize);
  if (bands + stage > kMaxShared)
    return static_cast<int>(cudaErrorInvalidValue);
  const bool shared_root = bands + tables + stage <= kMaxShared;
  const size_t fixed = bands + (shared_root ? tables : 0);
  int warps = kMaxWarps;
  while (warps > 1 && fixed + warps * (stage + row_words) > kMaxShared)
    warps /= 2;
  const bool shared_words = fixed + warps * (stage + row_words) <= kMaxShared;
  if (!shared_words) warps = kMaxWarps;
  const size_t smem =
      fixed + warps * (stage + (shared_words ? row_words : 0));
  auto kernel = shared_words
                    ? (shared_root ? huffman_walk_kernel<true, true>
                                   : huffman_walk_kernel<true, false>)
                    : (shared_root ? huffman_walk_kernel<false, true>
                                   : huffman_walk_kernel<false, false>);
  if (smem > 48 * 1024) {       // past the default limit of a block
    const cudaError_t rc = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (rc != cudaSuccess) return static_cast<int>(rc);
  }
  kernel<<<(rows + warps - 1) / warps, 32 * warps, smem, stream>>>(
      words, l1, l1b, l2, n_lines, code, basf, soff, misc, rows, n_words,
      n_bands, total_lines, n_tab, l2_width, n_scale_bits, n_mant_size_bits,
      n_table_id_bits);
  return static_cast<int>(cudaGetLastError());
}
