// The native bitstream runtime of pactpu_torch: csrc/wakbits.cc, which the
// JAX package builds too, plus a word-wide Huffman parse and code repack
// run over contiguous ranges of channel-blocks on several host threads.
//
// Ranges.  Each channel-block of a payload starts with its own uint32 byte
// count, and its outputs are rows of their own (overall, table_id, ba, sf,
// mant; lrms one row a block), so ranges of whole channel-blocks parse
// apart.  A range holds whole blocks, so a block's channel-blocks, which
// share its lrms row, stay in one.
//
// The word-wide loops.  wakbits.cc's serial loop (included below, not
// copied) reads a bit at a time, walks a pointer tree a node a bit, and
// repacks a bit at a time.  The loops here move up to 64 bits at a time:
// - the parse reads a channel-block through a 64-bit bit buffer, refilled
//   a byte-aligned word at a time; bytes past the channel-block's byte
//   count read as zero, so no load leaves the channel-block.  It decodes a
//   Huffman code by one lookup of its next 11 bits in the table set's
//   two-level LUT (pactpu_torch.ops.huffman_walk.build_walk_lut, which the
//   device walk K5 reads too) and, for a code longer than 11 bits, a
//   second lookup.  The sign bits come 32 at a time, and each fixed-width
//   field, escape and .pac raw code is one read;
// - the repack appends each line's code to a 64-bit accumulator and
//   stores its 32-bit words MSB-first.
// Their outputs and results are the serial loop's bit for bit: the bytes
// consumed, or -(i+1) for the first bad channel-block i; the widest row's
// bits, or -1.  A dead LUT entry is the tree's dead branch.  Codes that end
// past a channel-block's last bit fail it: the bits consumed are checked
// after every band and at its end.  wak_init_tables_lut checks every LUT
// entry against the serial loop's walk of the trees and takes no LUT that
// disagrees with them.
//
// The fallback.  A range runs wakbits.cc's serial loop itself where the
// word loops cannot: a .wak parse whose table set has no LUT (build_walk_
// lut returned None, or an entry disagreed), n_mant_size_bits past 5 or
// n_scale_bits or n_table_id_bits past 32, or a repack with a bit
// allocation outside [0, 32].
//
//   wak_init_tables_lut      wak_init_tables, then the set's LUT
//   wak_unpack_file_ranges   wak_unpack_file over n_ranges ranges, with
//                            counts: word loop (0/1), deep codes, escapes
//   wak_repack_codes_ranges  wak_repack_codes over n_ranges ranges of rows
//
// The decode trees (g_tables) and the LUT (g_lut) are only read while a
// parse runs.
//
// Build: g++ -O3 -shared -fPIC -pthread -o libwakbits_ranges.so
//        wakbits_ranges.cc

#include "../../csrc/wakbits.cc"

#include <algorithm>
#include <system_error>
#include <thread>
#include <vector>

static_assert(__BYTE_ORDER__ == __ORDER_LITTLE_ENDIAN__,
              "WordReader loads 8 bytes little-endian and swaps them");

namespace {

constexpr int kRootBits = 11;            // ops.kernels.WALK_ROOT_BITS
constexpr int kRootSize = 1 << kRootBits;
constexpr int kRanks = 128;              // deep prefixes a table, at most
constexpr uint32_t kDeep = 0x80000000u;  // level-1 entry: rank of a prefix
constexpr uint32_t kEscape = 0x20u;

// The two-level LUT of the table set g_tables holds, in build_walk_lut's
// entry format (pactpu_torch/ops/huffman_walk.py): l1 [tables][kRootSize],
// l1b [tables][kRanks], l2 [tables][pool].  on: it agreed with the trees.
struct Lut {
  std::vector<uint32_t> l1, l1b, l2;
  int64_t pool = 0;
  bool on = false;
};

Lut g_lut;

constexpr int kDeadEnd = -3;
constexpr int kInner = -4;

// The serial loop's walk of `tree` from node *cur over the n bits of
// `bits`, MSB first; it stops at the first node whose sym is set.  Returns
// that sym (-1 an escape, >= 0 a symbol) with *used the bits it took,
// kDeadEnd for a dead branch, or kInner if the n bits end on an inner
// node (*cur).
int walk_bits(const std::vector<Node>& tree, int* cur, uint32_t bits, int n,
              int* used) {
  for (int k = 0;; ++k) {
    if (tree[*cur].sym != -2) {
      *used = k;
      return tree[*cur].sym;
    }
    if (k == n) {
      *used = n;
      return kInner;
    }
    const int nxt = tree[*cur].child[(bits >> (n - 1 - k)) & 1];
    if (nxt < 0) {
      *used = k + 1;
      return kDeadEnd;
    }
    *cur = nxt;
  }
}

// Whether the entry e decodes as the walk did: a dead branch as length 0,
// a code of `len` bits as that length and its symbol or escape flag.
bool entry_agrees(uint32_t e, int res, int len) {
  if (res == kDeadEnd) return (e & 31u) == 0;
  if (len < 1 || len > 31 || (e & 31u) != static_cast<uint32_t>(len))
    return false;
  if (res == -1) return (e & kEscape) != 0;
  return (e & kEscape) == 0 && (e >> 6) == static_cast<uint32_t>(res);
}

// Whether one table's LUT decodes every bit pattern as its tree does.
bool lut_agrees(const std::vector<Node>& tree, const uint32_t* l1,
                const uint32_t* l1b, const uint32_t* l2, int64_t pool) {
  for (uint32_t idx = 0; idx < kRootSize; ++idx) {
    int cur = 0, used;
    const int res = walk_bits(tree, &cur, idx, kRootBits, &used);
    const uint32_t e = l1[idx];
    if (res != kInner) {
      if ((e & kDeep) || !entry_agrees(e, res, used)) return false;
      continue;
    }
    if (!(e & kDeep)) return false;
    const uint32_t b2 = l1b[e & (kRanks - 1)];
    const int k2 = static_cast<int>(b2 & 15);
    const int64_t base = b2 >> 4;
    if (base + (int64_t{1} << k2) > pool) return false;
    for (uint32_t tail = 0; tail < (1u << k2); ++tail) {
      int c2 = cur, used2;
      const int r2 = walk_bits(tree, &c2, tail, k2, &used2);
      if (r2 == kInner || !entry_agrees(l2[base + tail], r2, kRootBits + used2))
        return false;
    }
  }
  return true;
}

// A channel-block's payload bits, MSB first, through a 64-bit buffer: the
// top avail_ bits of buf_ are the next bits, 56 to 63 of them after a
// refill; reads of up to avail_ bits in all may follow it.  A refill ORs
// the 8 bytes at next_ in under the buffered bits (bits it loads twice
// are the same bits); bytes at or past nbytes load as zero.
class WordReader {
 public:
  WordReader(const uint8_t* data, int64_t nbytes)
      : data_(data), nbytes_(nbytes) {}
  void refill() {
    buf_ |= load(next_) >> avail_;
    next_ += (63 - avail_) >> 3;
    avail_ |= 56;
  }
  // the next n bits (0 <= n <= 56), not consumed
  uint64_t peek(int n) const { return (buf_ >> 1) >> (63 - n); }
  void skip(int n) {
    buf_ <<= n;
    avail_ -= n;
  }
  int avail() const { return avail_; }
  uint32_t read(int n) {  // n <= 32
    const uint32_t v = static_cast<uint32_t>(peek(n));
    skip(n);
    return v;
  }
  // bits consumed, those read as zero past the end included
  int64_t consumed() const { return next_ * 8 - avail_; }

 private:
  uint64_t load(int64_t at) const {
    uint64_t v;
    if (at + 8 <= nbytes_) {
      std::memcpy(&v, data_ + at, 8);
      return __builtin_bswap64(v);
    }
    v = 0;
    for (int k = 0; k < 8; ++k)
      v = (v << 8) | (at + k < nbytes_ ? data_[at + k] : 0u);
    return v;
  }

  const uint8_t* data_;
  int64_t nbytes_;
  uint64_t buf_ = 0;
  int avail_ = 0;
  int64_t next_ = 0;
};

// Whether the word-wide parse takes these widths (the stream header's;
// a .wak parse needs the LUT): n_mant_size_bits <= 5 keeps a bit
// allocation, and so an escape or a raw code, within 32 bits; no field is
// wider than 32.
bool parse_fits(int n_scale_bits, int n_mant_size_bits, int n_table_id_bits) {
  return n_scale_bits >= 0 && n_scale_bits <= 32 && n_mant_size_bits >= 0 &&
         n_mant_size_bits <= 5 && n_table_id_bits >= 0 &&
         n_table_id_bits <= 32 && (n_table_id_bits == 0 || g_lut.on);
}

// wak_unpack_file's loop (same arguments, outputs and result) through a
// WordReader and the LUT.  Adds the codes that took the LUT's second level
// to *deep and the escapes to *escapes.
int64_t unpack_words(const uint8_t* data, int64_t size, int n_cblocks,
                     int n_bands, const int32_t* n_lines, int total_lines,
                     int n_scale_bits, int n_mant_size_bits,
                     int n_table_id_bits, int read_lrms, int n_channels,
                     int32_t* overall, int32_t* table_id, int32_t* ba,
                     int32_t* sf, int32_t* mant, int32_t* lrms,
                     int64_t* deep, int64_t* escapes) {
  const bool huff = n_table_id_bits > 0;
  const int n_tables = static_cast<int>(g_tables.trees.size());
  int widest = 0;
  for (int b = 0; b < n_bands; ++b) widest = std::max(widest, n_lines[b]);
  std::vector<uint32_t> signs(widest / 32 + 1);  // a band's, MSB first
  int64_t n_deep = 0, n_esc = 0, off = 0;
  for (int i = 0; i < n_cblocks; ++i) {
    if (off + 4 > size) return -(i + 1);
    uint32_t nbytes;
    std::memcpy(&nbytes, data + off, 4);
    off += 4;
    if (off + nbytes > size) return -(i + 1);
    WordReader r(data + off, nbytes);
    const int64_t nbits = int64_t{nbytes} * 8;
    off += nbytes;

    int32_t* ba_r = ba + static_cast<int64_t>(i) * n_bands;
    int32_t* sf_r = sf + static_cast<int64_t>(i) * n_bands;
    int32_t* mant_r = mant + static_cast<int64_t>(i) * total_lines;
    int32_t* lr_r = lrms + static_cast<int64_t>(i / n_channels) * n_bands;
    std::memset(mant_r, 0, sizeof(int32_t) * total_lines);

    r.refill();
    overall[i] = static_cast<int32_t>(r.read(n_scale_bits));
    const uint32_t *l1 = nullptr, *l1b = nullptr, *l2 = nullptr;
    if (huff) {
      r.refill();
      const int tid = static_cast<int>(r.read(n_table_id_bits));
      table_id[i] = tid;
      if (tid < 1 || tid > n_tables) return -(i + 1);
      l1 = g_lut.l1.data() + static_cast<int64_t>(tid - 1) * kRootSize;
      l1b = g_lut.l1b.data() + static_cast<int64_t>(tid - 1) * kRanks;
      l2 = g_lut.l2.data() + static_cast<int64_t>(tid - 1) * g_lut.pool;
    } else {
      table_id[i] = 0;
    }

    int line0 = 0;
    for (int b = 0; b < n_bands; ++b) {
      r.refill();
      int a = static_cast<int>(r.read(n_mant_size_bits));
      if (a) a += 1;
      ba_r[b] = a;
      sf_r[b] = static_cast<int32_t>(r.read(n_scale_bits));
      const int nl = n_lines[b];
      int32_t* m = mant_r + line0;
      if (a && huff) {
        // sign bits first, then Huffman codes (ref pacfile.py:334-342)
        for (int j = 0; j < nl; j += 32) {
          const int k = std::min(32, nl - j);
          r.refill();
          signs[j >> 5] = r.read(k) << (32 - k);
        }
        for (int j = 0; j < nl; ++j) {
          if (r.avail() < 31) r.refill();  // codes have at most 31 bits
          uint32_t e = l1[r.peek(kRootBits)];
          if (e & kDeep) {
            const uint32_t b2 = l1b[e & (kRanks - 1)];
            const int k2 = static_cast<int>(b2 & 15);
            e = l2[(b2 >> 4) + (r.peek(kRootBits + k2) & ((1u << k2) - 1))];
            ++n_deep;
          }
          const int len = static_cast<int>(e & 31);
          if (!len) return -(i + 1);
          r.skip(len);
          uint32_t s = e >> 6;
          if (e & kEscape) {
            if (r.avail() < a) r.refill();
            s = r.read(a);
            ++n_esc;
          }
          const uint32_t sign = (signs[j >> 5] << (j & 31)) >> 31;
          m[j] = static_cast<int32_t>((sign << (a - 1)) + s);
        }
      } else if (a) {
        // raw sign-magnitude mantissa codes (solution/pacfile_.py:186-192)
        for (int j = 0; j < nl; ++j) {
          r.refill();
          m[j] = static_cast<int32_t>(r.read(a));
        }
      }
      if (r.consumed() > nbits) return -(i + 1);
      line0 += nl;
    }
    if (read_lrms) {
      for (int b = 0; b < n_bands; b += 32) {
        const int k = std::min(32, n_bands - b);
        r.refill();
        const uint32_t v = r.read(k);
        for (int q = 0; q < k; ++q)
          lr_r[b + q] = static_cast<int32_t>((v >> (k - 1 - q)) & 1u);
      }
    }
    if (r.consumed() > nbits) return -(i + 1);
  }
  *deep += n_deep;
  *escapes += n_esc;
  return off;
}

// wak_repack_codes's loop (same arguments, outputs and result) through a
// 64-bit accumulator: each line's a-bit code goes in at the bottom, and
// every 32 bits go out as a word, MSB first.
int64_t repack_words(int n_cblocks, int n_bands, const int32_t* n_lines,
                     int total_lines, const int32_t* ba, const int32_t* mant,
                     uint32_t* words, int n_words) {
  int64_t maxbits = 0;
  const int64_t cap = static_cast<int64_t>(n_words) * 32;
  for (int i = 0; i < n_cblocks; ++i) {
    const int32_t* ba_r = ba + static_cast<int64_t>(i) * n_bands;
    const int32_t* m_r = mant + static_cast<int64_t>(i) * total_lines;
    uint32_t* w = words + static_cast<int64_t>(i) * n_words;
    uint64_t acc = 0;
    int held = 0;  // bits of acc not stored yet, at its bottom
    int64_t p = 0;
    int line0 = 0;
    for (int b = 0; b < n_bands; ++b) {
      const int a = ba_r[b];
      const int nl = n_lines[b];
      if (a) {
        if (p + static_cast<int64_t>(a) * nl > cap) return -1;
        const uint64_t mask = (uint64_t{1} << a) - 1;
        const int32_t* m = m_r + line0;
        for (int j = 0; j < nl; ++j) {
          acc = (acc << a) | (static_cast<uint32_t>(m[j]) & mask);
          held += a;
          if (held >= 32) {
            held -= 32;
            *w++ |= static_cast<uint32_t>(acc >> held);
          }
        }
        p += static_cast<int64_t>(a) * nl;
      }
      line0 += nl;
    }
    if (held) *w |= static_cast<uint32_t>(acc << (32 - held));
    if (p > maxbits) maxbits = p;
  }
  return maxbits;
}

// A range of the repack: the word loop where every bit allocation of its
// rows is in [0, 32] (a parse of n_mant_size_bits past 5 gives more),
// else the serial loop.
int64_t repack_range(int n_cblocks, int n_bands, const int32_t* n_lines,
                     int total_lines, const int32_t* ba, const int32_t* mant,
                     uint32_t* words, int n_words) {
  bool fits = true;
  const int64_t n_ba = static_cast<int64_t>(n_cblocks) * n_bands;
  for (int64_t k = 0; k < n_ba; ++k) fits &= ba[k] >= 0 && ba[k] <= 32;
  return fits ? repack_words(n_cblocks, n_bands, n_lines, total_lines, ba,
                             mant, words, n_words)
              : wak_repack_codes(n_cblocks, n_bands, n_lines, total_lines,
                                 ba, mant, words, n_words);
}

// fn(k) for every k in [0, n): ranges 1..n-1 on threads of their own,
// range 0 on the calling thread (and any range whose thread could not be
// started, after it).
template <class F>
void run_ranges(int n, const F& fn) {
  std::vector<std::thread> threads;
  std::vector<int> left;
  threads.reserve(n);
  for (int k = 1; k < n; ++k) {
    try {
      threads.emplace_back(fn, k);
    } catch (const std::system_error&) {
      left.push_back(k);
    }
  }
  fn(0);
  for (int k : left) fn(k);
  for (auto& t : threads) t.join();
}

}  // namespace

extern "C" {

// wak_init_tables (same arguments), then the two-level LUT of the same set
// (build_walk_lut's l1 [n_tables][2048], l1b [n_tables][128], l2
// [n_tables][pool]), taken if every entry of every table decodes as the
// serial loop's walk of its tree does.  l1 null (build_walk_lut returned
// None) or a disagreement leaves the .wak parse on the tree walk.
// Returns 1 if the parse reads the LUT, else 0.
int wak_init_tables_lut(const uint8_t* lengths, const uint32_t* codes,
                        const uint8_t* esc_len, const uint32_t* esc_codes,
                        int n_tables, int n_syms, const uint32_t* l1,
                        const uint32_t* l1b, const uint32_t* l2,
                        int64_t pool) {
  wak_init_tables(lengths, codes, esc_len, esc_codes, n_tables, n_syms);
  g_lut = Lut();
  if (l1 == nullptr || n_tables <= 0 || pool <= 0) return 0;
  for (int t = 0; t < n_tables; ++t)
    if (!lut_agrees(g_tables.trees[t], l1 + static_cast<int64_t>(t) * kRootSize,
                    l1b + static_cast<int64_t>(t) * kRanks,
                    l2 + static_cast<int64_t>(t) * pool, pool))
      return 0;
  g_lut.l1.assign(l1, l1 + static_cast<int64_t>(n_tables) * kRootSize);
  g_lut.l1b.assign(l1b, l1b + static_cast<int64_t>(n_tables) * kRanks);
  g_lut.l2.assign(l2, l2 + static_cast<int64_t>(n_tables) * pool);
  g_lut.pool = pool;
  g_lut.on = true;
  return 1;
}

// wak_unpack_file (same arguments, same outputs, same result) with the
// channel-blocks cut into n_ranges ranges of whole blocks (n_channels
// channel-blocks each; at most one range a block), parsed at once, each
// by the word loop where parse_fits, else by the serial loop.  One walk
// of the byte-count prefixes, under wak_unpack_file's own bounds checks,
// finds each range's first byte (range 0's always); each range's call
// reads from there to the end of the data, so the range that holds a
// prefix running past the end finds it, and the ranges after it do not
// run.  Returns the bytes consumed, or -(i+1) for the first bad
// channel-block i of the payload, as the serial call does.  counts, if
// not null, gets [1 if the word loop ran else 0, the codes that took the
// LUT's second level, the escapes], the latter two over the ranges that
// returned.
int64_t wak_unpack_file_ranges(const uint8_t* data, int64_t size,
                               int n_cblocks, int n_bands,
                               const int32_t* n_lines, int total_lines,
                               int n_scale_bits, int n_mant_size_bits,
                               int n_table_id_bits, int read_lrms,
                               int n_channels, int32_t* overall,
                               int32_t* table_id, int32_t* ba, int32_t* sf,
                               int32_t* mant, int32_t* lrms, int n_ranges,
                               int64_t* counts) {
  const bool fits =
      parse_fits(n_scale_bits, n_mant_size_bits, n_table_id_bits);
  const int64_t blocks = (static_cast<int64_t>(n_cblocks) + n_channels - 1)
                         / n_channels;
  const int n = static_cast<int>(
      std::max<int64_t>(1, std::min<int64_t>(n_ranges, blocks)));
  // range k: channel-blocks [cb[k], cb[k+1]), bytes from off[k]
  std::vector<int64_t> cb(n + 1), off(n, 0);
  for (int k = 0; k <= n; ++k)
    cb[k] = std::min<int64_t>(blocks * k / n * n_channels, n_cblocks);
  int reached = 1;  // ranges whose first byte the walk found
  int64_t pos = 0;
  for (int64_t i = 0; i < n_cblocks && reached < n; ++i) {
    if (cb[reached] == i) off[reached++] = pos;
    if (pos + 4 > size) break;
    uint32_t nbytes;
    std::memcpy(&nbytes, data + pos, 4);
    if (pos + 4 + nbytes > size) break;
    pos += 4 + nbytes;
  }
  std::vector<int64_t> rc(reached), deep(reached, 0), esc(reached, 0);
  run_ranges(reached, [&](int k) {
    const int64_t c0 = cb[k];
    const int rows = static_cast<int>(cb[k + 1] - c0);
    if (fits) {
      rc[k] = unpack_words(
          data + off[k], size - off[k], rows, n_bands, n_lines, total_lines,
          n_scale_bits, n_mant_size_bits, n_table_id_bits, read_lrms,
          n_channels, overall + c0, table_id + c0, ba + c0 * n_bands,
          sf + c0 * n_bands, mant + c0 * total_lines,
          lrms + c0 / n_channels * n_bands, &deep[k], &esc[k]);
    } else {
      rc[k] = wak_unpack_file(
          data + off[k], size - off[k], rows, n_bands, n_lines, total_lines,
          n_scale_bits, n_mant_size_bits, n_table_id_bits, read_lrms,
          n_channels, overall + c0, table_id + c0, ba + c0 * n_bands,
          sf + c0 * n_bands, mant + c0 * total_lines,
          lrms + c0 / n_channels * n_bands);
    }
  });
  if (counts != nullptr) {
    counts[0] = fits ? 1 : 0;
    counts[1] = counts[2] = 0;
    for (int k = 0; k < reached; ++k) {
      counts[1] += deep[k];
      counts[2] += esc[k];
    }
  }
  for (int k = 0; k < reached; ++k)
    if (rc[k] < 0) return rc[k] - cb[k];
  return off[reached - 1] + rc[reached - 1];
}

// wak_repack_codes (same arguments, same result: the widest row's bits, or
// -1 if a row overflows n_words) with the rows cut into n_ranges ranges,
// repacked at once, each by the word loop where its bit allocations allow
// (repack_range).
int64_t wak_repack_codes_ranges(int n_cblocks, int n_bands,
                                const int32_t* n_lines, int total_lines,
                                const int32_t* ba, const int32_t* mant,
                                uint32_t* words, int n_words, int n_ranges) {
  const int n = std::max(1, std::min(n_ranges, n_cblocks));
  std::vector<int64_t> rc(n);
  run_ranges(n, [&](int k) {
    const int64_t r0 = static_cast<int64_t>(n_cblocks) * k / n;
    const int64_t r1 = static_cast<int64_t>(n_cblocks) * (k + 1) / n;
    rc[k] = repack_range(static_cast<int>(r1 - r0), n_bands, n_lines,
                         total_lines, ba + r0 * n_bands,
                         mant + r0 * total_lines, words + r0 * n_words,
                         n_words);
  });
  int64_t widest = 0;
  for (int64_t r : rc) {
    if (r < 0) return -1;
    widest = std::max(widest, r);
  }
  return widest;
}

}  // extern "C"
