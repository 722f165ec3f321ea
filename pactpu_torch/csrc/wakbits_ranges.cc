// The native bitstream runtime of pactpu_torch: csrc/wakbits.cc, which the
// JAX package builds too, plus its Huffman parse and code repack over
// contiguous ranges of channel-blocks on several host threads.
//
// Each channel-block of a payload starts with its own uint32 byte count,
// and its outputs are rows of their own (overall, table_id, ba, sf, mant;
// lrms one row a block), so ranges of whole channel-blocks parse apart.
// Each range runs wakbits.cc's own serial loop (included below, not
// copied) on its slice of the payload and its rows of the outputs, so the
// outputs are the serial call's bit for bit.  A range holds whole blocks,
// so a block's channel-blocks, which share its lrms row, stay in one.
//
//   wak_unpack_file_ranges   wak_unpack_file over n_ranges ranges
//   wak_repack_codes_ranges  wak_repack_codes over n_ranges ranges of rows
//
// The decode trees (g_tables) are only read while a parse runs.
//
// Build: g++ -O3 -shared -fPIC -pthread -o libwakbits_ranges.so
//        wakbits_ranges.cc

#include "../../csrc/wakbits.cc"

#include <algorithm>
#include <system_error>
#include <thread>
#include <vector>

namespace {

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

// wak_unpack_file (same arguments, same outputs, same result) with the
// channel-blocks cut into n_ranges ranges of whole blocks (n_channels
// channel-blocks each; at most one range a block), parsed at once; one
// range is the serial call itself.  One walk of the byte-count prefixes,
// under wak_unpack_file's own bounds checks, finds each range's first
// byte (range 0's always); each range's call reads from there to the end
// of the data, so the range that holds a prefix running past the end
// finds it, and the ranges after it do not run.  Returns the bytes
// consumed, or -(i+1) for the first bad channel-block i of the payload,
// as the serial call does.
int64_t wak_unpack_file_ranges(const uint8_t* data, int64_t size,
                               int n_cblocks, int n_bands,
                               const int32_t* n_lines, int total_lines,
                               int n_scale_bits, int n_mant_size_bits,
                               int n_table_id_bits, int read_lrms,
                               int n_channels, int32_t* overall,
                               int32_t* table_id, int32_t* ba, int32_t* sf,
                               int32_t* mant, int32_t* lrms, int n_ranges) {
  const int64_t blocks = (static_cast<int64_t>(n_cblocks) + n_channels - 1)
                         / n_channels;
  const int n = static_cast<int>(
      std::max<int64_t>(1, std::min<int64_t>(n_ranges, blocks)));
  if (n == 1)
    return wak_unpack_file(data, size, n_cblocks, n_bands, n_lines,
                           total_lines, n_scale_bits, n_mant_size_bits,
                           n_table_id_bits, read_lrms, n_channels, overall,
                           table_id, ba, sf, mant, lrms);
  // range k: channel-blocks [cb[k], cb[k+1]), bytes from off[k]
  std::vector<int64_t> cb(n + 1), off(n);
  for (int k = 0; k <= n; ++k)
    cb[k] = std::min<int64_t>(blocks * k / n * n_channels, n_cblocks);
  int reached = 0;  // ranges whose first byte the walk found
  int64_t pos = 0;
  for (int64_t i = 0; i < n_cblocks; ++i) {
    if (reached < n && cb[reached] == i) off[reached++] = pos;
    if (pos + 4 > size) break;
    uint32_t nbytes;
    std::memcpy(&nbytes, data + pos, 4);
    if (pos + 4 + nbytes > size) break;
    pos += 4 + nbytes;
  }
  std::vector<int64_t> rc(reached);
  run_ranges(reached, [&](int k) {
    const int64_t c0 = cb[k];
    rc[k] = wak_unpack_file(
        data + off[k], size - off[k], static_cast<int>(cb[k + 1] - c0),
        n_bands, n_lines, total_lines, n_scale_bits, n_mant_size_bits,
        n_table_id_bits, read_lrms, n_channels, overall + c0, table_id + c0,
        ba + c0 * n_bands, sf + c0 * n_bands, mant + c0 * total_lines,
        lrms + c0 / n_channels * n_bands);
  });
  for (int k = 0; k < reached; ++k)
    if (rc[k] < 0) return rc[k] - cb[k];
  return off[reached - 1] + rc[reached - 1];
}

// wak_repack_codes (same arguments, same result: the widest row's bits, or
// -1 if a row overflows n_words) with the rows cut into n_ranges ranges,
// repacked at once; one range is the serial call itself.
int64_t wak_repack_codes_ranges(int n_cblocks, int n_bands,
                                const int32_t* n_lines, int total_lines,
                                const int32_t* ba, const int32_t* mant,
                                uint32_t* words, int n_words, int n_ranges) {
  const int n = std::max(1, std::min(n_ranges, n_cblocks));
  if (n == 1)
    return wak_repack_codes(n_cblocks, n_bands, n_lines, total_lines, ba,
                            mant, words, n_words);
  std::vector<int64_t> rc(n);
  run_ranges(n, [&](int k) {
    const int64_t r0 = static_cast<int64_t>(n_cblocks) * k / n;
    const int64_t r1 = static_cast<int64_t>(n_cblocks) * (k + 1) / n;
    rc[k] = wak_repack_codes(static_cast<int>(r1 - r0), n_bands, n_lines,
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
