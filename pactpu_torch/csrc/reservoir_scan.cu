// K11 reservoir_scan: the reference reservoir policy over a chunk's
// measured savings and leftovers.
//
// Replaces pactpu/codec/engine.py:765 _reservoir_scan_fn, a lax.scan (not
// a Pallas kernel): per block, withdraw deposit / divisor when the deposit
// is above 10 bits, fold a negative deposit into the extra bits, grant
// channel 0 the extra bits, then deposit the block's channel savings and
// carry its allocation leftover (reference codec/Huffman.py:353-371,
// codec/codec.py:229, 258-260).  The carry (deposit, extra) is int32 and
// wraps as pactpu's does; a block whose valid flag is 0 leaves it alone and
// is granted 0.
//
// Bound on the H100: bytes, about 8.7 KB a 512-block stereo chunk, 2.6 ns.
// Really it is a chain of B dependent integer steps over a launch floor of
// about 5 us, and no parallelism shortens the chain, so the design keeps
// the chain short and everything else off it, in one warp:
//
// - each lane loads and sums one block's channel savings and its leftover
//   and flag (coalesced, 32 blocks a pass), the next pass's loads issued
//   before this pass's chain, so their latency hides behind it;
// - every lane walks the same 32 steps in lockstep, taking step j's inputs
//   from lane j by shuffles (they do not depend on the chain, so they
//   issue ahead of it), and lane j keeps step j's grant for one coalesced
//   store; a pass always takes 32 steps: blocks past B read as invalid,
//   whose steps are no-ops;
// - the withdrawal's division by the run's divisor is one 32 x 32 -> 64
//   bit multiply and a shift by a magic number made once (Granlund and
//   Montgomery's round-up method, exact for the dividends the policy
//   divides: 10 < deposit < 2^31).  The first form divided with `/`,
//   nvcc's sequence for a divisor known at run time: on an NVIDIA H100
//   80GB HBM3 at 700 W, 0.0769 ms alone a 512-block chunk (about 230
//   clocks a step) against this form's 0.0221 (about 66).

#include "kernels.h"

namespace {

__device__ __forceinline__ int32_t add32(int32_t a, int32_t b) {
  return static_cast<int32_t>(static_cast<uint32_t>(a) +
                              static_cast<uint32_t>(b));
}

// floor(n / d) for 0 <= n < 2^31 as (n * magic) >> shift, with
// shift = 31 + ceil(log2 d) and magic = floor(2^shift / d) + 1 < 2^32
// (d >= 1): then 2^shift < magic * d <= 2^shift + 2^(shift - 31).
struct Divisor {
  uint32_t magic;
  int shift;
};

__device__ __forceinline__ Divisor make_divisor(int d) {
  const int l = 32 - __clz(static_cast<unsigned>(d - 1));
  const int shift = 31 + l;
  return {static_cast<uint32_t>((1ull << shift) / static_cast<unsigned>(d)
                                + 1ull),
          shift};
}

__device__ __forceinline__ int32_t divide(int32_t n, Divisor dv) {
  return static_cast<int32_t>(
      (static_cast<uint64_t>(static_cast<uint32_t>(n)) * dv.magic) >>
      dv.shift);
}

struct Step {
  int32_t savings, leftover;
  int valid;
};

__device__ __forceinline__ Step load_step(const int32_t* __restrict__ savings,
                                          const int32_t* __restrict__ leftover,
                                          const uint8_t* __restrict__ valid,
                                          int t, int blocks, int channels) {
  Step st{0, 0, 0};
  if (t < blocks) {
    const int32_t* row = savings + static_cast<int64_t>(t) * channels;
    for (int c = 0; c < channels; ++c) st.savings = add32(st.savings, row[c]);
    st.leftover = leftover[t];
    st.valid = valid[t] != 0;
  }
  return st;
}

__global__ void __launch_bounds__(32, 1)
reservoir_scan_kernel(const int32_t* __restrict__ savings,
                      const int32_t* __restrict__ leftover,
                      const uint8_t* __restrict__ valid,
                      const int32_t* __restrict__ carry_in,
                      int32_t* __restrict__ carry_out,
                      float* __restrict__ extras, int blocks, int channels,
                      int divisor) {
  const int lane = threadIdx.x;
  const Divisor dv = make_divisor(divisor);
  int32_t deposit = carry_in[0];
  int32_t extra = carry_in[1];
  Step cur = load_step(savings, leftover, valid, lane, blocks, channels);
  for (int t0 = 0; t0 < blocks; t0 += 32) {
    const Step next = load_step(savings, leftover, valid, t0 + 32 + lane,
                                blocks, channels);
    float mine = 0.0f;
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const int32_t sj = __shfl_sync(0xffffffffu, cur.savings, j);
      const int32_t lj = __shfl_sync(0xffffffffu, cur.leftover, j);
      const int vj = __shfl_sync(0xffffffffu, cur.valid, j);
      const int32_t w = deposit > 10 ? divide(deposit, dv) : 0;
      const bool neg = deposit < 0;
      const int32_t granted = add32(add32(extra, w), neg ? deposit : 0);
      const int32_t kept = deposit > 10 ? deposit - w : (neg ? 0 : deposit);
      if (vj) {
        deposit = add32(kept, sj);
        extra = lj;
      }
      if (lane == j) mine = vj ? __int2float_rn(granted) : 0.0f;
    }
    if (t0 + lane < blocks) extras[t0 + lane] = mine;
    cur = next;
  }
  if (lane == 0) {
    carry_out[0] = deposit;
    carry_out[1] = extra;
  }
}

}  // namespace

extern "C" int pactpu_reservoir_scan(const int32_t* savings,
                                     const int32_t* leftover,
                                     const uint8_t* valid,
                                     const int32_t* carry_in,
                                     int32_t* carry_out, float* extras,
                                     int blocks, int channels, int divisor,
                                     cudaStream_t stream) {
  reservoir_scan_kernel<<<1, 32, 0, stream>>>(savings, leftover, valid,
                                              carry_in, carry_out, extras,
                                              blocks, channels, divisor);
  return static_cast<int>(cudaGetLastError());
}
