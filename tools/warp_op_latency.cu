// Latency, in clocks, of the warp-wide operations a latency-bound kernel is
// made of (K2 water_fill's step), measured with clock64() on one warp: each
// loop is a chain in which every operation needs the one before.
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -o warp_op_latency \
//        tools/warp_op_latency.cu && ./warp_op_latency
//
// Prints clocks per iteration; each chain but the first adds one integer add
// (about 4 clocks) to the operation it names.
#include <cstdio>

#include <cuda_runtime.h>

constexpr unsigned kFull = 0xffffffffu;
constexpr int kIters = 8192;

__global__ void latency(long long* out, unsigned seed) {
  const int lane = threadIdx.x & 31;
  unsigned x = (threadIdx.x + 1) * 2654435761u + seed;
  long long t0;
  int k = 0;
#define TIME(body)                                  \
  t0 = clock64();                                   \
  for (int i = 0; i < kIters; ++i) { body }         \
  if (lane == 0) out[k] = clock64() - t0;           \
  ++k;                                              \
  __syncwarp();
  TIME(x = __shfl_xor_sync(kFull, x, 1) + 1u;)
  TIME(x = __reduce_max_sync(kFull, x ^ (unsigned)lane) + 1u;)
  TIME(x = __ballot_sync(kFull, (x >> lane) & 1u) + 1u;)
  TIME(x = (unsigned)__ffs((int)x) + x;)
  TIME(x = __any_sync(kFull, x & 1u) ? x + 1u : x + 3u;)
  // an arg-max step by reduction, ballot and find-first-set
  TIME(unsigned m = __reduce_max_sync(kFull, x);
       int c = __ffs(__ballot_sync(kFull, x == m)) - 1;
       if (lane == c) x -= 7u;)
  // the same by a shuffle butterfly on (value, index) pairs
  TIME(unsigned key = x; int cand = lane;
       for (int o = 16; o > 0; o >>= 1) {
         unsigned k2 = __shfl_xor_sync(kFull, key, o);
         int c2 = __shfl_xor_sync(kFull, cand, o);
         if (k2 > key || (k2 == key && c2 < cand)) { key = k2; cand = c2; }
       }
       if (lane == cand) x -= 7u;)
  // two dependent reductions
  TIME(unsigned m = __reduce_max_sync(kFull, x);
       unsigned c = __reduce_min_sync(kFull, x == m ? (unsigned)lane : 32u);
       if (lane == c) x -= 7u;)
  if (lane == 1) out[15] = x;   // keeps the chains alive
}

int main() {
  const char* names[] = {"shuffle + add", "reduce_max + add", "ballot + add",
                         "ffs + add", "any + select",
                         "reduce_max, ballot, ffs, update",
                         "shuffle butterfly arg-max, update",
                         "reduce_max, reduce_min, update"};
  long long* d;
  long long h[16];
  if (cudaMalloc(&d, sizeof(h)) != cudaSuccess) return 1;
  for (int rep = 0; rep < 2; ++rep) {       // the second run is warm
    latency<<<1, 32>>>(d, 12345u + rep);
    if (cudaMemcpy(h, d, sizeof(h), cudaMemcpyDeviceToHost) != cudaSuccess)
      return 1;
  }
  for (int i = 0; i < 8; ++i)
    printf("%-36s %.1f clocks\n", names[i], (double)h[i] / kIters);
  cudaFree(d);
  return 0;
}
