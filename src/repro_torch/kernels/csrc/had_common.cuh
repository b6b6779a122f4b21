// Device helpers shared by the HAD kernels (prefill, both decodes, page
// scores, score matrix). They replace `_scores` / `_threshold` of
// src/repro/kernels/binary_decode_attention.py.
//
// Packed words arrive as int32 tensors holding the JAX package's uint32 bit
// patterns; the kernels reinterpret them as uint32_t. Tail bits past d are
// zero in both operands, so XOR + popcount over whole words is exact.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace had {

// Largest packed width the kernels take: d <= 256 bits.
constexpr int kMaxWords = 8;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// Binary score d - 2 * popcount(q XOR k) of one query against one key.
// q: W contiguous words; k: W words `k_stride` apart (1 for row-major keys,
// `page` for the bit-plane page pools).
__device__ __forceinline__ int score(const uint32_t* q, const uint32_t* k,
                                     int k_stride, int W, int d) {
  int ham = 0;
#pragma unroll
  for (int w = 0; w < kMaxWords; ++w) {
    if (w < W) ham += __popc(q[w] ^ k[w * k_stride]);
  }
  return d - 2 * ham;
}

// Score level (bin index 0..d) of a binary score.
__device__ __forceinline__ int level(int s, int d) { return (s + d) >> 1; }

// Exact top-N threshold score from one row's (d+1)-bin level histogram:
// the largest level l with count(level >= l) >= min(nsel, total), as
// score 2l - d. Every tie at the threshold is kept. Serial over d+1 bins;
// one thread per row calls it.
__device__ __forceinline__ int threshold(const int* hist, int nsel, int d) {
  int total = 0;
  for (int l = 0; l <= d; ++l) total += hist[l];
  const int n_eff = nsel < total ? nsel : total;
  int cc = 0;
  int idx = 0;
  for (int l = d; l >= 0; --l) {
    cc += hist[l];
    if (cc >= n_eff) {
      idx = l;
      break;
    }
  }
  return 2 * idx - d;
}

// Lets `kernel` take `bytes` of dynamic shared memory (past the 48 KB a
// launch gets without asking).
template <typename K>
inline cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

}  // namespace had
