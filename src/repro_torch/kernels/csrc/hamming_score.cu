// Tiled binary score matrix s[i, j] = d - 2 * ham(q_i, k_j) from packed
// 32-bit words, batched.
//
// Replaces: src/repro/kernels/hamming_score.py
//           hamming_score (_hamming_score_kernel, _score_tile,
//           _unpack_pm1_int8).
//
// One CTA per (batch, 64-query, 64-key) output tile; the query and key
// words of the tile are staged in shared memory and each thread writes 16
// outputs of one column, so a warp's stores are 32 consecutive ints. The
// ragged edge is masked here: any M and N, nothing padded. Two methods, as
// in the Pallas kernel, give the same integers:
//   xor  -- XOR + __popc over the W words of a (query, key) pair;
//   int8 -- the tile's bits unpacked to +-1 int8 in shared memory and
//           accumulated four at a time with __dp4a into int32. Only the
//           first d bits are unpacked; bits past d become 0 (a zero tail
//           bit unpacked to -1 would add +1 per tail bit to every score).
//
// What bounds it on an H100: bytes -- the [M, N] int32 output is 4 bytes
// per pair against W*4 bytes per query or key row read once, and the
// integer work per pair is a few operations (xor) or d/4 dp4a (int8).
#include "had_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kBM = 64;  // queries per tile
constexpr int kBN = 64;  // keys per tile
constexpr int kRowsPerPass = kThreads / kBN;
// int8 rows: 8 ints (32 int8) per packed word, +1 int so lanes reading
// different key rows hit different banks
constexpr int kPitch8 = 8 * had::kMaxWords + 1;

__device__ __forceinline__ int unpack4(uint32_t word, int b0, int d) {
  // int8 lanes of the four bits b0..b0+3 of `word` (b0 a multiple of 4):
  // +1 for a set bit, -1 for a clear one, 0 past d
  int packed = 0;
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const int b = b0 + u;
    const int val = b < d ? (((word >> (b & 31)) & 1u) ? 1 : -1) : 0;
    packed |= (val & 0xff) << (8 * u);
  }
  return packed;
}

__global__ void __launch_bounds__(kThreads)
hamming_score_kernel(const uint32_t* __restrict__ q,  // [Bt, M, W]
                     const uint32_t* __restrict__ k,  // [Bt, N, W]
                     int* __restrict__ out,           // [Bt, M, N]
                     int M, int N, int W, int d, int int8) {
  __shared__ int qs[kBM * kPitch8];
  __shared__ int ks[kBN * kPitch8];
  const int tid = threadIdx.x;
  const int bt = blockIdx.z;
  const int m0 = blockIdx.y * kBM;
  const int n0 = blockIdx.x * kBN;
  const uint32_t* qb = q + ((size_t)bt * M + m0) * W;
  const uint32_t* kb = k + ((size_t)bt * N + n0) * W;
  const int c = tid % kBN;
  const int r0 = tid / kBN;
  int* ob = out + ((size_t)bt * M + m0) * N + n0;
  const bool col_ok = n0 + c < N;

  if (!int8) {
    // word pitch W | 1 (odd for W > 1): lanes of a warp read distinct banks
    const int pitch = W | 1;
    uint32_t* qw = reinterpret_cast<uint32_t*>(qs);
    uint32_t* kw = reinterpret_cast<uint32_t*>(ks);
    for (int x = tid; x < kBM * W; x += kThreads) {
      const int r = x / W;
      qw[r * pitch + x % W] = m0 + r < M ? qb[x] : 0u;
    }
    for (int x = tid; x < kBN * W; x += kThreads) {
      const int r = x / W;
      kw[r * pitch + x % W] = n0 + r < N ? kb[x] : 0u;
    }
    __syncthreads();
    for (int r = r0; r < kBM; r += kRowsPerPass) {
      if (m0 + r < M && col_ok)
        ob[(size_t)r * N + c] = had::score(qw + r * pitch, kw + c * pitch, 1,
                                           W, d);
    }
    return;
  }

  const int n4 = (d + 3) / 4;  // int8 quads that hold the first d bits
  for (int x = tid; x < kBM * n4; x += kThreads) {
    const int r = x / n4;
    const int c4 = x - r * n4;
    const uint32_t word = m0 + r < M ? qb[r * W + c4 / 8] : 0u;
    qs[r * kPitch8 + c4] = m0 + r < M ? unpack4(word, 4 * c4, d) : 0;
  }
  for (int x = tid; x < kBN * n4; x += kThreads) {
    const int r = x / n4;
    const int c4 = x - r * n4;
    const uint32_t word = n0 + r < N ? kb[r * W + c4 / 8] : 0u;
    ks[r * kPitch8 + c4] = n0 + r < N ? unpack4(word, 4 * c4, d) : 0;
  }
  __syncthreads();
  const int* kr = ks + c * kPitch8;
  for (int r = r0; r < kBM; r += kRowsPerPass) {
    const int* qr = qs + r * kPitch8;
    int acc = 0;
    for (int c4 = 0; c4 < n4; ++c4) acc = __dp4a(qr[c4], kr[c4], acc);
    if (m0 + r < M && col_ok) ob[(size_t)r * N + c] = acc;
  }
}

}  // namespace

extern "C" int had_hamming_score(const void* q, const void* k, void* out,
                                 int Bt, int M, int N, int W, int d, int int8,
                                 void* stream) {
  if (W < 1 || W > had::kMaxWords || d < 1 || d > 32 * W || Bt > 65535 ||
      (M + kBM - 1) / kBM > 65535)
    return (int)cudaErrorInvalidValue;
  if (Bt == 0 || M == 0 || N == 0) return (int)cudaSuccess;
  const dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM, Bt);
  hamming_score_kernel<<<grid, kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(q), static_cast<const uint32_t*>(k),
      static_cast<int*>(out), M, N, W, d, int8);
  return (int)cudaGetLastError();
}
