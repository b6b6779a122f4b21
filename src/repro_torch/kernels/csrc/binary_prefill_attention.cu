// Causal HAD prefill attention over a query chunk.
//
// Replaces: src/repro/kernels/binary_prefill_attention.py
//           prefill_attention (_prefill_kernel).
//
// One CTA per (query-head row, 64-query tile). GQA: query row b*H + h reads
// kv row b*Hk + h / G. Keys stream through shared memory in 64-key tiles:
//   pass 0: XOR+popcount scores of every valid (query, key) pair -> one
//           (d+1)-bin level histogram per query row in shared memory
//           (integer atomics; 65 ints a row at d = 64) -> exact top-N
//           threshold per row.
//   pass 1: scores recomputed; exp(scale * (s - d)) of kept keys is staged
//           in shared memory with the tile's V, and each thread that owns
//           output column dv for a set of rows sums the tile in key order.
//           No float atomics: a row's result depends only on its inputs.
// Validity is positional: key < kv_length and (causal) key <= q_offset + i.
// The loop stops at the last key any live query of the tile can see, so
// tiles wholly in the future are never touched. Query tiles at or past
// q_length -- the inactive slots that ride along in every prefill step --
// and rows past q_length inside a live tile are written as zeros, as the
// plain version does. The ragged edge is masked here; nothing is padded.
//
// What bounds it on an H100: at serving shapes the work is the pass-1
// accumulation, 2*Dv flops per kept (query, key) pair on the CUDA cores,
// plus a few integer ops per valid pair; the bytes (K words and V rows of
// one kv row, reused by G heads and every query tile from L2) are small.
// The design keeps scores and probabilities out of device memory and skips
// the V tile and its accumulation when no query keeps a key of it. A
// tensor-core (mma) formulation of the accumulation is later work.
#include "had_common.cuh"

#include <limits.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBQ = 64;  // queries per CTA
constexpr int kTK = 64;  // keys per shared-memory tile
constexpr int kEStride = kTK + 1;  // padded row: conflict-free column writes

template <typename VT, int DV>
__global__ void __launch_bounds__(kThreads)
prefill_kernel(const uint32_t* __restrict__ q,   // [BH, S, W]
               const uint32_t* __restrict__ k,   // [BHk, T, W]
               const VT* __restrict__ v,         // [BHk, T, DV]
               const int* __restrict__ kv_length,  // [BH]
               const int* __restrict__ q_offset,   // [BH]
               const int* __restrict__ q_length,   // [BH]
               float* __restrict__ out,          // [BH, S, DV]
               int S, int W, int T, int d, int group, int Hk, int nsel,
               float scale, int causal) {
  constexpr int kRowsPerPass = kThreads / DV;
  constexpr int kRowsPerThread = kBQ / kRowsPerPass;
  extern __shared__ int smem[];
  const int row = blockIdx.x;
  const int q0 = blockIdx.y * kBQ;
  const int tid = threadIdx.x;
  const int H = Hk * group;
  const int kvrow = (row / H) * Hk + (row % H) / group;
  const int nq = min(kBQ, S - q0);
  const int qlen = min(q_length[row], S);
  float* orow = out + ((size_t)row * S + q0) * DV;

  if (q0 >= qlen) {  // query tile wholly padding: zeros
    for (int x = tid; x < nq * DV; x += kThreads) orow[x] = 0.f;
    return;
  }
  const int qlive = min(qlen - q0, nq);
  const int qoff = q_offset[row];
  int kend = min(kv_length[row], T);
  if (causal) kend = min(kend, qoff + q0 + qlive);
  kend = max(kend, 0);

  uint32_t* qs = reinterpret_cast<uint32_t*>(smem);   // [kBQ, W]
  uint32_t* ks = qs + kBQ * W;                         // [kTK, W]
  int* thr = reinterpret_cast<int*>(ks + kTK * W);    // [kBQ]
  int* hist = thr + kBQ;                   // [kBQ, d+1]  (pass 0)
  float* es = reinterpret_cast<float*>(hist);  // [kBQ, kEStride] (pass 1)
  const int uni = max(kBQ * (d + 1), kBQ * kEStride);
  float* vs = reinterpret_cast<float*>(hist + uni);   // [kTK, DV]

  for (int x = tid; x < kBQ * W; x += kThreads) {
    const int qi = x / W;
    qs[x] = qi < qlive ? q[((size_t)row * S + q0 + qi) * W + x % W] : 0u;
  }
  for (int x = tid; x < kBQ * (d + 1); x += kThreads) hist[x] = 0;

  auto load_keys = [&](int k0) {
    for (int x = tid; x < kTK * W; x += kThreads) {
      const int key = k0 + x / W;
      ks[x] = key < kend ? k[((size_t)kvrow * T + key) * W + x % W] : 0u;
    }
  };
  auto pair_valid = [&](int qi, int key) {
    return qi < qlive && key < kend && (!causal || key <= qoff + q0 + qi);
  };

  // pass 0: per-row histograms
  for (int k0 = 0; k0 < kend; k0 += kTK) {
    __syncthreads();  // previous tile's readers are done with ks
    load_keys(k0);
    __syncthreads();
    for (int x = tid; x < kBQ * kTK; x += kThreads) {
      const int qi = x % kBQ;
      const int t = x / kBQ;
      if (!pair_valid(qi, k0 + t)) continue;
      const int s = had::score(qs + qi * W, ks + t * W, 1, W, d);
      atomicAdd(&hist[qi * (d + 1) + had::level(s, d)], 1);
    }
  }
  __syncthreads();
  if (tid < kBQ)
    thr[tid] = tid < qlive ? had::threshold(hist + tid * (d + 1), nsel, d)
                           : INT_MAX;

  // pass 1: masked exp accumulation, in key order per output
  const int c = tid % DV;
  const int r0 = tid / DV;
  float acc[kRowsPerThread];
  float den[kRowsPerThread];
#pragma unroll
  for (int j = 0; j < kRowsPerThread; ++j) acc[j] = den[j] = 0.f;

  for (int k0 = 0; k0 < kend; k0 += kTK) {
    __syncthreads();  // thresholds visible; previous tile fully consumed
    load_keys(k0);
    __syncthreads();
    int any = 0;
    for (int x = tid; x < kBQ * kTK; x += kThreads) {
      const int qi = x % kBQ;
      const int t = x / kBQ;
      float e = 0.f;
      if (pair_valid(qi, k0 + t)) {
        const int s = had::score(qs + qi * W, ks + t * W, 1, W, d);
        if (s >= thr[qi]) e = expf(scale * (float)(s - d));
      }
      es[qi * kEStride + t] = e;
      any |= e != 0.f;
    }
    if (!__syncthreads_or(any)) continue;
    for (int x = tid; x < kTK * DV; x += kThreads) {
      const int key = k0 + x / DV;
      vs[x] = key < kend
                  ? had::to_float(v[((size_t)kvrow * T + key) * DV + x % DV])
                  : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < kRowsPerThread; ++j) {
      const float* er = es + (r0 + j * kRowsPerPass) * kEStride;
      float a = 0.f, dd = 0.f;
      for (int t = 0; t < kTK; ++t) {
        const float e = er[t];
        if (e != 0.f) {
          a += e * vs[t * DV + c];
          dd += e;
        }
      }
      acc[j] += a;
      den[j] += dd;
    }
  }

#pragma unroll
  for (int j = 0; j < kRowsPerThread; ++j) {
    const int qi = r0 + j * kRowsPerPass;
    if (qi < nq)
      orow[(size_t)qi * DV + c] =
          qi < qlive ? acc[j] / fmaxf(den[j], 1e-30f) : 0.f;
  }
}

template <typename VT, int DV>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* kv_length, const void* q_offset,
                   const void* q_length, void* out, int BH, int S, int W,
                   int T, int d, int group, int Hk, int nsel, float scale,
                   int causal, cudaStream_t stream) {
  const int uni = kBQ * (d + 1) > kBQ * kEStride ? kBQ * (d + 1)
                                                   : kBQ * kEStride;
  const size_t smem = sizeof(uint32_t) * (size_t)(kBQ + kTK) * W +
                      sizeof(int) * (size_t)(kBQ + uni) +
                      sizeof(float) * (size_t)kTK * DV;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        prefill_kernel<VT, DV>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid(BH, (S + kBQ - 1) / kBQ);
  prefill_kernel<VT, DV><<<grid, kThreads, smem, stream>>>(
      static_cast<const uint32_t*>(q), static_cast<const uint32_t*>(k),
      static_cast<const VT*>(v), static_cast<const int*>(kv_length),
      static_cast<const int*>(q_offset), static_cast<const int*>(q_length),
      static_cast<float*>(out), S, W, T, d, group, Hk, nsel, scale, causal);
  return cudaGetLastError();
}

template <typename VT>
cudaError_t dispatch_dv(int Dv, const void* q, const void* k, const void* v,
                        const void* kv_length, const void* q_offset,
                        const void* q_length, void* out, int BH, int S, int W,
                        int T, int d, int group, int Hk, int nsel, float scale,
                        int causal, cudaStream_t stream) {
  switch (Dv) {
    case 16:
      return launch<VT, 16>(q, k, v, kv_length, q_offset, q_length, out, BH,
                            S, W, T, d, group, Hk, nsel, scale, causal,
                            stream);
    case 32:
      return launch<VT, 32>(q, k, v, kv_length, q_offset, q_length, out, BH,
                            S, W, T, d, group, Hk, nsel, scale, causal,
                            stream);
    case 64:
      return launch<VT, 64>(q, k, v, kv_length, q_offset, q_length, out, BH,
                            S, W, T, d, group, Hk, nsel, scale, causal,
                            stream);
    case 128:
      return launch<VT, 128>(q, k, v, kv_length, q_offset, q_length, out, BH,
                             S, W, T, d, group, Hk, nsel, scale, causal,
                             stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" int had_prefill_attention(
    const void* q, const void* k, const void* v, const void* kv_length,
    const void* q_offset, const void* q_length, void* out, int BH, int S,
    int W, int T, int Dv, int d, int group, int Hk, int nsel, float scale,
    int causal, int v_bf16, void* stream) {
  if (W < 1 || W > had::kMaxWords || d < 1 || d > 32 * W || group < 1 ||
      Hk < 1 || BH % (group * Hk) != 0)
    return (int)cudaErrorInvalidValue;
  if (BH == 0 || S == 0) return (int)cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err =
      v_bf16 ? dispatch_dv<__nv_bfloat16>(Dv, q, k, v, kv_length, q_offset,
                                          q_length, out, BH, S, W, T, d, group,
                                          Hk, nsel, scale, causal, s)
             : dispatch_dv<float>(Dv, q, k, v, kv_length, q_offset, q_length,
                                  out, BH, S, W, T, d, group, Hk, nsel, scale,
                                  causal, s);
  return (int)err;
}
