// Causal HAD prefill attention over a query chunk.
//
// Replaces: src/repro/kernels/binary_prefill_attention.py
//           prefill_attention (_prefill_kernel).
//
// GQA: query row b*H + h reads kv row b*Hk + h / G. The key axis is cut
// into splits of `split_tiles` 64-key tiles, fixed in LOGICAL key
// positions (split s holds keys [s * 64 * split_tiles, ...)), and the grid
// is (query-head row, 64-query tile, split), from shapes alone: no length
// is read back to the host. Validity is positional: key < kv_length and
// (causal) key <= q_offset + i. A CTA whose query tile is padding (at or
// past q_length -- the idle slots that ride along in every prefill step)
// or whose split starts at or past the last key its tile can see exits at
// once. Each live CTA loads its split's keys into shared memory once, as
// bit-planes. Three launches on the stream:
//   1. hist     XOR+popcount scores of the split's valid (query, key) pairs
//               -> one (d+1)-bin level histogram per query row (shared-
//               memory integer atomics), written to scratch as uint16
//               counts with plain stores (no global atomics, no memset);
//   2. partial  the tile's histograms summed over the splits it can see
//               (integers: exact in any order) -> the exact top-N threshold
//               per query; then per 64-key tile of the split the scores
//               again, E = exp(scale * (s - d)) of kept keys (0 elsewhere)
//               staged in shared memory with the V tile, and E.V on the
//               tensor cores (mma.sync): bf16 V as m16n8k16 with E split
//               into three bf16 terms e0 + e1 + e2 (the 24 bits of a
//               float32), float32 V as 3xTF32 m16n8k8 (E_hi.V_hi +
//               E_lo.V_hi + E_hi.V_lo), float32 accumulation; the
//               denominator sum(E) is the same product against a column of
//               ones. A tile whose E is all 0 is skipped (it would add
//               exact zeros). The split's num[64, Dv] and den[64] go to
//               scratch.
//   3. combine  one thread per output: the splits' sums added in ascending
//               split order from 0.f, then num / max(den, 1e-30); rows at
//               or past q_length are zeros.
// A query's result so depends only on its own kept keys at their logical
// positions: not on T, the chunk size, where the query sits in its tile,
// or the other rows and slots of the call. Dense prefill (over the cache
// rows) and paged prefill (over gathered pages) give the same bits, and so
// do ragged and sequential serving.
//
// What bounds it on an H100: the function's floor is its bytes (the live
// queries' words, the valid keys' words and the kept keys' V rows, each
// read once, and the output); the integer scores on the CUDA cores and E.V
// on the tensor cores (three products per 16 keys for bf16, per 8 for
// TF32) take less at their peak rates. The kernel runs far above that
// floor at serving shapes. Launch 2 takes most of its time: each CTA
// scores, stages E and V and runs the mma for its split's tiles one after
// another, each valid pair is scored twice (launches 1 and 2, some 20
// instructions a pair), and a tile's V load waits on its E.
#include "had_common.cuh"

#include <limits.h>

namespace {

constexpr int kThreads = 256;  // 8 warps: 4 of 16 query rows x 2 halves of Dv
constexpr int kBQ = 64;        // queries per CTA
constexpr int kTK = 64;        // keys per tile (the logical 64-key tile)

// A (row, query tile)'s live queries [0, qlive) and the keys [0, kend) any
// of them can see; qlive = kend = 0 for a tile of padding.
struct TileSpan {
  int qlive, kend;
};

__device__ __forceinline__ TileSpan tile_span(const int* __restrict__ kv_length,
                                              const int* __restrict__ q_offset,
                                              const int* __restrict__ q_length,
                                              int row, int q0, int S, int T,
                                              int causal) {
  const int qlive = max(0, min(min(q_length[row], S) - q0, kBQ));
  if (qlive == 0) return {0, 0};
  int kend = min(kv_length[row], T);
  if (causal) kend = min(kend, q_offset[row] + q0 + qlive);
  return {qlive, max(kend, 0)};
}

// Scratch, per (row, query tile, split) block b = (row * nQ + qt) * nS + sp:
//   hist [n_blocks, kBQ, d+1] uint16 || part [n_blocks, kBQ*Dv + kBQ] float
// (numerators [kBQ, Dv], then denominators [kBQ]).
struct Scratch {
  uint16_t* hist;
  float* part;

  __host__ __device__ Scratch(void* base, size_t n_blocks, int d) {
    hist = static_cast<uint16_t*>(base);
    part = reinterpret_cast<float*>(hist + n_blocks * kBQ * (d + 1));
  }
};

__device__ __forceinline__ int kv_row(int row, int group, int Hk) {
  const int H = Hk * group;
  return (row / H) * Hk + (row % H) / group;
}

// A split's keys [j0, j0 + split_keys) of a kv row as bit-planes
// kp[W, split_keys], loaded once; keys at or past `kend` are zeros.
__device__ __forceinline__ void load_key_planes(const uint32_t* __restrict__ k,
                                                int kvrow, int T, int W,
                                                int j0, int kend,
                                                int split_keys,
                                                uint32_t* kp) {
  for (int x = threadIdx.x; x < W * split_keys; x += kThreads) {
    const int w = x / split_keys;
    const int key = j0 + x - w * split_keys;
    kp[x] = key < kend ? k[((size_t)kvrow * T + key) * W + w] : 0u;
  }
}

__global__ void __launch_bounds__(kThreads)
prefill_hist_kernel(const uint32_t* __restrict__ q,  // [BH, S, W]
                    const uint32_t* __restrict__ k,  // [BHk, T, W]
                    const int* __restrict__ kv_length,
                    const int* __restrict__ q_offset,
                    const int* __restrict__ q_length, Scratch sc, int S,
                    int W, int T, int d, int group, int Hk, int causal,
                    int split_keys) {
  extern __shared__ int smem[];
  const int row = blockIdx.x;
  const int q0 = blockIdx.y * kBQ;
  const int j0 = blockIdx.z * split_keys;
  const TileSpan ts =
      tile_span(kv_length, q_offset, q_length, row, q0, S, T, causal);
  if (j0 >= ts.kend) return;
  const int j1 = min(j0 + split_keys, ts.kend);
  const int tid = threadIdx.x;
  const int kvrow = kv_row(row, group, Hk);
  const int qlim = q_offset[row] + q0;  // query qi sees keys <= qlim + qi
  uint32_t* qs = reinterpret_cast<uint32_t*>(smem);  // [kBQ, W]
  uint32_t* kp = qs + kBQ * W;                         // [W, split_keys]
  int* hist = reinterpret_cast<int*>(kp + W * split_keys);  // [kBQ, d+1]

  for (int x = tid; x < kBQ * W; x += kThreads) {
    const int qi = x / W;
    qs[x] = qi < ts.qlive ? q[((size_t)row * S + q0 + qi) * W + x % W] : 0u;
  }
  for (int x = tid; x < kBQ * (d + 1); x += kThreads) hist[x] = 0;
  load_key_planes(k, kvrow, T, W, j0, j1, split_keys, kp);
  __syncthreads();
  // thread: query qi (its words in registers) against every
  // (kThreads / kBQ)-th key; a warp's lanes hold 32 rows and read one key
  const int qi = tid % kBQ;
  if (qi < ts.qlive) {
    uint32_t qw[had::kMaxWords];
#pragma unroll
    for (int w = 0; w < had::kMaxWords; ++w)
      qw[w] = w < W ? qs[qi * W + w] : 0u;
    const int tend = causal ? min(j1, qlim + qi + 1) - j0 : j1 - j0;
    int* h = hist + qi * (d + 1);
    for (int t = tid / kBQ; t < tend; t += kThreads / kBQ) {
      int ham = 0;
#pragma unroll
      for (int w = 0; w < had::kMaxWords; ++w)
        if (w < W) ham += __popc(qw[w] ^ kp[w * split_keys + t]);
      atomicAdd(&h[had::level(d - 2 * ham, d)], 1);
    }
  }
  __syncthreads();
  const size_t b = ((size_t)row * gridDim.y + blockIdx.y) * gridDim.z +
                   blockIdx.z;
  uint16_t* out = sc.hist + b * kBQ * (d + 1);
  for (int x = tid; x < kBQ * (d + 1); x += kThreads)
    out[x] = (uint16_t)hist[x];
}

// ---------------------------------------------------------------------------
// E.V on the tensor cores. Fragments of mma.sync (g = lane / 4,
// c = lane % 4): A row-major [16, K], B "col" [K, 8], C [16, 8] with
// c0, c1 at (g, 2c + {0, 1}) and c2, c3 at (g + 8, 2c + {0, 1}).
// ---------------------------------------------------------------------------

__device__ __forceinline__ void mma_bf16(float (&acc)[4],
                                         const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(acc[0]), "+f"(acc[1]), "+f"(acc[2]), "+f"(acc[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void mma_tf32(float (&acc)[4],
                                         const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(acc[0]), "+f"(acc[1]), "+f"(acc[2]), "+f"(acc[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t bf16_bits(__nv_bfloat16 x) {
  return (uint32_t)__bfloat16_as_ushort(x);
}

// x = t0 + t1 + t2 exactly: each term the bf16 rounding of what is left.
__device__ __forceinline__ void split_bf16x3(float x, uint32_t (&t)[3]) {
  const __nv_bfloat16 h0 = __float2bfloat16_rn(x);
  float r = x - __bfloat162float(h0);
  const __nv_bfloat16 h1 = __float2bfloat16_rn(r);
  r -= __bfloat162float(h1);
  t[0] = bf16_bits(h0);
  t[1] = bf16_bits(h1);
  t[2] = bf16_bits(__float2bfloat16_rn(r));
}

// Register i of the three A fragments from the pair (lo, hi) of E.
__device__ __forceinline__ void a_pair_bf16x3(float2 e, uint32_t (&a)[3][4],
                                              int i) {
  uint32_t lo[3], hi[3];
  split_bf16x3(e.x, lo);
  split_bf16x3(e.y, hi);
#pragma unroll
  for (int j = 0; j < 3; ++j) a[j][i] = lo[j] | hi[j] << 16;
}

__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = to_tf32(x);
  lo = to_tf32(x - __uint_as_float(hi));
}

template <typename VT>
struct EV;

// bf16 V: three m16n8k16 products a 16-key step, smallest term first.
template <>
struct EV<__nv_bfloat16> {
  static constexpr int kEStride = kTK + 8;  // float2 A loads hit 32 banks

  template <int DV>
  __device__ static void tile(const float* es, const __nv_bfloat16* vs,
                              float (&acc)[DV / 16][4], float (&dacc)[4],
                              int wm, int wn, int g, int c) {
    constexpr int kVS = DV + 8;
    const unsigned short* vh = reinterpret_cast<const unsigned short*>(vs);
    const float* e0 = es + (wm * 16 + g) * kEStride + 2 * c;
    const float* e1 = e0 + 8 * kEStride;
    const uint32_t ones = g == 0 ? 0x3F803F80u : 0u;  // B column 0 = 1.0
#pragma unroll
    for (int ks = 0; ks < kTK; ks += 16) {
      uint32_t a[3][4];
      a_pair_bf16x3(*reinterpret_cast<const float2*>(e0 + ks), a, 0);
      a_pair_bf16x3(*reinterpret_cast<const float2*>(e1 + ks), a, 1);
      a_pair_bf16x3(*reinterpret_cast<const float2*>(e0 + ks + 8), a, 2);
      a_pair_bf16x3(*reinterpret_cast<const float2*>(e1 + ks + 8), a, 3);
      const int kr = ks + 2 * c;
#pragma unroll
      for (int nb = 0; nb < DV / 16; ++nb) {
        const int n = wn * (DV / 2) + nb * 8 + g;
        const uint32_t b0 =
            vh[kr * kVS + n] | (uint32_t)vh[(kr + 1) * kVS + n] << 16;
        const uint32_t b1 =
            vh[(kr + 8) * kVS + n] | (uint32_t)vh[(kr + 9) * kVS + n] << 16;
        mma_bf16(acc[nb], a[2], b0, b1);
        mma_bf16(acc[nb], a[1], b0, b1);
        mma_bf16(acc[nb], a[0], b0, b1);
      }
      if (wn == 0) {
        mma_bf16(dacc, a[2], ones, ones);
        mma_bf16(dacc, a[1], ones, ones);
        mma_bf16(dacc, a[0], ones, ones);
      }
    }
  }
};

// float32 V: 3xTF32 m16n8k8 a 8-key step, small products first.
template <>
struct EV<float> {
  static constexpr int kEStride = kTK + 4;  // scalar A loads hit 32 banks

  template <int DV>
  __device__ static void tile(const float* es, const float* vs,
                              float (&acc)[DV / 16][4], float (&dacc)[4],
                              int wm, int wn, int g, int c) {
    constexpr int kVS = DV + 8;
    const float* e0 = es + (wm * 16 + g) * kEStride + c;
    const float* e1 = e0 + 8 * kEStride;
    const uint32_t one = g == 0 ? 0x3F800000u : 0u;  // B column 0 = 1.0
#pragma unroll
    for (int ks = 0; ks < kTK; ks += 8) {
      uint32_t ah[4], al[4];
      split_tf32(e0[ks], ah[0], al[0]);
      split_tf32(e1[ks], ah[1], al[1]);
      split_tf32(e0[ks + 4], ah[2], al[2]);
      split_tf32(e1[ks + 4], ah[3], al[3]);
#pragma unroll
      for (int nb = 0; nb < DV / 16; ++nb) {
        const int n = wn * (DV / 2) + nb * 8 + g;
        uint32_t bh0, bl0, bh1, bl1;
        split_tf32(vs[(ks + c) * kVS + n], bh0, bl0);
        split_tf32(vs[(ks + c + 4) * kVS + n], bh1, bl1);
        mma_tf32(acc[nb], al, bh0, bh1);
        mma_tf32(acc[nb], ah, bl0, bl1);
        mma_tf32(acc[nb], ah, bh0, bh1);
      }
      if (wn == 0) {
        mma_tf32(dacc, al, one, one);
        mma_tf32(dacc, ah, one, one);
      }
    }
  }
};

// Bytes of dynamic shared memory prefill_partial_kernel<VT, DV> needs.
template <typename VT, int DV>
size_t partial_smem_bytes(int W, int d, int split_keys) {
  const size_t hist = sizeof(int) * (size_t)kBQ * (d + 1);
  const size_t tiles = sizeof(float) * (size_t)kBQ * EV<VT>::kEStride +
                       sizeof(VT) * (size_t)kTK * (DV + 8);
  return sizeof(int) * ((size_t)(kBQ + split_keys) * W + kBQ) +
         (hist > tiles ? hist : tiles);
}

template <typename VT, int DV>
__global__ void __launch_bounds__(kThreads)
prefill_partial_kernel(const uint32_t* __restrict__ q,  // [BH, S, W]
                       const uint32_t* __restrict__ k,  // [BHk, T, W]
                       const VT* __restrict__ v,        // [BHk, T, DV]
                       const int* __restrict__ kv_length,
                       const int* __restrict__ q_offset,
                       const int* __restrict__ q_length, Scratch sc, int S,
                       int W, int T, int d, int group, int Hk, int nsel,
                       float scale, int causal, int split_keys) {
  constexpr int kES = EV<VT>::kEStride;
  constexpr int kVS = DV + 8;
  constexpr int kChunks = DV * (int)sizeof(VT) / 16;  // 16 B per V row
  extern __shared__ int smem[];
  const int row = blockIdx.x;
  const int q0 = blockIdx.y * kBQ;
  const int j0 = blockIdx.z * split_keys;
  const TileSpan ts =
      tile_span(kv_length, q_offset, q_length, row, q0, S, T, causal);
  if (j0 >= ts.kend) return;
  const int j1 = min(j0 + split_keys, ts.kend);
  const int tid = threadIdx.x;
  const int kvrow = kv_row(row, group, Hk);
  const int qlim = q_offset[row] + q0;
  uint32_t* qs = reinterpret_cast<uint32_t*>(smem);  // [kBQ, W]
  uint32_t* kp = qs + kBQ * W;                         // [W, split_keys]
  int* thr = reinterpret_cast<int*>(kp + W * split_keys);  // [kBQ]
  int* hist = thr + kBQ;                // [kBQ, d+1], until thresholds
  float* es = reinterpret_cast<float*>(hist);         // [kBQ, kES]
  VT* vs = reinterpret_cast<VT*>(es + kBQ * kES);     // [kTK, kVS]

  for (int x = tid; x < kBQ * W; x += kThreads) {
    const int qi = x / W;
    qs[x] = qi < ts.qlive ? q[((size_t)row * S + q0 + qi) * W + x % W] : 0u;
  }
  load_key_planes(k, kvrow, T, W, j0, j1, split_keys, kp);
  // the tile's histograms over the splits it can see, 8 counts a load
  {
    const int n_vis = (ts.kend + split_keys - 1) / split_keys;
    const int n_vec = kBQ * (d + 1) / 8;
    const size_t b0 = ((size_t)row * gridDim.y + blockIdx.y) * gridDim.z;
    const uint4* hv = reinterpret_cast<const uint4*>(
        sc.hist + b0 * kBQ * (d + 1));
    for (int x = tid; x < n_vec; x += kThreads) {
      int cnt[8] = {0, 0, 0, 0, 0, 0, 0, 0};
      for (int sp = 0; sp < n_vis; ++sp) {
        const uint4 u = hv[(size_t)sp * n_vec + x];
        const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          cnt[2 * i] += (int)(w[i] & 0xffffu);
          cnt[2 * i + 1] += (int)(w[i] >> 16);
        }
      }
#pragma unroll
      for (int i = 0; i < 8; ++i) hist[8 * x + i] = cnt[i];
    }
  }
  __syncthreads();
  if (tid < kBQ)
    thr[tid] = tid < ts.qlive ? had::threshold(hist + tid * (d + 1), nsel, d)
                              : INT_MAX;

  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane / 4;
  const int c = lane % 4;
  const int wm = warp % 4;  // query rows wm*16 .. +16
  const int wn = warp / 4;  // V columns wn*DV/2 .. +DV/2
  float acc[DV / 16][4];
  float dacc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int nb = 0; nb < DV / 16; ++nb)
    acc[nb][0] = acc[nb][1] = acc[nb][2] = acc[nb][3] = 0.f;

  for (int k0 = j0; k0 < j1; k0 += kTK) {
    __syncthreads();  // thresholds visible; previous tile fully consumed
    // thread: key t (its words in registers) against every
    // (kThreads / kTK)-th query row; a warp's lanes hold 32 keys of one row
    const int t = tid % kTK;
    const int key = k0 + t;
    uint32_t kw[had::kMaxWords];
#pragma unroll
    for (int w = 0; w < had::kMaxWords; ++w)
      kw[w] = w < W && key < j1 ? kp[w * split_keys + key - j0] : 0u;
    int any = 0;
    for (int qi = tid / kTK; qi < kBQ; qi += kThreads / kTK) {
      float e = 0.f;
      if (qi < ts.qlive && key < j1 && (!causal || key <= qlim + qi)) {
        int ham = 0;
#pragma unroll
        for (int w = 0; w < had::kMaxWords; ++w)
          if (w < W) ham += __popc(qs[qi * W + w] ^ kw[w]);
        const int s = d - 2 * ham;
        if (s >= thr[qi]) e = expf(scale * (float)(s - d));
      }
      es[qi * kES + t] = e;
      any |= e != 0.f;
    }
    if (!__syncthreads_or(any)) continue;  // all-zero E adds exact zeros
    for (int x = tid; x < kTK * kChunks; x += kThreads) {
      const int key = x / kChunks;
      const int ch = x - key * kChunks;
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (k0 + key < j1)
        val = reinterpret_cast<const uint4*>(
            v + ((size_t)kvrow * T + k0 + key) * DV)[ch];
      reinterpret_cast<uint4*>(vs + key * kVS)[ch] = val;
    }
    __syncthreads();
    EV<VT>::template tile<DV>(es, vs, acc, dacc, wm, wn, g, c);
  }

  const size_t b = ((size_t)row * gridDim.y + blockIdx.y) * gridDim.z +
                   blockIdx.z;
  float* num = sc.part + b * (kBQ * DV + kBQ);
  const int r0 = wm * 16 + g;
#pragma unroll
  for (int nb = 0; nb < DV / 16; ++nb) {
    const int col = wn * (DV / 2) + nb * 8 + 2 * c;
    *reinterpret_cast<float2*>(num + r0 * DV + col) =
        make_float2(acc[nb][0], acc[nb][1]);
    *reinterpret_cast<float2*>(num + (r0 + 8) * DV + col) =
        make_float2(acc[nb][2], acc[nb][3]);
  }
  if (wn == 0 && c == 0) {  // column 0 of the ones product: sum(E)
    num[kBQ * DV + r0] = dacc[0];
    num[kBQ * DV + r0 + 8] = dacc[2];
  }
}

__global__ void __launch_bounds__(kThreads)
prefill_combine_kernel(const int* __restrict__ kv_length,
                       const int* __restrict__ q_offset,
                       const int* __restrict__ q_length, Scratch sc,
                       float* __restrict__ out,  // [BH, S, Dv]
                       int BH, int S, int Dv, int T, int nQ, int nS,
                       int causal, int split_keys) {
  const size_t x = (size_t)blockIdx.x * kThreads + threadIdx.x;
  if (x >= (size_t)BH * S * Dv) return;
  const int c = (int)(x % Dv);
  const int s = (int)((x / Dv) % S);
  const int row = (int)(x / ((size_t)S * Dv));
  const int qt = s / kBQ;
  const int qi = s - qt * kBQ;
  const TileSpan ts =
      tile_span(kv_length, q_offset, q_length, row, qt * kBQ, S, T, causal);
  float r = 0.f;
  if (qi < ts.qlive) {
    const int n_vis = (ts.kend + split_keys - 1) / split_keys;
    const size_t blk = (size_t)kBQ * Dv + kBQ;
    const float* p = sc.part + ((size_t)row * nQ + qt) * nS * blk;
    float num = 0.f;
    float den = 0.f;
    for (int sp = 0; sp < n_vis; ++sp) {
      num += p[sp * blk + (size_t)qi * Dv + c];
      den += p[sp * blk + (size_t)kBQ * Dv + qi];
    }
    r = num / fmaxf(den, 1e-30f);
  }
  out[x] = r;
}

struct Args {
  const uint32_t* q;
  const uint32_t* k;
  const void* v;
  const int* kv_length;
  const int* q_offset;
  const int* q_length;
  float* out;
  void* scratch;
  int BH, S, W, T, d, group, Hk, nsel, causal, split_tiles;
  float scale;
};

template <typename VT, int DV>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  const int split_keys = a.split_tiles * kTK;
  const int nQ = (a.S + kBQ - 1) / kBQ;
  const int nS = (a.T + split_keys - 1) / split_keys;
  const Scratch sc(a.scratch, (size_t)a.BH * nQ * nS, a.d);
  cudaError_t err;
  if (nS > 0) {
    const size_t smem1 =
        sizeof(int) * ((size_t)(kBQ + split_keys) * a.W +
                       (size_t)kBQ * (a.d + 1));
    const size_t smem2 = partial_smem_bytes<VT, DV>(a.W, a.d, split_keys);
    if ((err = had::allow_smem(prefill_hist_kernel, smem1)) != cudaSuccess ||
        (err = had::allow_smem(prefill_partial_kernel<VT, DV>, smem2)) !=
            cudaSuccess)
      return err;
    const dim3 grid(a.BH, nQ, nS);
    prefill_hist_kernel<<<grid, kThreads, smem1, stream>>>(
        a.q, a.k, a.kv_length, a.q_offset, a.q_length, sc, a.S, a.W, a.T,
        a.d, a.group, a.Hk, a.causal, split_keys);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    prefill_partial_kernel<VT, DV><<<grid, kThreads, smem2, stream>>>(
        a.q, a.k, static_cast<const VT*>(a.v), a.kv_length, a.q_offset,
        a.q_length, sc, a.S, a.W, a.T, a.d, a.group, a.Hk, a.nsel, a.scale,
        a.causal, split_keys);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  const size_t n_out = (size_t)a.BH * a.S * DV;
  const unsigned n_ctas = (unsigned)((n_out + kThreads - 1) / kThreads);
  prefill_combine_kernel<<<n_ctas, kThreads, 0, stream>>>(
      a.kv_length, a.q_offset, a.q_length, sc, a.out, a.BH, a.S, DV, a.T, nQ,
      nS, a.causal, split_keys);
  return cudaGetLastError();
}

template <typename VT>
cudaError_t dispatch_dv(int Dv, const Args& a, cudaStream_t stream) {
  switch (Dv) {
    case 16:
      return launch<VT, 16>(a, stream);
    case 32:
      return launch<VT, 32>(a, stream);
    case 64:
      return launch<VT, 64>(a, stream);
    case 80:  // hubert-xlarge's heads
      return launch<VT, 80>(a, stream);
    case 128:
      return launch<VT, 128>(a, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// scratch: int32 words, as many as the wrapper's split_plan gives:
// n_blocks * kBQ * (d+1) uint16 histogram counts, then n_blocks *
// (kBQ*Dv + kBQ) floats, n_blocks = BH * ceil(S/64) * ceil(T/(64*split_tiles)).
// v must be 16-byte aligned.
extern "C" int had_prefill_attention(
    const void* q, const void* k, const void* v, const void* kv_length,
    const void* q_offset, const void* q_length, void* out, void* scratch,
    int BH, int S, int W, int T, int Dv, int d, int group, int Hk, int nsel,
    float scale, int causal, int split_tiles, int v_bf16, void* stream) {
  if (W < 1 || W > had::kMaxWords || d < 1 || d > 32 * W || group < 1 ||
      Hk < 1 || BH % (group * Hk) != 0 || T < 0 || split_tiles < 1 ||
      split_tiles * kTK > 65535 ||  // counts fit uint16
      (S + kBQ - 1) / kBQ > 65535 ||
      ((long long)T + split_tiles * kTK - 1) / (split_tiles * kTK) > 65535 ||
      reinterpret_cast<uintptr_t>(v) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  if (BH == 0 || S == 0) return (int)cudaSuccess;
  const Args a{static_cast<const uint32_t*>(q),
               static_cast<const uint32_t*>(k),
               v,
               static_cast<const int*>(kv_length),
               static_cast<const int*>(q_offset),
               static_cast<const int*>(q_length),
               static_cast<float*>(out),
               scratch,
               BH, S, W, T, d, group, Hk, nsel, causal, split_tiles,
               scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(v_bf16 ? dispatch_dv<__nv_bfloat16>(Dv, a, s)
                      : dispatch_dv<float>(Dv, a, s));
}
