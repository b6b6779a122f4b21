// HAD decode attention over the paged KV cache, one new token per slot.
//
// Replaces: src/repro/kernels/binary_paged_decode_attention.py
//           paged_decode_attention (_paged_decode_kernel).
//
// One CTA per (slot, kv-head) row with its G grouped queries. The CTA reads
// the row's block table and per-block valid counts into shared memory and
// walks the listed pages in place (no gather):
//   pass 0: XOR+popcount scores of every valid key -> per-query (d+1)-bin
//           level histogram (shared-memory integer atomics) and a per-page
//           max score; then the exact top-N threshold per query.
//   pass 1: pages whose max score misses every query's threshold are
//           skipped (no V bytes read; their keys would all be masked).
//           For live pages, exp(scale * (s - d)) of kept keys is staged in
//           shared memory with the page's V, and each thread that owns an
//           output (g, dv) -- or a denominator g -- sums the tile in key
//           order. No float atomics: the result depends only on the row's
//           own inputs, in a fixed order.
// Blocks with count 0 cost nothing beyond the count test.
//
// What bounds it on an H100: bytes. It reads W*4 bytes of K per valid key
// and Dv*2 bytes of V (bf16) per kept key; the arithmetic is a few integer
// ops per key and 2*Dv flops per kept key. At full width the grid is only
// B*Hk CTAs (12 at 4 slots x 3 kv heads) on 132 SMs, so it is latency
// bound far below the memory rate. Splitting the key axis across CTAs
// (a second reduction pass for num/den and the histograms) is the first
// redesign this kernel needs.
#include "had_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kPagesPerTile = 4;

template <typename VT>
__global__ void __launch_bounds__(kThreads)
paged_decode_kernel(const uint32_t* __restrict__ q,       // [R, G, W]
                    const uint32_t* __restrict__ k_pool,  // [P, Hk, W, page]
                    const VT* __restrict__ v_pool,        // [P, Hk, page, Dv]
                    const int* __restrict__ tables,       // [R, nb]
                    const int* __restrict__ counts,       // [R, nb]
                    float* __restrict__ out,              // [R, G, Dv]
                    int G, int W, int page, int Dv, int nb, int Hk,
                    int n_pages, int d, int nsel, float scale) {
  extern __shared__ int smem[];
  const int row = blockIdx.x;
  const int hk = row % Hk;
  const int tid = threadIdx.x;
  const int tile = kPagesPerTile * page;

  int* hist = smem;                                  // [G, d+1]
  int* thr = hist + G * (d + 1);                     // [G]
  int* tbl = thr + G;                                // [nb]
  int* cnt = tbl + nb;                               // [nb]
  int* blkmax = cnt + nb;                            // [nb]
  uint32_t* qs = reinterpret_cast<uint32_t*>(blkmax + nb);   // [G, W]
  float* num = reinterpret_cast<float*>(qs + G * W);         // [G, Dv]
  float* den = num + G * Dv;                                 // [G]
  float* es = den + G;                                       // [G, tile]
  float* vs = es + G * tile;                                 // [tile, Dv]

  for (int x = tid; x < G * (d + 1); x += kThreads) hist[x] = 0;
  for (int i = tid; i < nb; i += kThreads) {
    const int p = tables[(size_t)row * nb + i];
    const int c = counts[(size_t)row * nb + i];
    const bool ok = p >= 0 && p < n_pages;
    tbl[i] = ok ? p : 0;
    cnt[i] = ok ? min(max(c, 0), page) : 0;
    blkmax[i] = -d - 2;
  }
  for (int x = tid; x < G * W; x += kThreads) qs[x] = q[(size_t)row * G * W + x];
  for (int x = tid; x < G * Dv; x += kThreads) num[x] = 0.f;
  if (tid < G) den[tid] = 0.f;
  __syncthreads();

  // pass 0: histograms and per-page max scores
  const int n_keys = nb * page;
  for (int j = tid; j < n_keys; j += kThreads) {
    const int i = j / page;
    const int t = j - i * page;
    if (t >= cnt[i]) continue;
    const uint32_t* kp = k_pool + ((size_t)tbl[i] * Hk + hk) * W * page + t;
    int bmax = -d - 2;
    for (int g = 0; g < G; ++g) {
      const int s = had::score(qs + g * W, kp, page, W, d);
      atomicAdd(&hist[g * (d + 1) + had::level(s, d)], 1);
      bmax = max(bmax, s);
    }
    atomicMax(&blkmax[i], bmax);
  }
  __syncthreads();
  if (tid < G) thr[tid] = had::threshold(hist + tid * (d + 1), nsel, d);
  __syncthreads();
  int min_thr = thr[0];
  for (int g = 1; g < G; ++g) min_thr = min(min_thr, thr[g]);

  // pass 1: masked exp accumulation over live pages, in key order
  for (int i0 = 0; i0 < nb; i0 += kPagesPerTile) {
    bool live = false;
    for (int i = i0; i < min(i0 + kPagesPerTile, nb); ++i)
      live |= cnt[i] > 0 && blkmax[i] >= min_thr;
    if (!live) continue;  // uniform: every thread reads the same smem
    for (int x = tid; x < tile; x += kThreads) {
      const int i = i0 + x / page;
      const int t = x % page;
      const bool ok = i < nb && t < cnt[i] && blkmax[i] >= min_thr;
      const uint32_t* kp =
          k_pool + ((size_t)tbl[ok ? i : 0] * Hk + hk) * W * page + t;
      for (int g = 0; g < G; ++g) {
        float e = 0.f;
        if (ok) {
          const int s = had::score(qs + g * W, kp, page, W, d);
          if (s >= thr[g]) e = expf(scale * (float)(s - d));
        }
        es[g * tile + x] = e;
      }
    }
    for (int x = tid; x < tile * Dv; x += kThreads) {
      const int key = x / Dv;
      const int c = x - key * Dv;
      const int i = i0 + key / page;
      const int t = key % page;
      float val = 0.f;
      if (i < nb && t < cnt[i] && blkmax[i] >= min_thr)
        val = had::to_float(
            v_pool[(((size_t)tbl[i] * Hk + hk) * page + t) * Dv + c]);
      vs[x] = val;
    }
    __syncthreads();
    for (int o = tid; o < G * Dv + G; o += kThreads) {
      if (o < G * Dv) {
        const int g = o / Dv;
        const int c = o - g * Dv;
        const float* er = es + g * tile;
        float acc = 0.f;
        for (int key = 0; key < tile; ++key) {
          const float e = er[key];
          if (e != 0.f) acc += e * vs[key * Dv + c];
        }
        num[o] += acc;
      } else {
        const float* er = es + (o - G * Dv) * tile;
        float acc = 0.f;
        for (int key = 0; key < tile; ++key) acc += er[key];
        den[o - G * Dv] += acc;
      }
    }
    __syncthreads();
  }

  for (int o = tid; o < G * Dv; o += kThreads)
    out[(size_t)row * G * Dv + o] = num[o] / fmaxf(den[o / Dv], 1e-30f);
}

template <typename VT>
cudaError_t launch(const void* q, const void* k_pool, const void* v_pool,
                   const void* tables, const void* counts, void* out, int R,
                   int G, int W, int page, int Dv, int nb, int Hk, int n_pages,
                   int d, int nsel, float scale, cudaStream_t stream) {
  const int tile = kPagesPerTile * page;
  const size_t smem =
      sizeof(int) * ((size_t)G * (d + 1) + G + 3 * (size_t)nb + G * W) +
      sizeof(float) * ((size_t)G * Dv + G + (size_t)G * tile +
                       (size_t)tile * Dv);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        paged_decode_kernel<VT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return err;
  }
  paged_decode_kernel<VT><<<R, kThreads, smem, stream>>>(
      static_cast<const uint32_t*>(q), static_cast<const uint32_t*>(k_pool),
      static_cast<const VT*>(v_pool), static_cast<const int*>(tables),
      static_cast<const int*>(counts), static_cast<float*>(out), G, W, page,
      Dv, nb, Hk, n_pages, d, nsel, scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" int had_paged_decode_attention(
    const void* q, const void* k_pool, const void* v_pool, const void* tables,
    const void* counts, void* out, int R, int G, int W, int page, int Dv,
    int nb, int Hk, int n_pages, int d, int nsel, float scale, int v_bf16,
    void* stream) {
  if (W < 1 || W > had::kMaxWords || d < 1 || d > 32 * W || G < 1 ||
      page < 1 || Dv < 1 || nb < 1 || Hk < 1)
    return (int)cudaErrorInvalidValue;
  if (R == 0) return (int)cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err =
      v_bf16 ? launch<__nv_bfloat16>(q, k_pool, v_pool, tables, counts, out,
                                     R, G, W, page, Dv, nb, Hk, n_pages, d,
                                     nsel, scale, s)
             : launch<float>(q, k_pool, v_pool, tables, counts, out, R, G, W,
                             page, Dv, nb, Hk, n_pages, d, nsel, scale, s);
  return (int)err;
}
