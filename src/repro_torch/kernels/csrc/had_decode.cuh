// Top-N HAD decode of (slot, kv-head) rows with the key axis split across
// CTAs: the device code and the launch shared by the paged decode kernel
// (K2, binary_paged_decode_attention.cu) and the contiguous-cache decode
// kernel (K4, binary_decode_attention.cu). A row's G grouped queries attend
// positions [0, n_pos); where its keys live is hidden behind a `Src`:
//
//   int n_pos                           logical positions of every row
//   int split_tiles                     tiles of kTileKeys positions a split
//   int smem_words()                    shared words keys() may use
//   Keys keys(int row, int j0, int j1, int* smem)
//                                       the row's keys for positions
//                                       [j0, j1); may stage state (a page
//                                       table) in smem, which the first
//                                       barrier of the caller publishes
//
// and the `Keys` it returns:
//
//   bool valid(int j)            position j holds a valid key
//   const uint32_t* k(int j)     word 0 of key j; word w is k_stride words on
//   const VT* v(int j)           the V row of key j
//
// Positions are LOGICAL: a paged row's position i * page + t is offset t of
// its i-th listed block, a contiguous row's position j is cache slot j.
//
// The key axis is cut into splits of `split_tiles` tiles of kTileKeys
// positions, fixed in logical positions: a split's bounds depend on no
// length, page size or table length, so every tile lies in one split and
// the grid (R, S), S = ceil(n_pos / (kTileKeys * split_tiles)), comes from
// shapes alone (no host sync). Three launches on the stream:
//   split_scores     one CTA per (row, split): XOR+popcount of the split's
//                    valid keys -> the split's (d+1)-bin level histogram per
//                    query and each of its tiles' max score, plain stores
//                    into scratch (no global atomics, no memset);
//   split_tile_sums  one CTA per (row, split): the row's S histograms summed
//                    (integers: exact in any order), the exact top-N
//                    thresholds, then for each live tile of the split (its
//                    max reaches the least threshold) exp(scale * (s - d))
//                    of the kept keys and the V rows of the keys some query
//                    keeps (no other V byte is read) staged in shared
//                    memory, and each tile's numerator and denominator sums,
//                    in key order, written to scratch;
//   split_combine    one thread per output: the live tiles' sums added in
//                    ascending tile order from 0.f, then num / max(den,
//                    1e-30).
//
// The float result therefore depends only on the kept keys' (score, V) at
// each logical position, never on the page size, the table length, the
// cache length, the skipped tiles or the split size: a dense row (K4) and a
// paged row (K2) holding the same tokens in the same logical order give
// bit-identical outputs, and so does a compacted page table whose listed
// pages hold every resident page in logical order followed by count-0
// entries. Any page size works.
#pragma once

#include "had_common.cuh"

namespace had {

constexpr int kDecodeThreads = 256;
constexpr int kTileKeys = 64;  // logical key positions per tile

// Scratch (int words, then float words), per row:
//   hist [S, G, d+1] | tmax [n_tiles] | min_thr [1] || part [n_tiles, G*Dv+G]
struct Scratch {
  int* hist;
  int* tmax;
  int* min_thr;
  float* part;
  int hist_row, n_tiles, part_row;

  __host__ __device__ Scratch(void* base, int R, int S, int G, int Dv, int d,
                              int n_tiles_)
      : n_tiles(n_tiles_) {
    hist_row = S * G * (d + 1);
    part_row = n_tiles * (G * Dv + G);
    hist = static_cast<int*>(base);
    tmax = hist + (size_t)R * hist_row;
    min_thr = tmax + (size_t)R * n_tiles;
    part = reinterpret_cast<float*>(min_thr + R);
  }
};

// Bytes of dynamic shared memory split_scores needs.
inline size_t split_scores_smem_bytes(int G, int W, int d, int split_tiles) {
  return sizeof(int) * ((size_t)G * (d + 1) + split_tiles + (size_t)G * W);
}

// Bytes of dynamic shared memory split_tile_sums needs.
inline size_t split_tile_sums_smem_bytes(int G, int W, int Dv, int d) {
  return sizeof(int) * ((size_t)G * (d + 1) + G + kTileKeys + (size_t)G * W) +
         sizeof(float) * ((size_t)G * kTileKeys + (size_t)kTileKeys * Dv);
}

// Launch 1's work in one CTA of kDecodeThreads threads: the histogram
// hist_out[G, d+1] of the split's valid keys and the max score of each of
// its tiles, to tmax_out[tile] (the row's [n_tiles]; -d-2 for a tile with
// no valid key).
template <typename Keys>
__device__ void split_scores(const Keys& keys, int n_pos, int split,
                             int split_tiles, const uint32_t* __restrict__ q,
                             int* __restrict__ hist_out,
                             int* __restrict__ tmax_out, int G, int W, int d,
                             int* smem) {
  const int tid = threadIdx.x;
  const int t0 = split * split_tiles;
  const int j0 = t0 * kTileKeys;
  const int j1 = min(n_pos, j0 + split_tiles * kTileKeys);
  const int nt = (j1 - j0 + kTileKeys - 1) / kTileKeys;
  int* hist = smem;                   // [G, d+1]
  int* tmax = hist + G * (d + 1);     // [split_tiles]
  uint32_t* qs = reinterpret_cast<uint32_t*>(tmax + split_tiles);  // [G, W]

  for (int x = tid; x < G * (d + 1); x += kDecodeThreads) hist[x] = 0;
  for (int x = tid; x < split_tiles; x += kDecodeThreads) tmax[x] = -d - 2;
  for (int x = tid; x < G * W; x += kDecodeThreads) qs[x] = q[x];
  __syncthreads();

  for (int j = j0 + tid; j < j1; j += kDecodeThreads) {
    if (!keys.valid(j)) continue;
    const uint32_t* kp = keys.k(j);
    int best = -d - 2;
    for (int g = 0; g < G; ++g) {
      const int s = score(qs + g * W, kp, keys.k_stride, W, d);
      atomicAdd(&hist[g * (d + 1) + level(s, d)], 1);
      best = max(best, s);
    }
    atomicMax(&tmax[(j - j0) / kTileKeys], best);
  }
  __syncthreads();
  for (int x = tid; x < G * (d + 1); x += kDecodeThreads)
    hist_out[x] = hist[x];
  for (int x = tid; x < nt; x += kDecodeThreads) tmax_out[t0 + x] = tmax[x];
}

// Launch 2's work in one CTA of kDecodeThreads threads: sums the row's
// n_splits histograms hists[n_splits, G, d+1], takes the thresholds, and
// for each live tile of the split (tmax[tile] >= the least threshold)
// writes the tile's sums to part[tile, G*Dv + G]: numerators (g, dv), then
// denominators g, each summed over the tile's keys in key order. Split 0
// writes the least threshold to *min_thr_out.
template <typename VT, typename Keys>
__device__ void split_tile_sums(const Keys& keys, int n_pos, int split,
                                int split_tiles, int n_splits,
                                const uint32_t* __restrict__ q,
                                const int* __restrict__ hists,
                                const int* __restrict__ tmax,
                                int* __restrict__ min_thr_out,
                                float* __restrict__ part, int G, int W,
                                int Dv, int d, int nsel, float scale,
                                int* smem) {
  const int tid = threadIdx.x;
  const int n_tiles = (n_pos + kTileKeys - 1) / kTileKeys;
  const int t0 = split * split_tiles;
  const int t1 = min(n_tiles, t0 + split_tiles);
  const int stride = G * Dv + G;
  int* hist = smem;                                  // [G, d+1]
  int* thr = hist + G * (d + 1);                     // [G]
  int* kept = thr + G;                               // [kTileKeys]
  uint32_t* qs = reinterpret_cast<uint32_t*>(kept + kTileKeys);  // [G, W]
  float* es = reinterpret_cast<float*>(qs + G * W);  // [G, kTileKeys]
  float* vs = es + G * kTileKeys;                    // [kTileKeys, Dv]

  for (int x = tid; x < G * (d + 1); x += kDecodeThreads) {
    int total = 0;
    for (int sp = 0; sp < n_splits; ++sp)
      total += hists[(size_t)sp * G * (d + 1) + x];
    hist[x] = total;
  }
  for (int x = tid; x < G * W; x += kDecodeThreads) qs[x] = q[x];
  __syncthreads();
  if (tid < G) thr[tid] = threshold(hist + tid * (d + 1), nsel, d);
  __syncthreads();
  int min_thr = thr[0];
  for (int g = 1; g < G; ++g) min_thr = min(min_thr, thr[g]);
  if (split == 0 && tid == 0) *min_thr_out = min_thr;

  for (int tile = t0; tile < t1; ++tile) {
    if (tmax[tile] < min_thr) continue;  // uniform: every thread reads it
    const int j0 = tile * kTileKeys;
    for (int x = tid; x < kTileKeys; x += kDecodeThreads) {
      const int j = j0 + x;
      const bool ok = j < n_pos && keys.valid(j);
      int any = 0;
      for (int g = 0; g < G; ++g) {
        float e = 0.f;
        if (ok) {
          const int s = score(qs + g * W, keys.k(j), keys.k_stride, W, d);
          if (s >= thr[g]) e = expf(scale * (float)(s - d));
        }
        es[g * kTileKeys + x] = e;
        any |= e != 0.f;
      }
      kept[x] = any;
    }
    __syncthreads();
    for (int x = tid; x < kTileKeys * Dv; x += kDecodeThreads) {
      const int key = x / Dv;
      const int c = x - key * Dv;
      vs[x] = kept[key] ? to_float(keys.v(j0 + key)[c]) : 0.f;
    }
    __syncthreads();
    float* pt = part + (size_t)tile * stride;
    for (int o = tid; o < stride; o += kDecodeThreads) {
      if (o < G * Dv) {
        const int g = o / Dv;
        const int c = o - g * Dv;
        const float* er = es + g * kTileKeys;
        float acc = 0.f;
        for (int key = 0; key < kTileKeys; ++key) {
          const float e = er[key];
          if (e != 0.f) acc += e * vs[key * Dv + c];
        }
        pt[o] = acc;
      } else {
        const float* er = es + (o - G * Dv) * kTileKeys;
        float acc = 0.f;
        for (int key = 0; key < kTileKeys; ++key) acc += er[key];
        pt[o] = acc;
      }
    }
    __syncthreads();
  }
}

// Launch 3's work, one thread per output o = (g, dv) of a row: the live
// tiles' sums part[tile, G*Dv + G] added in ascending tile order from 0.f,
// skipping the tiles launch 2 skipped, then num / max(den, 1e-30).
__device__ __forceinline__ float combine_output(const float* __restrict__ part,
                                                const int* __restrict__ tmax,
                                                int n_tiles, int min_thr,
                                                int G, int Dv, int o) {
  const int stride = G * Dv + G;
  const int g = o / Dv;
  float num = 0.f;
  float den = 0.f;
  for (int tile = 0; tile < n_tiles; ++tile) {
    if (tmax[tile] < min_thr) continue;
    num += part[(size_t)tile * stride + o];
    den += part[(size_t)tile * stride + G * Dv + g];
  }
  return num / fmaxf(den, 1e-30f);
}

// Split s covers positions [s * split_tiles * kTileKeys, ...) clipped to
// n_pos.
__device__ __forceinline__ void split_bounds(int n_pos, int split,
                                             int split_tiles, int& j0,
                                             int& j1) {
  j0 = split * split_tiles * kTileKeys;
  j1 = min(n_pos, j0 + split_tiles * kTileKeys);
}

template <typename Src>
__global__ void __launch_bounds__(kDecodeThreads)
split_scores_kernel(const uint32_t* __restrict__ q,  // [R, G, W]
                    Src src, Scratch sc, int G, int W, int d) {
  extern __shared__ int smem[];
  const int row = blockIdx.x;
  const int split = blockIdx.y;
  int j0, j1;
  split_bounds(src.n_pos, split, src.split_tiles, j0, j1);
  const auto keys = src.keys(row, j0, j1, smem);
  split_scores(keys, src.n_pos, split, src.split_tiles,
               q + (size_t)row * G * W,
               sc.hist + (size_t)row * sc.hist_row +
                   (size_t)split * G * (d + 1),
               sc.tmax + (size_t)row * sc.n_tiles, G, W, d,
               smem + src.smem_words());
}

template <typename VT, typename Src>
__global__ void __launch_bounds__(kDecodeThreads)
split_tile_sums_kernel(const uint32_t* __restrict__ q,  // [R, G, W]
                       Src src, Scratch sc, int G, int W, int Dv, int d,
                       int nsel, float scale) {
  extern __shared__ int smem[];
  const int row = blockIdx.x;
  const int split = blockIdx.y;
  int j0, j1;
  split_bounds(src.n_pos, split, src.split_tiles, j0, j1);
  const auto keys = src.keys(row, j0, j1, smem);
  split_tile_sums<VT>(keys, src.n_pos, split, src.split_tiles, gridDim.y,
                      q + (size_t)row * G * W,
                      sc.hist + (size_t)row * sc.hist_row,
                      sc.tmax + (size_t)row * sc.n_tiles, sc.min_thr + row,
                      sc.part + (size_t)row * sc.part_row, G, W, Dv, d, nsel,
                      scale, smem + src.smem_words());
}

__global__ void __launch_bounds__(kDecodeThreads)
split_combine_kernel(Scratch sc, float* __restrict__ out,  // [R, G, Dv]
                     int R, int G, int Dv) {
  const size_t x = (size_t)blockIdx.x * kDecodeThreads + threadIdx.x;
  if (x >= (size_t)R * G * Dv) return;
  const int row = (int)(x / ((size_t)G * Dv));
  const int o = (int)(x - (size_t)row * G * Dv);
  out[x] = combine_output(sc.part + (size_t)row * sc.part_row,
                          sc.tmax + (size_t)row * sc.n_tiles, sc.n_tiles,
                          sc.min_thr[row], G, Dv, o);
}

// Host-side checks of a split launch's shape: positions fit an int and the
// split count fits the grid's y dimension.
inline bool split_shape_ok(long long n_pos, int split_tiles) {
  if (n_pos < 1 || n_pos > (1LL << 30) || split_tiles < 1) return false;
  const long long n_tiles = (n_pos + kTileKeys - 1) / kTileKeys;
  return (n_tiles + split_tiles - 1) / split_tiles <= 65535;
}

// The three launches for R rows of G queries q [R, G, W] -> out [R, G, Dv].
// `scratch` holds R * (S * G * (d+1) + n_tiles + 1) int words, then
// R * n_tiles * (G*Dv + G) floats (the wrappers' split_plan).
template <typename VT, typename Src>
cudaError_t launch_split(const void* q, const Src& src, void* out,
                         void* scratch, int R, int G, int W, int Dv, int d,
                         int nsel, float scale, cudaStream_t stream) {
  const int split_tiles = src.split_tiles;
  const int n_tiles = (src.n_pos + kTileKeys - 1) / kTileKeys;
  const int S = (n_tiles + split_tiles - 1) / split_tiles;
  const Scratch sc(scratch, R, S, G, Dv, d, n_tiles);
  const size_t own = sizeof(int) * (size_t)src.smem_words();
  const size_t smem1 = own + split_scores_smem_bytes(G, W, d, split_tiles);
  const size_t smem2 = own + split_tile_sums_smem_bytes(G, W, Dv, d);
  cudaError_t err = allow_smem(split_scores_kernel<Src>, smem1);
  if (err == cudaSuccess)
    err = allow_smem(split_tile_sums_kernel<VT, Src>, smem2);
  if (err != cudaSuccess) return err;
  const dim3 grid(R, S);
  const auto* qw = static_cast<const uint32_t*>(q);
  split_scores_kernel<Src><<<grid, kDecodeThreads, smem1, stream>>>(
      qw, src, sc, G, W, d);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  split_tile_sums_kernel<VT, Src><<<grid, kDecodeThreads, smem2, stream>>>(
      qw, src, sc, G, W, Dv, d, nsel, scale);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const size_t n_out = (size_t)R * G * Dv;
  const unsigned n_ctas =
      (unsigned)((n_out + kDecodeThreads - 1) / kDecodeThreads);
  split_combine_kernel<<<n_ctas, kDecodeThreads, 0, stream>>>(
      sc, static_cast<float*>(out), R, G, Dv);
  return cudaGetLastError();
}

}  // namespace had
