// Top-N HAD decode of one (slot, kv-head) row: the device code shared by
// the paged decode kernel (K2, binary_paged_decode_attention.cu) and the
// contiguous-cache decode kernel (K4, binary_decode_attention.cu). A key's
// address is hidden behind the `Keys` argument:
//
//   bool valid(int j)            position j holds a valid key
//   const uint32_t* k(int j)     word 0 of key j; word w is k_stride words on
//   const VT* v(int j)           the V row of key j
//
// Positions are LOGICAL: a paged row's position i * page + t is offset t of
// its i-th listed block, a contiguous row's position j is cache slot j.
//
// decode_row (K4): one CTA walks the whole row in two passes.
//   pass 0: XOR+popcount scores of every valid key -> per-query (d+1)-bin
//           level histogram (shared-memory integer atomics) and a per-tile
//           max score; then the exact top-N threshold per query.
//   pass 1: tiles of kTileKeys positions whose max misses every query's
//           threshold are skipped. For a live tile, exp(scale * (s - d)) of
//           kept keys is staged in shared memory with the V rows of the keys
//           some query keeps (no other V byte is read), and each thread that
//           owns an output (g, dv) -- or a denominator g -- sums the tile in
//           key order into a tile sum, which is then added to its running
//           total.
//
// The split decode (K2) cuts the key axis into splits of a fixed number of
// tiles, one CTA per (row, split), over three launches, and reproduces
// decode_row's float order:
//   split_scores    pass 0 over one split: that split's integer histogram
//                   and the max score of each of its tiles (a tile lies
//                   in one split), written with plain stores;
//   split_tile_sums the S histograms of the row summed (integers: exact in
//                   any order), the thresholds, then pass 1's tile sum
//                   of each live tile of the split, written to scratch;
//   combine_output  one thread per output adds the live tiles' sums in
//                   ascending tile order from 0.f -- the operations
//                   decode_row's running total does, in the same order.
//
// The float result therefore depends only on the kept keys' (score, V) at
// each logical position, never on the page size, the table length, the
// cache length, skipped tiles or the split: a dense row (K4) and a paged
// row (K2) holding the same tokens in the same logical order give
// bit-identical outputs, and so does a compacted page table whose listed
// pages hold every resident page in logical order followed by count-0
// entries. Any page size works.
#pragma once

#include "had_common.cuh"

namespace had {

constexpr int kDecodeThreads = 256;
constexpr int kTileKeys = 64;  // logical key positions per pass-1 tile

// Bytes of dynamic shared memory decode_row needs for `n_pos` positions.
inline size_t decode_smem_bytes(int G, int W, int Dv, int d, int n_pos) {
  const size_t n_tiles = ((size_t)n_pos + kTileKeys - 1) / kTileKeys;
  return sizeof(int) * ((size_t)G * (d + 1) + G + n_tiles + kTileKeys +
                        (size_t)G * W) +
         sizeof(float) * ((size_t)G * Dv + G + (size_t)G * kTileKeys +
                          (size_t)kTileKeys * Dv);
}

// One CTA of kDecodeThreads threads decodes the G grouped queries `q`
// ([G, W], global) of one row over positions [0, n_pos) and writes out
// ([G, Dv], global). `smem` holds decode_smem_bytes(G, W, Dv, d, n_pos)
// bytes. Shared state the caller wrote before the call (a page table) is
// visible to `keys` after the first barrier below, before pass 0.
template <typename VT, typename Keys>
__device__ void decode_row(const Keys& keys, int n_pos,
                           const uint32_t* __restrict__ q,
                           float* __restrict__ out, int G, int W, int Dv,
                           int d, int nsel, float scale, int* smem) {
  const int tid = threadIdx.x;
  const int n_tiles = (n_pos + kTileKeys - 1) / kTileKeys;
  int* hist = smem;                                  // [G, d+1]
  int* thr = hist + G * (d + 1);                     // [G]
  int* tmax = thr + G;                               // [n_tiles]
  int* kept = tmax + n_tiles;                        // [kTileKeys]
  uint32_t* qs = reinterpret_cast<uint32_t*>(kept + kTileKeys);  // [G, W]
  float* num = reinterpret_cast<float*>(qs + G * W);             // [G, Dv]
  float* den = num + G * Dv;                                     // [G]
  float* es = den + G;                                // [G, kTileKeys]
  float* vs = es + G * kTileKeys;                     // [kTileKeys, Dv]

  for (int x = tid; x < G * (d + 1); x += kDecodeThreads) hist[x] = 0;
  for (int x = tid; x < n_tiles; x += kDecodeThreads) tmax[x] = -d - 2;
  for (int x = tid; x < G * W; x += kDecodeThreads) qs[x] = q[x];
  for (int x = tid; x < G * Dv; x += kDecodeThreads) num[x] = 0.f;
  if (tid < G) den[tid] = 0.f;
  __syncthreads();

  // pass 0: histograms and per-tile max scores
  for (int j = tid; j < n_pos; j += kDecodeThreads) {
    if (!keys.valid(j)) continue;
    const uint32_t* kp = keys.k(j);
    int best = -d - 2;
    for (int g = 0; g < G; ++g) {
      const int s = score(qs + g * W, kp, keys.k_stride, W, d);
      atomicAdd(&hist[g * (d + 1) + level(s, d)], 1);
      best = max(best, s);
    }
    atomicMax(&tmax[j / kTileKeys], best);
  }
  __syncthreads();
  if (tid < G) thr[tid] = threshold(hist + tid * (d + 1), nsel, d);
  __syncthreads();
  int min_thr = thr[0];
  for (int g = 1; g < G; ++g) min_thr = min(min_thr, thr[g]);

  // pass 1: masked exp accumulation over live tiles, in key order
  for (int tile = 0; tile < n_tiles; ++tile) {
    if (tmax[tile] < min_thr) continue;  // uniform: every thread reads smem
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
    for (int o = tid; o < G * Dv + G; o += kDecodeThreads) {
      if (o < G * Dv) {
        const int g = o / Dv;
        const int c = o - g * Dv;
        const float* er = es + g * kTileKeys;
        float acc = 0.f;
        for (int key = 0; key < kTileKeys; ++key) {
          const float e = er[key];
          if (e != 0.f) acc += e * vs[key * Dv + c];
        }
        num[o] += acc;
      } else {
        const float* er = es + (o - G * Dv) * kTileKeys;
        float acc = 0.f;
        for (int key = 0; key < kTileKeys; ++key) acc += er[key];
        den[o - G * Dv] += acc;
      }
    }
    __syncthreads();
  }

  for (int o = tid; o < G * Dv; o += kDecodeThreads)
    out[o] = num[o] / fmaxf(den[o / Dv], 1e-30f);
}


// ---------------------------------------------------------------------------
// The split decode. Split s covers tiles [s * split_tiles, (s + 1) *
// split_tiles) of the row, positions [s * split_tiles * kTileKeys, ...)
// clipped to n_pos: its bounds depend on shapes only.
// ---------------------------------------------------------------------------

// Bytes of dynamic shared memory split_scores needs.
inline size_t split_scores_smem_bytes(int G, int W, int d, int split_tiles) {
  return sizeof(int) * ((size_t)G * (d + 1) + split_tiles + (size_t)G * W);
}

// Bytes of dynamic shared memory split_tile_sums needs.
inline size_t split_tile_sums_smem_bytes(int G, int W, int Dv, int d) {
  return sizeof(int) * ((size_t)G * (d + 1) + G + kTileKeys + (size_t)G * W) +
         sizeof(float) * ((size_t)G * kTileKeys + (size_t)kTileKeys * Dv);
}

// Launch 1, one CTA of kDecodeThreads threads per (row, split): decode_row's
// pass 0 over the split's positions. Writes the split's histogram
// hist_out[G, d+1] and the max score of each of its tiles to
// tmax_out[tile] (the row's [n_tiles]; -d-2 for a tile with no valid key).
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

// Launch 2, one CTA of kDecodeThreads threads per (row, split): sums the
// row's n_splits histograms hists[n_splits, G, d+1], takes the thresholds,
// and for each live tile of the split (tmax[tile] >= the least threshold)
// writes decode_row's pass-1 tile sums -- part[tile, G*Dv + G]: numerators
// (g, dv), then denominators g -- computed exactly as decode_row computes
// them. Split 0 writes the least threshold to *min_thr_out.
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

  // decode_row's pass 1 over this split's tiles; the tile sum goes to
  // scratch instead of a running total
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

// Launch 3, one thread per output o = (g, dv) of a row: the live tiles' sums
// part[tile, G*Dv + G] added in ascending tile order from 0.f, skipping the
// tiles decode_row skips, then num / max(den, 1e-30) -- decode_row's
// running num[o] / den[g] and its final division, operation for operation.
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

}  // namespace had
