// HAD decode attention over the paged KV cache, one new token per slot.
//
// Replaces: src/repro/kernels/binary_paged_decode_attention.py
//           paged_decode_attention (_paged_decode_kernel).
//
// The key axis of each (slot, kv-head) row, with its G grouped queries, is
// cut into splits of `split_tiles` 64-position tiles, fixed in LOGICAL
// positions: a split's bounds depend on no length, page size or table
// length, so every tile lies in one split, and the grid (R, S) with
// S = ceil(nb * page / (64 * split_tiles)) comes from shapes alone (no host
// sync, nothing read back from the device). Three launches on the stream,
// the device code in had_decode.cuh:
//   1. scores   (R, S) CTAs: XOR+popcount of the split's valid keys -> the
//               split's (d+1)-bin histogram per query and each tile's max
//               score, plain stores into scratch (no global atomics, no
//               memset);
//   2. tiles    (R, S) CTAs: the row's S histograms summed, the exact top-N
//               thresholds, then each live tile's numerator and denominator
//               sums, computed as the single-CTA decode_row computes them,
//               into scratch [R, n_tiles, G*Dv + G];
//   3. combine  one thread per output: the live tiles' sums in ascending
//               tile order, then num / max(den, 1e-30).
// Those are decode_row's float operations in decode_row's order, so the
// result equals the single-CTA walk that the contiguous-cache kernel (K4)
// still runs, bit for bit, for any page size, and a compacted page-sparse
// table that lists every resident page gives the full walk's result.
//
// Each CTA reads the table entries and per-block valid counts of the blocks
// its split overlaps into shared memory and walks the listed pages in
// place (no gather). Logical position i * page + t is offset t of listed
// block i; it holds a valid key when t < count[i]. Table entries outside
// [0, n_pages) count as 0. Shared memory is sized per split.
//
// What bounds it on an H100: bytes. It reads W*4 bytes of K per valid key
// (twice: launches 1 and 2) and Dv*2 bytes of V (bf16) per kept key; the
// arithmetic is a few integer ops per key and 2*Dv flops per kept key. At 4
// slots x 3 kv heads, 4096-position tables and the wrapper's 4-tile splits
// the grid is 12 x 16 CTAs: a CTA per row (12 on 132 SMs) cannot hide the
// card's latency. It stays far from the memory rate, as one call reads
// only ~1.4 MB.
#include "had_decode.cuh"

namespace {

template <typename VT>
struct PagedKeys {
  const uint32_t* k_pool;  // [P, Hk, W, page]
  const VT* v_pool;        // [P, Hk, page, Dv]
  const int* tbl;          // shared: clamped page ids of blocks first, ...
  const int* cnt;          // shared: valid tokens of those blocks
  int first, page, Hk, hk, W, Dv, k_stride;

  __device__ bool valid(int j) const {
    const int i = j / page;
    return j - i * page < cnt[i - first];
  }
  __device__ const uint32_t* k(int j) const {
    const int i = j / page;
    return k_pool + ((size_t)tbl[i - first] * Hk + hk) * W * page +
           (j - i * page);
  }
  __device__ const VT* v(int j) const {
    const int i = j / page;
    return v_pool +
           (((size_t)tbl[i - first] * Hk + hk) * page + (j - i * page)) * Dv;
  }
};

// Blocks a split can overlap: its positions plus one partial block each side.
__host__ __device__ inline int split_blocks(int nb, int page,
                                            int split_tiles) {
  const int most = (split_tiles * had::kTileKeys + page - 1) / page + 1;
  return most < nb ? most : nb;
}

// Reads row `row`'s table entries and counts of the blocks that positions
// [j0, j1) overlap into tbl/cnt (shared) and returns the first block's index.
// The callers' first barrier publishes them.
__device__ int load_blocks(const int* __restrict__ tables,
                           const int* __restrict__ counts, int row, int nb,
                           int page, int n_pages, int j0, int j1, int* tbl,
                           int* cnt) {
  const int first = j0 / page;
  const int last = j1 > j0 ? (j1 - 1) / page + 1 : first;
  for (int i = first + threadIdx.x; i < last; i += had::kDecodeThreads) {
    const int p = tables[(size_t)row * nb + i];
    const int c = counts[(size_t)row * nb + i];
    const bool ok = p >= 0 && p < n_pages;
    tbl[i - first] = ok ? p : 0;
    cnt[i - first] = ok ? min(max(c, 0), page) : 0;
  }
  return first;
}

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

__global__ void __launch_bounds__(had::kDecodeThreads)
paged_decode_scores_kernel(const uint32_t* __restrict__ q,  // [R, G, W]
                           const uint32_t* __restrict__ k_pool,
                           const int* __restrict__ tables,  // [R, nb]
                           const int* __restrict__ counts,  // [R, nb]
                           Scratch sc, int G, int W, int page, int nb, int Hk,
                           int n_pages, int d, int split_tiles) {
  extern __shared__ int smem[];
  const int row = blockIdx.x;
  const int split = blockIdx.y;
  const int n_pos = nb * page;
  const int j0 = split * split_tiles * had::kTileKeys;
  const int j1 = min(n_pos, j0 + split_tiles * had::kTileKeys);
  const int nblk = split_blocks(nb, page, split_tiles);
  int* tbl = smem;
  int* cnt = tbl + nblk;
  const int first =
      load_blocks(tables, counts, row, nb, page, n_pages, j0, j1, tbl, cnt);
  const PagedKeys<float> keys{k_pool, nullptr, tbl,     cnt, first, page,
                              Hk,     row % Hk, W,      0,   page};
  had::split_scores(keys, n_pos, split, split_tiles, q + (size_t)row * G * W,
                    sc.hist + (size_t)row * sc.hist_row +
                        (size_t)split * G * (d + 1),
                    sc.tmax + (size_t)row * sc.n_tiles, G, W, d, cnt + nblk);
}

template <typename VT>
__global__ void __launch_bounds__(had::kDecodeThreads)
paged_decode_tiles_kernel(const uint32_t* __restrict__ q,  // [R, G, W]
                          const uint32_t* __restrict__ k_pool,
                          const VT* __restrict__ v_pool,  // [P, Hk, page, Dv]
                          const int* __restrict__ tables,  // [R, nb]
                          const int* __restrict__ counts,  // [R, nb]
                          Scratch sc, int G, int W, int page, int Dv, int nb,
                          int Hk, int n_pages, int d, int nsel, float scale,
                          int split_tiles) {
  extern __shared__ int smem[];
  const int row = blockIdx.x;
  const int split = blockIdx.y;
  const int n_pos = nb * page;
  const int j0 = split * split_tiles * had::kTileKeys;
  const int j1 = min(n_pos, j0 + split_tiles * had::kTileKeys);
  const int nblk = split_blocks(nb, page, split_tiles);
  int* tbl = smem;
  int* cnt = tbl + nblk;
  const int first =
      load_blocks(tables, counts, row, nb, page, n_pages, j0, j1, tbl, cnt);
  const PagedKeys<VT> keys{k_pool, v_pool,   tbl, cnt, first, page,
                           Hk,     row % Hk, W,   Dv,  page};
  had::split_tile_sums<VT>(keys, n_pos, split, split_tiles, gridDim.y,
                       q + (size_t)row * G * W,
                       sc.hist + (size_t)row * sc.hist_row,
                       sc.tmax + (size_t)row * sc.n_tiles, sc.min_thr + row,
                       sc.part + (size_t)row * sc.part_row, G, W, Dv, d, nsel,
                       scale, cnt + nblk);
}

__global__ void __launch_bounds__(had::kDecodeThreads)
paged_decode_combine_kernel(Scratch sc, float* __restrict__ out,  // [R, G, Dv]
                            int R, int G, int Dv) {
  const size_t x = (size_t)blockIdx.x * had::kDecodeThreads + threadIdx.x;
  if (x >= (size_t)R * G * Dv) return;
  const int row = (int)(x / ((size_t)G * Dv));
  const int o = (int)(x - (size_t)row * G * Dv);
  out[x] = had::combine_output(sc.part + (size_t)row * sc.part_row,
                               sc.tmax + (size_t)row * sc.n_tiles, sc.n_tiles,
                               sc.min_thr[row], G, Dv, o);
}

template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

template <typename VT>
cudaError_t launch(const void* q, const void* k_pool, const void* v_pool,
                   const void* tables, const void* counts, void* out,
                   void* scratch, int R, int G, int W, int page, int Dv,
                   int nb, int Hk, int n_pages, int d, int nsel, float scale,
                   int split_tiles, cudaStream_t stream) {
  const int n_tiles = (nb * page + had::kTileKeys - 1) / had::kTileKeys;
  const int S = (n_tiles + split_tiles - 1) / split_tiles;
  const Scratch sc(scratch, R, S, G, Dv, d, n_tiles);
  const size_t blocks = sizeof(int) * 2 * split_blocks(nb, page, split_tiles);
  const size_t smem1 =
      blocks + had::split_scores_smem_bytes(G, W, d, split_tiles);
  const size_t smem2 = blocks + had::split_tile_sums_smem_bytes(G, W, Dv, d);
  cudaError_t err = allow_smem(paged_decode_scores_kernel, smem1);
  if (err == cudaSuccess)
    err = allow_smem(paged_decode_tiles_kernel<VT>, smem2);
  if (err != cudaSuccess) return err;
  const dim3 grid(R, S);
  const auto* qw = static_cast<const uint32_t*>(q);
  const auto* kw = static_cast<const uint32_t*>(k_pool);
  const auto* tb = static_cast<const int*>(tables);
  const auto* ct = static_cast<const int*>(counts);
  paged_decode_scores_kernel<<<grid, had::kDecodeThreads, smem1, stream>>>(
      qw, kw, tb, ct, sc, G, W, page, nb, Hk, n_pages, d, split_tiles);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  paged_decode_tiles_kernel<VT><<<grid, had::kDecodeThreads, smem2, stream>>>(
      qw, kw, static_cast<const VT*>(v_pool), tb, ct, sc, G, W, page, Dv, nb,
      Hk, n_pages, d, nsel, scale, split_tiles);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const size_t n_out = (size_t)R * G * Dv;
  const unsigned n_ctas =
      (unsigned)((n_out + had::kDecodeThreads - 1) / had::kDecodeThreads);
  paged_decode_combine_kernel<<<n_ctas, had::kDecodeThreads, 0, stream>>>(
      sc, static_cast<float*>(out), R, G, Dv);
  return cudaGetLastError();
}

}  // namespace

// scratch: int32 words, as many as the wrapper's split_plan gives:
// R * (S * G * (d+1) + n_tiles + 1) ints, then R * n_tiles * (G*Dv + G)
// floats.
extern "C" int had_paged_decode_attention(
    const void* q, const void* k_pool, const void* v_pool, const void* tables,
    const void* counts, void* out, void* scratch, int R, int G, int W,
    int page, int Dv, int nb, int Hk, int n_pages, int d, int nsel,
    float scale, int split_tiles, int v_bf16, void* stream) {
  if (W < 1 || W > had::kMaxWords || d < 1 || d > 32 * W || G < 1 ||
      page < 1 || Dv < 1 || nb < 1 || Hk < 1 || split_tiles < 1 ||
      (long long)nb * page > (1LL << 30))
    return (int)cudaErrorInvalidValue;
  const long long n_tiles = ((long long)nb * page + had::kTileKeys - 1) /
                            had::kTileKeys;
  if ((n_tiles + split_tiles - 1) / split_tiles > 65535)
    return (int)cudaErrorInvalidValue;
  if (R == 0) return (int)cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err =
      v_bf16 ? launch<__nv_bfloat16>(q, k_pool, v_pool, tables, counts, out,
                                     scratch, R, G, W, page, Dv, nb, Hk,
                                     n_pages, d, nsel, scale, split_tiles, s)
             : launch<float>(q, k_pool, v_pool, tables, counts, out, scratch,
                             R, G, W, page, Dv, nb, Hk, n_pages, d, nsel,
                             scale, split_tiles, s);
  return (int)err;
}
