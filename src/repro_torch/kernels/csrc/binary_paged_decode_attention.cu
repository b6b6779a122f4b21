// HAD decode attention over the paged KV cache, one new token per slot.
//
// Replaces: src/repro/kernels/binary_paged_decode_attention.py
//           paged_decode_attention (_paged_decode_kernel).
//
// The key axis of each (slot, kv-head) row, with its G grouped queries, is
// cut into splits of `split_tiles` 64-position tiles, fixed in LOGICAL
// positions, and run as had_decode.cuh's three launches (split histograms
// and tile maxima, tile sums, ordered combine) with the grid (R, S),
// S = ceil(nb * page / (64 * split_tiles)), from shapes alone (no host
// sync, nothing read back from the device). The contiguous-cache kernel
// (K4) runs the same launches, so the two give bit-identical outputs for
// the same tokens, for any page size, and a compacted page-sparse table
// that lists every resident page gives the full table's result.
//
// What is K2's own is where a key lives (PagedSrc): each CTA reads the
// table entries and per-block valid counts of the blocks its split
// overlaps into shared memory and walks the listed pages in place (no
// gather). Logical position i * page + t is offset t of listed block i; it
// holds a valid key when t < count[i]. Table entries outside [0, n_pages)
// count as 0. Shared memory is sized per split.
//
// What bounds it on an H100: bytes. It reads W*4 bytes of K per valid key
// (twice: launches 1 and 2) and Dv*2 bytes of V (bf16) per kept key; the
// arithmetic is a few integer ops per key and 2*Dv flops per kept key. At 4
// slots x 3 kv heads, 4096-position tables and the wrapper's 4-tile splits
// the grid is 12 x 16 CTAs. It stays far from the memory rate, as one call
// reads only ~1.4 MB: the tile-sum launch walks its split's tiles in turn,
// and latency, not bytes, sets its time.
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

// Where a row's keys live: its table entries and valid counts, read by each
// CTA for the blocks its split overlaps.
template <typename VT>
struct PagedSrc {
  const uint32_t* k_pool;  // [P, Hk, W, page]
  const VT* v_pool;        // [P, Hk, page, Dv]
  const int* tables;       // [R, nb]
  const int* counts;       // [R, nb]
  int n_pos, split_tiles, nb, page, Hk, n_pages, W, Dv;

  __host__ __device__ int smem_words() const {
    return 2 * split_blocks(nb, page, split_tiles);
  }
  __device__ PagedKeys<VT> keys(int row, int j0, int j1, int* smem) const {
    int* tbl = smem;
    int* cnt = tbl + split_blocks(nb, page, split_tiles);
    const int first =
        load_blocks(tables, counts, row, nb, page, n_pages, j0, j1, tbl, cnt);
    return PagedKeys<VT>{k_pool, v_pool, tbl, cnt, first, page,
                         Hk,     row % Hk, W, Dv, page};
  }
};

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
      page < 1 || Dv < 1 || nb < 1 || Hk < 1 ||
      !had::split_shape_ok((long long)nb * page, split_tiles))
    return (int)cudaErrorInvalidValue;
  if (R == 0) return (int)cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int n_pos = nb * page;
  const auto* kw = static_cast<const uint32_t*>(k_pool);
  const auto* tb = static_cast<const int*>(tables);
  const auto* ct = static_cast<const int*>(counts);
  if (v_bf16) {
    const PagedSrc<__nv_bfloat16> src{
        kw, static_cast<const __nv_bfloat16*>(v_pool), tb, ct, n_pos,
        split_tiles, nb, page, Hk, n_pages, W, Dv};
    return (int)had::launch_split<__nv_bfloat16>(q, src, out, scratch, R, G,
                                                 W, Dv, d, nsel, scale, s);
  }
  const PagedSrc<float> src{kw, static_cast<const float*>(v_pool), tb, ct,
                            n_pos, split_tiles, nb, page, Hk, n_pages, W, Dv};
  return (int)had::launch_split<float>(q, src, out, scratch, R, G, W, Dv, d,
                                       nsel, scale, s);
}
