// HAD decode attention over the paged KV cache, one new token per slot.
//
// Replaces: src/repro/kernels/binary_paged_decode_attention.py
//           paged_decode_attention (_paged_decode_kernel).
//
// One CTA per (slot, kv-head) row with its G grouped queries. The CTA reads
// the row's block table and per-block valid counts into shared memory and
// walks the listed pages in place (no gather). Logical position i * page + t
// is offset t of listed block i; it holds a valid key when t < count[i].
// Table entries outside [0, n_pages) count as 0. The two passes (histogram
// threshold, then tile-skipping exp accumulation over fixed 64-position
// tiles in key order, no float atomics) are had_decode.cuh's decode_row,
// shared with the contiguous-cache kernel: the same tokens in the same
// logical order give bit-identical outputs on either cache, for any page
// size, and a compacted page-sparse table that lists every resident page
// gives the dense walk's result bit for bit.
//
// What bounds it on an H100: bytes. It reads W*4 bytes of K per valid key
// and Dv*2 bytes of V (bf16) per kept key; the arithmetic is a few integer
// ops per key and 2*Dv flops per kept key. At full width the grid is only
// B*Hk CTAs (12 at 4 slots x 3 kv heads) on 132 SMs, so it is latency
// bound far below the memory rate. Splitting the key axis across CTAs
// (a second reduction pass for num/den and the histograms) is the first
// redesign this kernel needs.
#include "had_decode.cuh"

namespace {

template <typename VT>
struct PagedKeys {
  const uint32_t* k_pool;  // [P, Hk, W, page]
  const VT* v_pool;        // [P, Hk, page, Dv]
  const int* tbl;          // [nb] shared: clamped page ids
  const int* cnt;          // [nb] shared: valid tokens per listed block
  int page, Hk, hk, W, Dv, k_stride;

  __device__ bool valid(int j) const {
    const int i = j / page;
    return j - i * page < cnt[i];
  }
  __device__ const uint32_t* k(int j) const {
    const int i = j / page;
    return k_pool + ((size_t)tbl[i] * Hk + hk) * W * page + (j - i * page);
  }
  __device__ const VT* v(int j) const {
    const int i = j / page;
    return v_pool + (((size_t)tbl[i] * Hk + hk) * page + (j - i * page)) * Dv;
  }
};

template <typename VT>
__global__ void __launch_bounds__(had::kDecodeThreads)
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
  int* tbl = smem;        // [nb]
  int* cnt = tbl + nb;    // [nb]
  for (int i = threadIdx.x; i < nb; i += had::kDecodeThreads) {
    const int p = tables[(size_t)row * nb + i];
    const int c = counts[(size_t)row * nb + i];
    const bool ok = p >= 0 && p < n_pages;
    tbl[i] = ok ? p : 0;
    cnt[i] = ok ? min(max(c, 0), page) : 0;
  }
  // decode_row's first barrier publishes tbl/cnt before pass 0 reads them
  const PagedKeys<VT> keys{k_pool, v_pool, tbl, cnt, page, Hk, row % Hk,
                           W, Dv, page};
  had::decode_row<VT>(keys, nb * page, q + (size_t)row * G * W,
                      out + (size_t)row * G * Dv, G, W, Dv, d, nsel, scale,
                      cnt + nb);
}

template <typename VT>
cudaError_t launch(const void* q, const void* k_pool, const void* v_pool,
                   const void* tables, const void* counts, void* out, int R,
                   int G, int W, int page, int Dv, int nb, int Hk, int n_pages,
                   int d, int nsel, float scale, cudaStream_t stream) {
  const size_t smem = sizeof(int) * 2 * (size_t)nb +
                      had::decode_smem_bytes(G, W, Dv, d, nb * page);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        paged_decode_kernel<VT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return err;
  }
  paged_decode_kernel<VT><<<R, had::kDecodeThreads, smem, stream>>>(
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
