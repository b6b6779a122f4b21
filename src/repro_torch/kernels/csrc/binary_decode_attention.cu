// HAD decode attention over a contiguous (dense, non-paged) KV cache, one
// new token per row.
//
// Replaces: src/repro/kernels/binary_decode_attention.py
//           decode_attention (_decode_kernel, with _scores / _threshold).
//
// Each (slot, kv-head) row holds its G grouped queries, keys as bit-planes
// [W, T] and V rows [T, Dv]; position j holds a valid key when j < length.
// The Pallas kernel's sequential (pass, block) grid with VMEM scratch
// becomes had_decode.cuh's split decode, the same three launches the paged
// kernel (K2) runs: the key axis cut into fixed splits of `split_tiles`
// 64-position tiles, one CTA per (row, split) for the split histograms and
// tile maxima, one per (row, split) for the tile sums (a tile whose best
// score misses every query's threshold reads no V), and an ordered
// combine. The grid (R, ceil(T / (64 * split_tiles))) comes from shapes
// alone. Only the address of a key differs from K2 (DenseKeys), so the
// dense cache and the page pools give bit-identical outputs for the same
// tokens. The TPU's block_t tile has no counterpart.
//
// What bounds it on an H100: bytes, as for the paged kernel (W*4 bytes of K
// per valid key, Dv*2 bytes of V per kept key), and at serving shapes the
// latency of the tile-sum launch, which walks its split's tiles in turn.
#include "had_decode.cuh"

namespace {

template <typename VT>
struct DenseKeys {
  const uint32_t* k_row;  // [W, T] bit-planes of this row
  const VT* v_row;        // [T, Dv] V rows of this row
  int len, Dv, k_stride;  // k_stride = T

  __device__ bool valid(int j) const { return j < len; }
  __device__ const uint32_t* k(int j) const { return k_row + j; }
  __device__ const VT* v(int j) const { return v_row + (size_t)j * Dv; }
};

// Where a row's keys live: row `row` of the cache, valid below its length.
template <typename VT>
struct DenseSrc {
  const uint32_t* k;     // [R, W, T]
  const VT* v;           // [R, T, Dv]
  const int* lengths;    // [R]
  int n_pos, split_tiles, W, Dv;  // n_pos = T

  __host__ __device__ int smem_words() const { return 0; }
  __device__ DenseKeys<VT> keys(int row, int, int, int*) const {
    return DenseKeys<VT>{k + (size_t)row * W * n_pos,
                         v + (size_t)row * n_pos * Dv,
                         max(0, min(lengths[row], n_pos)), Dv, n_pos};
  }
};

}  // namespace

// scratch: int32 words, as many as the wrapper's split_plan gives:
// R * (S * G * (d+1) + n_tiles + 1) ints, then R * n_tiles * (G*Dv + G)
// floats.
extern "C" int had_decode_attention(const void* q, const void* k,
                                    const void* v, const void* lengths,
                                    void* out, void* scratch, int R, int G,
                                    int W, int T, int Dv, int d, int nsel,
                                    float scale, int split_tiles, int v_bf16,
                                    void* stream) {
  if (W < 1 || W > had::kMaxWords || d < 1 || d > 32 * W || G < 1 ||
      Dv < 1 || !had::split_shape_ok(T, split_tiles))
    return (int)cudaErrorInvalidValue;
  if (R == 0) return (int)cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* kw = static_cast<const uint32_t*>(k);
  const auto* len = static_cast<const int*>(lengths);
  if (v_bf16) {
    const DenseSrc<__nv_bfloat16> src{
        kw, static_cast<const __nv_bfloat16*>(v), len, T, split_tiles, W, Dv};
    return (int)had::launch_split<__nv_bfloat16>(q, src, out, scratch, R, G,
                                                 W, Dv, d, nsel, scale, s);
  }
  const DenseSrc<float> src{kw, static_cast<const float*>(v), len, T,
                            split_tiles, W, Dv};
  return (int)had::launch_split<float>(q, src, out, scratch, R, G, W, Dv, d,
                                       nsel, scale, s);
}
