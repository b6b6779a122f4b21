// HAD decode attention over a contiguous (dense, non-paged) KV cache, one
// new token per row.
//
// Replaces: src/repro/kernels/binary_decode_attention.py
//           decode_attention (_decode_kernel, with _scores / _threshold).
//
// One CTA per (slot, kv-head) row with its G grouped queries, keys as
// bit-planes [W, T] and V rows [T, Dv]; position j holds a valid key when
// j < length. The Pallas kernel's sequential (pass, block) grid with VMEM
// scratch becomes a loop inside the CTA: had_decode.cuh's decode_row, the
// same device code the paged decode kernel runs, with its per-tile block
// skip (a 64-position tile whose best score misses every query's threshold
// reads no V). Only the address of a key differs, so the dense cache and
// the page pools give bit-identical outputs for the same tokens. The TPU's
// block_t tile has no counterpart: the loop stops at the row's length.
//
// What bounds it on an H100: bytes, as for the paged kernel (W*4 bytes of K
// per valid key, Dv*2 bytes of V per kept key). At serving widths the grid
// is B*Hk CTAs, far too few for 132 SMs; splitting the key axis is the
// redesign it shares with the paged kernel.
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

template <typename VT>
__global__ void __launch_bounds__(had::kDecodeThreads)
decode_kernel(const uint32_t* __restrict__ q,    // [R, G, W]
              const uint32_t* __restrict__ k,    // [R, W, T]
              const VT* __restrict__ v,          // [R, T, Dv]
              const int* __restrict__ lengths,   // [R]
              float* __restrict__ out,           // [R, G, Dv]
              int G, int W, int T, int Dv, int d, int nsel, float scale) {
  extern __shared__ int smem[];
  const int row = blockIdx.x;
  const int n_pos = max(0, min(lengths[row], T));
  const DenseKeys<VT> keys{k + (size_t)row * W * T, v + (size_t)row * T * Dv,
                           n_pos, Dv, T};
  had::decode_row<VT>(keys, n_pos, q + (size_t)row * G * W,
                      out + (size_t)row * G * Dv, G, W, Dv, d, nsel, scale,
                      smem);
}

template <typename VT>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* lengths, void* out, int R, int G, int W, int T,
                   int Dv, int d, int nsel, float scale, cudaStream_t stream) {
  const size_t smem = had::decode_smem_bytes(G, W, Dv, d, T);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        decode_kernel<VT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return err;
  }
  decode_kernel<VT><<<R, had::kDecodeThreads, smem, stream>>>(
      static_cast<const uint32_t*>(q), static_cast<const uint32_t*>(k),
      static_cast<const VT*>(v), static_cast<const int*>(lengths),
      static_cast<float*>(out), G, W, T, Dv, d, nsel, scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" int had_decode_attention(const void* q, const void* k,
                                    const void* v, const void* lengths,
                                    void* out, int R, int G, int W, int T,
                                    int Dv, int d, int nsel, float scale,
                                    int v_bf16, void* stream) {
  if (W < 1 || W > had::kMaxWords || d < 1 || d > 32 * W || G < 1 ||
      T < 1 || Dv < 1)
    return (int)cudaErrorInvalidValue;
  if (R == 0) return (int)cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err =
      v_bf16 ? launch<__nv_bfloat16>(q, k, v, lengths, out, R, G, W, T, Dv, d,
                                     nsel, scale, s)
             : launch<float>(q, k, v, lengths, out, R, G, W, T, Dv, d, nsel,
                             scale, s);
  return (int)err;
}
