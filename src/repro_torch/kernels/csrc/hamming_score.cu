// Tiled binary score matrix s[i, j] = d - 2 * ham(q_i, k_j) from packed
// 32-bit words, batched.
//
// Replaces: src/repro/kernels/hamming_score.py
//           hamming_score (_hamming_score_kernel, _score_tile,
//           _unpack_pm1_int8).
//
// Two methods, as in the Pallas kernel, give the same integers, and both
// mask the ragged edge in the kernel: any M and N, nothing padded.
//
//   xor  -- one CTA of 8 warps per (batch, 64-query, 128-key) output
//           tile, the kernel instantiated per word count W. A thread owns 4
//           consecutive keys -- their W words stay in registers -- and 8
//           query rows, whose words it reads from shared memory as warp-wide
//           broadcasts; it writes each row's 4 outputs (XOR + __popc over
//           the W words) as one 16-byte store, so a warp writes 512
//           contiguous bytes of a row, or with 4-byte stores when N % 4
//           breaks the 16-byte alignment. Many CTAs a SM overlap one
//           tile's stores with the next tile's loads.
//   int8 -- the dot product of +-1 vectors on the int8 tensor cores, which
//           is what the Pallas method does on the MXU. One CTA of 8 warps
//           per (batch, 64-query, 128-key) tile. The tile's words are
//           unpacked to +-1 int8 while they are loaded into shared memory
//           (rows of K = 32 * ceil(d / 32) bytes, pitched 16 bytes longer so
//           the fragment loads hit 32 distinct banks); bits past d become 0
//           in BOTH operands, so the padded tail adds nothing. Each warp
//           holds a 32 x 32 accumulator of mma.sync m16n8k32 s8 x s8 -> s32
//           over K / 32 steps. The epilogue stages the int32 tile in shared
//           memory (reusing the operand space) and writes each output row
//           with 16-byte stores, 512 contiguous bytes per warp, or with
//           4-byte stores when N % 4 breaks the 16-byte alignment.
//
// What bounds it on an H100: bytes -- the [M, N] int32 output is 4 bytes
// per pair against W*4 bytes per query or key row read once; the integer
// work per pair is a few operations (xor) or 2 * K int8 tensor-core
// operations (int8, 1979 TOP/s), far below the byte time either way. Both
// epilogues are built to stream the output at the memory rate. The xor
// method's W population counts a pair run on a unit a quarter as wide as
// the integer ALUs, which can hold it above the byte time at small W.
#include "had_common.cuh"

namespace {

// xor method: 8 warps; lane l owns keys 4l..4l+3 of the tile, warp w the
// query rows w, w + 8, ..., w + 56
constexpr int kThreads = 256;
constexpr int kBM = 64;   // queries per tile
constexpr int kBN = 128;  // keys per tile: 32 lanes x 4
constexpr int kRowStep = kThreads / 32;

// int8 method: 8 warps as 2 (queries) x 4 (keys), each on a 32 x 32 block
constexpr int kMmaThreads = 256;
constexpr int kMmaBM = 64;             // queries per tile
constexpr int kMmaBN = 128;            // keys per tile
constexpr int kOutPitch = kMmaBN + 8;  // int32 staging row: conflict-free
                                       // 8-byte fragment stores

// The four bits of `nib` as int8 lanes (bit u -> byte u): +1 for a set
// bit, -1 for a clear one.
__device__ __forceinline__ uint32_t pm1_bytes(uint32_t nib) {
  const uint32_t x = (nib * 0x00204081u) & 0x01010101u;  // bit u -> byte u
  return x | ((x ^ 0x01010101u) * 0xffu);  // 0 -> 0xff; no carries
}

// Unpacks rows [r0, r0 + rows) of src ([n_rows, W] words) into `rows` int8
// rows of `pitch` bytes: the first Kw words, +-1 per bit below d, 0 for bits
// past d and for rows past n_rows.
__device__ __forceinline__ void unpack_rows(const uint32_t* __restrict__ src,
                                            int r0, int n_rows, int rows,
                                            int W, int Kw, int d,
                                            int8_t* dst, int pitch) {
  for (int x = threadIdx.x; x < rows * Kw; x += kMmaThreads) {
    const int r = x / Kw;
    const int w = x - r * Kw;
    const bool ok = r0 + r < n_rows;
    const uint32_t word = ok ? src[(size_t)(r0 + r) * W + w] : 0u;
    const int nv = ok ? min(max(d - 32 * w, 0), 32) : 0;  // bits below d
    uint32_t b[8];
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const int vc = min(max(nv - 4 * c, 0), 4);
      const uint32_t keep = vc == 4 ? 0xffffffffu : (1u << (8 * vc)) - 1u;
      b[c] = pm1_bytes((word >> (4 * c)) & 0xfu) & keep;
    }
    uint4* p = reinterpret_cast<uint4*>(dst + (size_t)r * pitch + 32 * w);
    p[0] = make_uint4(b[0], b[1], b[2], b[3]);
    p[1] = make_uint4(b[4], b[5], b[6], b[7]);
  }
}

// c[16 x 8] += a[16 x 32] * b[32 x 8], int8 in, int32 accumulators.
__device__ __forceinline__ void mma_s8(int* c, const uint32_t* a,
                                       const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Bytes of dynamic shared memory the int8 kernel needs: the two unpacked
// operand tiles, or the int32 output tile that later reuses them.
inline size_t int8_smem_bytes(int d) {
  const size_t pitch = 32 * (size_t)((d + 31) / 32) + 16;
  const size_t operands = (kMmaBM + kMmaBN) * pitch;
  const size_t staging = sizeof(int) * kMmaBM * kOutPitch;
  return operands > staging ? operands : staging;
}

__global__ void __launch_bounds__(kMmaThreads)
hamming_int8_kernel(const uint32_t* __restrict__ q,  // [Bt, M, W]
                    const uint32_t* __restrict__ k,  // [Bt, N, W]
                    int* __restrict__ out,           // [Bt, M, N]
                    int M, int N, int W, int d) {
  extern __shared__ __align__(16) unsigned char smem8[];
  const int Kw = (d + 31) / 32;       // words that hold the first d bits
  const int K = 32 * Kw;              // d zero-padded to the mma depth
  const int pitch = K + 16;           // bytes; pitch / 4 is 4 mod 8 words
  int8_t* as = reinterpret_cast<int8_t*>(smem8);  // [kMmaBM, pitch]
  int8_t* bs = as + kMmaBM * pitch;               // [kMmaBN, pitch]
  int* cs = reinterpret_cast<int*>(smem8);        // [kMmaBM, kOutPitch]
  const int bt = blockIdx.z;
  const int m0 = blockIdx.y * kMmaBM;
  const int n0 = blockIdx.x * kMmaBN;
  unpack_rows(q + (size_t)bt * M * W, m0, M, kMmaBM, W, Kw, d, as, pitch);
  unpack_rows(k + (size_t)bt * N * W, n0, N, kMmaBN, W, Kw, d, bs, pitch);
  __syncthreads();

  // mma fragments (PTX m16n8k32 .s8): lane = 4 * gq + tq; A rows gq and
  // gq + 8, bytes 4tq..4tq+3 and 16+4tq..; B column gq, the same bytes;
  // C rows gq and gq + 8, columns 2tq and 2tq + 1
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int wm = (warp / 4) * 32;
  const int wn = (warp % 4) * 32;
  const int gq = lane / 4;
  const int tq = lane % 4;
  int acc[2][4][4] = {};
  for (int k0 = 0; k0 < K; k0 += 32) {
    uint32_t a[2][4], b[4][2];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi) {
      const int8_t* ap = as + (wm + mi * 16 + gq) * pitch + k0 + 4 * tq;
      a[mi][0] = *reinterpret_cast<const uint32_t*>(ap);
      a[mi][1] = *reinterpret_cast<const uint32_t*>(ap + 8 * pitch);
      a[mi][2] = *reinterpret_cast<const uint32_t*>(ap + 16);
      a[mi][3] = *reinterpret_cast<const uint32_t*>(ap + 8 * pitch + 16);
    }
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
      const int8_t* bp = bs + (wn + ni * 8 + gq) * pitch + k0 + 4 * tq;
      b[ni][0] = *reinterpret_cast<const uint32_t*>(bp);
      b[ni][1] = *reinterpret_cast<const uint32_t*>(bp + 16);
    }
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) mma_s8(acc[mi][ni], a[mi], b[ni]);
  }
  __syncthreads();  // every warp is done with as/bs: cs overwrites them

#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
      int* cp = cs + (wm + mi * 16 + gq) * kOutPitch + wn + ni * 8 + 2 * tq;
      *reinterpret_cast<int2*>(cp) =
          make_int2(acc[mi][ni][0], acc[mi][ni][1]);
      *reinterpret_cast<int2*>(cp + 8 * kOutPitch) =
          make_int2(acc[mi][ni][2], acc[mi][ni][3]);
    }
  __syncthreads();

  // a warp writes one 128-int row: 32 lanes x 16 bytes, contiguous
  int* ob = out + ((size_t)bt * M + m0) * N + n0;
  const bool vec = (N & 3) == 0;  // row starts 16-byte aligned
  constexpr int kQuads = kMmaBN / 4;
  for (int x = threadIdx.x; x < kMmaBM * kQuads; x += kMmaThreads) {
    const int r = x / kQuads;
    const int c = 4 * (x - r * kQuads);
    if (m0 + r >= M) break;  // rows only grow with x
    const int4 v = *reinterpret_cast<const int4*>(cs + r * kOutPitch + c);
    int* op = ob + (size_t)r * N + c;
    if (vec) {
      if (n0 + c < N) *reinterpret_cast<int4*>(op) = v;
    } else {
      if (n0 + c < N) op[0] = v.x;
      if (n0 + c + 1 < N) op[1] = v.y;
      if (n0 + c + 2 < N) op[2] = v.z;
      if (n0 + c + 3 < N) op[3] = v.w;
    }
  }
}

template <int W>
__global__ void __launch_bounds__(kThreads)
hamming_xor_kernel(const uint32_t* __restrict__ q,  // [Bt, M, W]
                   const uint32_t* __restrict__ k,  // [Bt, N, W]
                   int* __restrict__ out,           // [Bt, M, N]
                   int M, int N, int d) {
  __shared__ uint32_t qs[kBM * W];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int bt = blockIdx.z;
  const int m0 = blockIdx.y * kBM;
  const int n0 = blockIdx.x * kBN + 4 * lane;  // this thread's first key
  const uint32_t* qb = q + ((size_t)bt * M + m0) * W;
  for (int x = tid; x < kBM * W; x += kThreads)
    qs[x] = m0 + x / W < M ? qb[x] : 0u;
  uint32_t kr[4][W];
  const uint32_t* kb = k + ((size_t)bt * N + n0) * W;
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int w = 0; w < W; ++w)
      kr[j][w] = n0 + j < N ? __ldg(kb + j * W + w) : 0u;
  __syncthreads();

  const int n_left = N - n0;  // valid keys from n0 (may be <= 0)
  const bool vec = (N & 3) == 0 && n_left >= 4;  // 16-byte aligned, whole
  int* ob = out + ((size_t)bt * M + m0) * N + n0;
#pragma unroll 2
  for (int r = warp; r < kBM; r += kRowStep) {
    if (m0 + r >= M) break;  // rows only grow with r
    uint32_t qw[W];
#pragma unroll
    for (int w = 0; w < W; ++w) qw[w] = qs[r * W + w];  // broadcast
    int s[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      int ham = 0;
#pragma unroll
      for (int w = 0; w < W; ++w) ham += __popc(qw[w] ^ kr[j][w]);
      s[j] = d - 2 * ham;
    }
    int* op = ob + (size_t)r * N;
    if (vec) {
      *reinterpret_cast<int4*>(op) = make_int4(s[0], s[1], s[2], s[3]);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (j < n_left) op[j] = s[j];
    }
  }
}

static_assert(had::kMaxWords == 8, "one launch_xor case per word count");

template <int W>
void launch_xor(const uint32_t* q, const uint32_t* k, int* out, int Bt,
                int M, int N, int d, cudaStream_t s) {
  const dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM, Bt);
  hamming_xor_kernel<W><<<grid, kThreads, 0, s>>>(q, k, out, M, N, d);
}

}  // namespace

extern "C" int had_hamming_score(const void* q, const void* k, void* out,
                                 int Bt, int M, int N, int W, int d, int int8,
                                 void* stream) {
  if (W < 1 || W > had::kMaxWords || d < 1 || d > 32 * W || Bt > 65535 ||
      (M + kBM - 1) / kBM > 65535)
    return (int)cudaErrorInvalidValue;
  if (Bt == 0 || M == 0 || N == 0) return (int)cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* qw = static_cast<const uint32_t*>(q);
  const auto* kw = static_cast<const uint32_t*>(k);
  int* o = static_cast<int*>(out);
  if (int8) {
    const size_t smem = int8_smem_bytes(d);
    if (smem > 48 * 1024) {
      cudaError_t err = cudaFuncSetAttribute(
          hamming_int8_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
          (int)smem);
      if (err != cudaSuccess) return (int)err;
    }
    const dim3 grid((N + kMmaBN - 1) / kMmaBN, (M + kMmaBM - 1) / kMmaBM, Bt);
    hamming_int8_kernel<<<grid, kMmaThreads, smem, s>>>(qw, kw, o, M, N, W,
                                                        d);
  } else {
    switch (W) {  // the words of a pair unrolled into registers
      case 1: launch_xor<1>(qw, kw, o, Bt, M, N, d, s); break;
      case 2: launch_xor<2>(qw, kw, o, Bt, M, N, d, s); break;
      case 3: launch_xor<3>(qw, kw, o, Bt, M, N, d, s); break;
      case 4: launch_xor<4>(qw, kw, o, Bt, M, N, d, s); break;
      case 5: launch_xor<5>(qw, kw, o, Bt, M, N, d, s); break;
      case 6: launch_xor<6>(qw, kw, o, Bt, M, N, d, s); break;
      case 7: launch_xor<7>(qw, kw, o, Bt, M, N, d, s); break;
      default: launch_xor<8>(qw, kw, o, Bt, M, N, d, s); break;
    }
  }
  return (int)cudaGetLastError();
}
