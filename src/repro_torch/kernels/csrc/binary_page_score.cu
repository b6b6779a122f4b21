// Phase 1 of page-sparse paged decode: an upper bound, per (row, listed
// page), on the binary score any valid key of the page reaches against any
// of the row's G grouped queries.
//
// Replaces: src/repro/kernels/binary_page_score.py
//           paged_page_scores (_page_score_kernel).
//
// The Pallas kernel counts, per bit j, the valid keys with bit j set
// (cnt_j) and calls bit j matchable when q_j = 1 and cnt_j > 0, or q_j = 0
// and cnt_j < n_valid. Only those two predicates matter, and they are
// "bit j is set in the OR of the valid keys" and "bit j is clear in their
// AND". So one warp per (row, listed page) reduces the page's valid words
// to W words of OR and W of AND (lanes over the in-page offsets, then a
// butterfly of shuffles), and
//
//   ub = 2 * popc(((q & OR) | (~q & ~AND)) & live) - d,  max over g,
//
// summed over the W words, is exactly the Pallas integer. `live` masks the
// tail bits past d (with q_j = 0 and zero tails they would count as
// matchable). A count-0 block gives OR = 0 and AND = ~0, hence -d. Table
// entries outside [0, n_pages) count as 0, as in the decode kernels.
//
// What bounds it on an H100: bytes -- it reads each valid key's W words
// once (W*4 bytes a key) and writes one int per listed page; the integer
// work is a few operations per word. A warp per page keeps 8 pages in
// flight per CTA and R * nb / 8 CTAs on the card.
#include "had_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__global__ void __launch_bounds__(kThreads)
page_score_kernel(const uint32_t* __restrict__ q,       // [R, G, W]
                  const uint32_t* __restrict__ k_pool,  // [P, Hk, W, page]
                  const int* __restrict__ tables,       // [R, nb]
                  const int* __restrict__ counts,       // [R, nb]
                  int* __restrict__ out,                // [R, nb]
                  int R, int G, int W, int page, int nb, int Hk, int n_pages,
                  int d) {
  const int lane = threadIdx.x & 31;
  const long item = (long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (item >= (long)R * nb) return;  // the whole warp leaves together
  const int row = (int)(item / nb);
  const int p = tables[item];
  const bool ok = p >= 0 && p < n_pages;
  const int cnt = ok ? min(max(counts[item], 0), page) : 0;
  const uint32_t* kp =
      k_pool + ((size_t)(ok ? p : 0) * Hk + row % Hk) * W * page;

  uint32_t ors[had::kMaxWords], ands[had::kMaxWords];
#pragma unroll
  for (int w = 0; w < had::kMaxWords; ++w) {
    uint32_t o = 0u, a = ~0u;
    if (w < W) {
      for (int t = lane; t < cnt; t += 32) {
        const uint32_t x = kp[w * page + t];
        o |= x;
        a &= x;
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        o |= __shfl_xor_sync(0xffffffffu, o, off);
        a &= __shfl_xor_sync(0xffffffffu, a, off);
      }
    }
    ors[w] = o;
    ands[w] = a;
  }

  const uint32_t* qr = q + (size_t)row * G * W;
  int best = -d;  // every bound is >= -d
  for (int g = lane; g < G; g += 32) {
    int m = 0;
#pragma unroll
    for (int w = 0; w < had::kMaxWords; ++w) {
      if (w < W) {
        const int rem = d - 32 * w;
        const uint32_t live =
            rem >= 32 ? ~0u : (rem <= 0 ? 0u : (1u << rem) - 1u);
        const uint32_t qw = qr[g * W + w];
        m += __popc(((qw & ors[w]) | (~qw & ~ands[w])) & live);
      }
    }
    best = max(best, 2 * m - d);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    best = max(best, __shfl_xor_sync(0xffffffffu, best, off));
  if (lane == 0) out[item] = best;
}

}  // namespace

extern "C" int had_page_scores(const void* q, const void* k_pool,
                               const void* tables, const void* counts,
                               void* out, int R, int G, int W, int page,
                               int nb, int Hk, int n_pages, int d,
                               void* stream) {
  if (W < 1 || W > had::kMaxWords || d < 1 || d > 32 * W || G < 1 ||
      page < 1 || nb < 1 || Hk < 1)
    return (int)cudaErrorInvalidValue;
  if (R == 0) return (int)cudaSuccess;
  const long items = (long)R * nb;
  const unsigned blocks = (unsigned)((items + kWarps - 1) / kWarps);
  page_score_kernel<<<blocks, kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(q), static_cast<const uint32_t*>(k_pool),
      static_cast<const int*>(tables), static_cast<const int*>(counts),
      static_cast<int*>(out), R, G, W, page, nb, Hk, n_pages, d);
  return (int)cudaGetLastError();
}
