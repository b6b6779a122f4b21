// Phase 1 of page-sparse paged decode: an upper bound, per (row, listed
// page), on the binary score any valid key of the page reaches against any
// of the row's G grouped queries -- and, fused with it, the selection of
// each row's pages and the compaction of its table.
//
// Replaces: src/repro/kernels/binary_page_score.py
//           paged_page_scores (_page_score_kernel), and the selection of
//           src/repro/kernels/ops.py select_pages that follows it.
//
// The bound. The Pallas kernel counts, per bit j, the valid keys with bit j
// set (cnt_j) and calls bit j matchable when q_j = 1 and cnt_j > 0, or
// q_j = 0 and cnt_j < n_valid. Only those two predicates matter, and they
// are "bit j is set in the OR of the valid keys" and "bit j is clear in
// their AND". So a page's valid words reduce to W words of OR and W of AND,
// and
//
//   ub = 2 * popc(((q & OR) | (~q & ~AND)) & live) - d,  max over g,
//
// summed over the W words, is exactly the Pallas integer. `live` masks the
// tail bits past d (with q_j = 0 and zero tails they would count as
// matchable). A count-0 block gives OR = 0 and AND = ~0, hence -d. Table
// entries outside [0, n_pages) count as 0, as in the decode kernels.
//
// Two entry points:
//
//   had_page_scores -- the bounds alone: one warp per (row, listed page)
//       (lanes over the in-page offsets, then a butterfly of shuffles).
//       The serving path no longer runs it; it is the Pallas kernel's
//       direct counterpart, kept as the measured baseline of the fused one.
//   had_page_select -- bounds, selection and compaction in ONE launch, one
//       CTA of 1024 threads per (slot, kv-head) row; the grid depends on
//       the shapes only (no host sync, as CUDA-graph capture needs).
//       1. Bounds: a thread per (listed page, bit-plane) issues the loads
//          of its plane's valid words (16-byte loads when the page size
//          allows) before any reduction -- at 256 pages x 2 planes every
//          load of the row is in flight at once -- and reduces them to a
//          word of OR and one of AND; a thread per page then takes the
//          bound, into shared memory (and `scores_out` when given).
//       2. Selection, exactly ops.select_pages (lax.top_k: ties to the
//          lowest block): the frontier block max(len - 1, 0) // page is
//          always taken; of the other resident blocks (i * page < len), the
//          k best by bound, found from a (2d+1)-bin shared histogram walked
//          from the top by a block-wide suffix scan (threshold tau: every
//          block above it, the lowest-indexed ones at it); when fewer than
//          k are resident, all of them and then the lowest blocks past the
//          frontier.
//       3. Compaction: one block-wide prefix count, in index order, of the
//          blocks above tau and of those at tau gives each selected
//          block's slot; it writes tables[pos] = max(row_table[i], 0),
//          counts[pos] = clamp(len - i * page, 0, page) and logical[pos] =
//          i, in ascending logical order.
//
// What bounds it on an H100: bytes -- each valid key's W words once, the
// row tables and counts, and the n_sel-wide outputs; the integer work is a
// few operations per word. At serving shapes that is a few hundred KB, so a
// call is latency: one load round trip, a handful of block barriers, and
// the launch. The fusion removes the ~20 eager launches of the selection
// (sorts, gathers, casts) that followed the bounds kernel.
#include "had_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

// A page's bound against one query: 2 * (matchable bits below d) - d,
// from the query's W words and the page's W words of OR and of AND.
__device__ __forceinline__ int page_bound(const uint32_t* qg,
                                          const uint32_t* ors,
                                          const uint32_t* ands, int W,
                                          int d) {
  int m = 0;
#pragma unroll
  for (int w = 0; w < had::kMaxWords; ++w) {
    if (w < W) {
      const int rem = d - 32 * w;
      const uint32_t live =
          rem >= 32 ? ~0u : (rem <= 0 ? 0u : (1u << rem) - 1u);
      m += __popc(((qg[w] & ors[w]) | (~qg[w] & ~ands[w])) & live);
    }
  }
  return 2 * m - d;
}

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
  for (int g = lane; g < G; g += 32)
    best = max(best, page_bound(qr + g * W, ors, ands, W, d));
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    best = max(best, __shfl_xor_sync(0xffffffffu, best, off));
  if (lane == 0) out[item] = best;
}

// --- fused bounds + selection + compaction --------------------------------

constexpr int kSelThreads = 1024;
constexpr int kSelWarps = kSelThreads / 32;
// block-wide prefix counts pack two 16-bit counters into one word
constexpr int kMaxSelBlocks = 65535;
// one thread per histogram bin in the threshold's scan
static_assert(2 * 32 * had::kMaxWords + 1 <= kSelThreads, "bins > threads");

// Inclusive prefix sum of `v` over the CTA in thread order; `total` gets
// the CTA's sum. Every thread calls it; `wsum` is kSelWarps words of shared
// memory, free again when it returns.
__device__ __forceinline__ uint32_t block_scan(uint32_t v, uint32_t* wsum,
                                               uint32_t& total) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const uint32_t n = __shfl_up_sync(0xffffffffu, v, off);
    if (lane >= off) v += n;
  }
  if (lane == 31) wsum[warp] = v;
  __syncthreads();
  if (warp == 0) {
    uint32_t s = wsum[lane];
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const uint32_t n = __shfl_up_sync(0xffffffffu, s, off);
      if (lane >= off) s += n;
    }
    wsum[lane] = s;
  }
  __syncthreads();
  if (warp > 0) v += wsum[warp - 1];
  total = wsum[kSelWarps - 1];
  __syncthreads();
  return v;
}

// Dynamic shared memory of the fused kernel, in 4-byte words: bounds [nb],
// one chunk's OR and AND words [kSelThreads each], the histogram [2d+1],
// the row's queries [G*W], scan partials [kSelWarps] and 2 scalars.
inline size_t select_smem_bytes(int nb, int G, int W, int d) {
  return sizeof(uint32_t) *
         ((size_t)nb + 2 * kSelThreads + (2 * d + 1) + (size_t)G * W +
          kSelWarps + 2);
}

// ORs and ANDs the first `cnt` of the `page` words at `src` (the valid
// offsets of one bit-plane of one page), 16 words at a time: a batch's
// loads are all issued before any of them is used.
template <bool kVec>
__device__ __forceinline__ void reduce_plane(const uint32_t* __restrict__ src,
                                             int cnt, uint32_t& o,
                                             uint32_t& a) {
  constexpr int kStep = kVec ? 4 : 1;  // words a load
  for (int t0 = 0; t0 < cnt; t0 += 16) {
    uint32_t x[16];
#pragma unroll
    for (int u = 0; u < 16; u += kStep) {
      if (t0 + u < cnt) {
        if constexpr (kVec) {  // page % 4 == 0: whole uint4 in the page
          const uint4 v = __ldg(reinterpret_cast<const uint4*>(src + t0 + u));
          x[u] = v.x;
          x[u + 1] = v.y;
          x[u + 2] = v.z;
          x[u + 3] = v.w;
        } else {
          x[u] = __ldg(src + t0 + u);
        }
      }
    }
#pragma unroll
    for (int u = 0; u < 16; ++u) {
      if (t0 + u < cnt) {
        o |= x[u];
        a &= x[u];
      }
    }
  }
}

template <bool kVec>
__global__ void __launch_bounds__(kSelThreads, 1)
page_select_kernel(const uint32_t* __restrict__ q,       // [R, G, W]
                   const uint32_t* __restrict__ k_pool,  // [P, Hk, W, page]
                   const int* __restrict__ tables,       // [R, nb]
                   const int* __restrict__ counts,       // [R, nb]
                   const int* __restrict__ lengths,      // [R]
                   int* __restrict__ out_tables,         // [R, n_sel]
                   int* __restrict__ out_counts,         // [R, n_sel]
                   int* __restrict__ out_logical,        // [R, n_sel]
                   int* __restrict__ scores_out,         // [R, nb] or null
                   int G, int W, int page, int nb, int Hk, int n_pages,
                   int d, int n_sel) {
  extern __shared__ __align__(16) uint32_t sm[];
  int* bnd = reinterpret_cast<int*>(sm);            // [nb]
  uint32_t* ors = sm + nb;                          // [kSelThreads]
  uint32_t* ands = ors + kSelThreads;               // [kSelThreads]
  int* hist = reinterpret_cast<int*>(ands + kSelThreads);  // [2d + 1]
  uint32_t* qs = reinterpret_cast<uint32_t*>(hist + 2 * d + 1);  // [G * W]
  uint32_t* wsum = qs + G * W;                      // [kSelWarps]
  int* tau_s = reinterpret_cast<int*>(wsum + kSelWarps);  // tau, quota

  const int tid = threadIdx.x;
  const int row = blockIdx.x;
  const int h = row % Hk;
  const int* trow = tables + (size_t)row * nb;
  const int* crow = counts + (size_t)row * nb;
  for (int x = tid; x < G * W; x += kSelThreads)
    qs[x] = q[(size_t)row * G * W + x];

  // 1. bounds, chunks of kSelThreads / W pages: thread -> (page, plane)
  const int pc = kSelThreads / W;
  for (int i0 = 0; i0 < nb; i0 += pc) {
    const int i = i0 + tid / W;
    const int w = tid - (tid / W) * W;
    uint32_t o = 0u, a = ~0u;
    if (tid < pc * W && i < nb) {
      const int p = trow[i];
      const bool ok = p >= 0 && p < n_pages;
      const int cnt = ok ? min(max(crow[i], 0), page) : 0;
      if (cnt > 0)
        reduce_plane<kVec>(
            k_pool + (((size_t)p * Hk + h) * W + w) * page, cnt, o, a);
    }
    ors[tid] = o;
    ands[tid] = a;
    __syncthreads();  // also publishes qs on the first pass
    if (tid < pc && i0 + tid < nb) {
      int best = -d;  // every bound is >= -d
      for (int g = 0; g < G; ++g)
        best = max(best, page_bound(qs + g * W, ors + tid * W,
                                    ands + tid * W, W, d));
      bnd[i0 + tid] = best;
      if (scores_out != nullptr)
        scores_out[(size_t)row * nb + i0 + tid] = best;
    }
    __syncthreads();
  }

  // 2. selection. Blocks: the frontier f (forced in), the "middle" ones --
  // resident (i < n_res, i.e. i * page < len) and not f -- ranked by bound,
  // and the "tail" ones -- past the frontier -- taken lowest first only
  // when fewer than k middle blocks exist.
  const int len = max(lengths[row], 0);
  const int f = (len > 0 ? len - 1 : 0) / page;
  const bool f_in = f < nb;
  const int n_res = min(nb, len / page + (len % page != 0));
  const int n_mid = n_res - (f < n_res ? 1 : 0);
  const int k = n_sel - (f_in ? 1 : 0);
  int tau, quota, tail_quota;
  if (k <= 0) {  // only the frontier
    tau = d + 1;
    quota = tail_quota = 0;
  } else if (n_mid <= k) {  // every middle block, then the lowest tail ones
    tau = -d - 1;
    quota = 0;
    tail_quota = k - n_mid;
  } else {
    // histogram of the middle blocks' bounds (warp-aggregated adds), then
    // tau = the highest bound b with count(bound >= b) >= k
    for (int x = tid; x < 2 * d + 1; x += kSelThreads) hist[x] = 0;
    __syncthreads();
    for (int base = 0; base < nb; base += kSelThreads) {
      const int i = base + tid;
      const int bin = (i < n_res && i != f) ? bnd[i] + d : -1;
      const unsigned same = __match_any_sync(0xffffffffu, bin);
      if (bin >= 0 && (threadIdx.x & 31) == __ffs(same) - 1)
        atomicAdd(&hist[bin], __popc(same));
    }
    __syncthreads();
    {
      // element e of a suffix scan is bin 2d - e (highest bound first); the
      // one thread where the running count reaches k holds tau
      const int e = tid;
      const uint32_t v = e < 2 * d + 1 ? (uint32_t)hist[2 * d - e] : 0u;
      uint32_t total;
      const uint32_t inc = block_scan(v, wsum, total);
      if (inc - v < (uint32_t)k && inc >= (uint32_t)k) {
        tau_s[0] = d - e;                 // the bound at the threshold
        tau_s[1] = k - (int)(inc - v);    // blocks taken at tau
      }
      __syncthreads();
    }
    tau = tau_s[0];
    quota = tau_s[1];
    tail_quota = 0;
  }

  // 3. compaction, in index order: the slot of block i is the number of
  // selected blocks before it
  uint32_t carry = 0;  // above-tau count | at-tau count << 16
  int* ot = out_tables + (size_t)row * n_sel;
  int* oc = out_counts + (size_t)row * n_sel;
  int* ol = out_logical + (size_t)row * n_sel;
  for (int base = 0; base < nb; base += kSelThreads) {
    const int i = base + tid;
    const bool valid = i < nb;
    const bool mid = valid && i < n_res && i != f;
    const int b = mid ? bnd[i] : 0;
    const bool above = mid && b > tau;
    const bool tie = mid && b == tau;
    const uint32_t v = (uint32_t)above | ((uint32_t)tie << 16);
    uint32_t total;
    const uint32_t ex = carry + block_scan(v, wsum, total) - v;
    carry += total;
    if (!valid) continue;
    const int ex_above = (int)(ex & 0xffffu);
    const int ex_tie = (int)(ex >> 16);
    // tail blocks (i >= n_res, i != f) before i
    const int tail_before =
        max(i - n_res, 0) - ((f >= n_res && f < i) ? 1 : 0);
    const bool is_tail = !mid && i != f;
    const bool sel = i == f || above || (tie && ex_tie < quota) ||
                     (is_tail && tail_before < tail_quota);
    if (!sel) continue;
    const int pos = (f < i ? 1 : 0) + ex_above + min(ex_tie, quota) +
                    min(tail_before, tail_quota);
    const long rem = (long)len - (long)i * page;
    ot[pos] = max(trow[i], 0);
    oc[pos] = (int)min(max(rem, 0L), (long)page);
    ol[pos] = i;
  }
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

extern "C" int had_page_select(const void* q, const void* k_pool,
                               const void* tables, const void* counts,
                               const void* lengths, void* out_tables,
                               void* out_counts, void* out_logical,
                               void* scores_out, int R, int G, int W,
                               int page, int nb, int Hk, int n_pages, int d,
                               int n_sel, void* stream) {
  if (W < 1 || W > had::kMaxWords || d < 1 || d > 32 * W || G < 1 ||
      page < 1 || nb < 1 || nb > kMaxSelBlocks || Hk < 1 || n_sel < 1 ||
      n_sel > nb)
    return (int)cudaErrorInvalidValue;
  if (R == 0) return (int)cudaSuccess;
  const size_t smem = select_smem_bytes(nb, G, W, d);
  const bool vec =
      page % 4 == 0 && (reinterpret_cast<uintptr_t>(k_pool) & 15u) == 0;
  auto kernel = vec ? page_select_kernel<true> : page_select_kernel<false>;
  cudaError_t err = had::allow_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<R, kSelThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(q), static_cast<const uint32_t*>(k_pool),
      static_cast<const int*>(tables), static_cast<const int*>(counts),
      static_cast<const int*>(lengths), static_cast<int*>(out_tables),
      static_cast<int*>(out_counts), static_cast<int*>(out_logical),
      static_cast<int*>(scores_out), G, W, page, nb, Hk, n_pages, d, n_sel);
  return (int)cudaGetLastError();
}
