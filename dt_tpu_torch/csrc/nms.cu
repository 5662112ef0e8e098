// Greedy non-max suppression over score-sorted boxes, one warp a label run.
//
// Input: boxes (B, N, 4) f32; optional labels (B, N) int32; counts (B,)
// int32, the number of boxes an image scans (those above the score
// threshold, a prefix of the order); optional perm (B, N) int64.  Output:
// keep (B, N) bytes, 1 for a box kept, 0 for a box suppressed or past its
// image's count.  Box i is kept unless a kept box j < i of its run overlaps
// it: (same label or no labels ? IoU(i, j) : 0) > threshold.
//
// Replaces the greedy scan of `nms` (dt_tpu/ops/detection.py:141-169), a
// lax.fori_loop over an N x N IoU matrix there, with no Pallas kernel
// behind it; eager PyTorch would need a host round trip a box.
//
// Boxes of two labels never suppress each other at a threshold >= 0, so
// each label's boxes can be scanned alone.  Where the wrapper passes `perm`
// it has reordered each image's prefix stably by label (ops.kernels
// .nms_label_runs: a box's score order holds inside its label): the prefix
// is a sequence of runs, one a label, labels ascending.  Without it (no
// labels, force_suppress, or a labelled threshold < 0, where cross-label
// pairs do suppress) the prefix is one run and labels are compared pair by
// pair.
//
// Two kernels, one launch of each a call:
//   - mask: block (rb, g, b) of 64 threads holds 64 row boxes of image b and
//     walks the column tiles cb = rb + g, rb + g + G, ... (G blocks share a
//     row tile); thread i writes, for row i, one 64-bit word of the boxes
//     j > i of its run it overlaps.  With sorted runs the labels ascend, so
//     the walk stops at the first column tile whose first label is past the
//     row tile's last: the tiles computed are those whose row and column
//     ranges share a label, and inside a tile a cross-label pair costs a
//     compare, not an IoU.  The scratch holds a window of kWin words a row
//     (B, win, N), win = min(words, kWin): word rb + d of row i (row tile
//     rb) at [b][d][i], so a tile's 64 words are one coalesced store; the
//     walk stops at d = win.  At SSD300's (32, 7,756) that is 63,537,152
//     bytes where a word for every pair of the image would be 242,235,392.
//   - scan: one block an image, 32 warps.  The warps claim 32-box chunks of
//     the prefix from a shared counter and each takes the runs that start
//     in its chunk, one at a time.  A run is walked 64 boxes (one word) at
//     a time: the word's "removed" bits, the diagonal words of its 64 rows
//     and their places in the caller's order (loaded one row a lane, the
//     next word's prefetched), a serial pass in registers that keeps each
//     box whose bit is clear and ORs its diagonal word in (a shuffle a box,
//     unrolled by 8, no barrier), then the kept rows' later words ORed into
//     the removed words, each lane a word, eight loads in flight.
//     The removed words live in registers (lane w holds word w of the run)
//     for runs spanning up to 32 words, which the window always holds, in
//     the warp's shared memory beyond.  A word of such a longer run kWin or
//     more words past a kept row's is past the window: its lane computes
//     that row's IoUs with the word's boxes itself, the mask kernel's
//     arithmetic and compare, skipping boxes already removed.
//     Steps are ordered by __syncwarp, never __syncthreads, and the serial
//     chain is a run's words, not an image's kept boxes.  Keep bytes go
//     through perm back to the caller's order.
// The IoU is box_iou's arithmetic step by step (areas with the widths
// clamped at 0, intersection, (area_i + area_j) - inter, then the quotient,
// 0 where the union is not positive), each step one correctly rounded f32
// operation (__fsub_rn, __fmul_rn, __fadd_rn, __fdiv_rn, no FMA), so the
// kept set is the plain version's bit for bit.
//
// Bound: operations.  13 f32 operations a pair of boxes the greedy scan
// must compare (8 for the overlap's width and height, a product, a sum and
// a difference for the union, a quotient, the comparison): K_b (K_b - 1) / 2
// pairs an image without labels; with labels (and a threshold >= 0) only
// the pairs of one label, the sum over labels of K_l (K_l - 1) / 2.  Against
// 21 bytes a box read or written once (its box, label and keep byte; the
// mask words and the reorder are scratch); the least time is the larger of
// those over the card's f32 rate and its memory rate.  The mask kernel
// computes whole 64 x 64 tiles around the runs, and each run's scan is a
// serial chain of its words, which no bound counts.  The scratch is a
// window, not the pairs of the runs: its size must be known before the
// labels are, and the wrapper reads nothing back from the card.

#include "common.cuh"

namespace {

typedef unsigned long long u64;

constexpr int kBlock = 64;       // boxes a mask word, rows a mask block
constexpr int kGroups = 8;       // mask blocks sharing a row tile
constexpr int kWarps = 32;       // scan warps a block (an image)
constexpr int kLoads = 8;        // mask loads in flight a lane
constexpr int kWin = 32;         // scratch words a row: a register run's span
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float area(float4 b) {
  return __fmul_rn(fmaxf(__fsub_rn(b.z, b.x), 0.0f),
                   fmaxf(__fsub_rn(b.w, b.y), 0.0f));
}

__device__ __forceinline__ float iou(float4 a, float area_a, float4 b,
                                     float area_b) {
  const float w = fmaxf(__fsub_rn(fminf(a.z, b.z), fmaxf(a.x, b.x)), 0.0f);
  const float h = fmaxf(__fsub_rn(fminf(a.w, b.w), fmaxf(a.y, b.y)), 0.0f);
  const float inter = __fmul_rn(w, h);
  const float uni = __fsub_rn(__fadd_rn(area_a, area_b), inter);
  return uni > 0.0f ? __fdiv_rn(inter, uni) : 0.0f;
}

// An image's count, held to [0, N]: the wrapper does not read the counts
// back from the card, so the kernels bound them.
__device__ __forceinline__ int64_t scan_count(const int32_t* counts,
                                              int64_t b, int64_t n) {
  const int64_t k = counts[b];
  return k < 0 ? 0 : (k > n ? n : k);
}

__global__ void nms_mask_kernel(const float4* __restrict__ boxes,
                                const int32_t* __restrict__ labels,
                                bool sorted_runs,
                                const int32_t* __restrict__ counts,
                                u64* __restrict__ mask, int64_t n,
                                int64_t win, float threshold) {
  const int64_t b = blockIdx.z, rb = blockIdx.x;
  const int64_t k = scan_count(counts, b, n);
  const int64_t r0 = rb * kBlock;
  if (r0 >= k) return;
  __shared__ float4 cols[kBlock];
  __shared__ float col_area[kBlock];
  __shared__ int32_t col_label[kBlock];
  const int t = threadIdx.x;
  const int64_t i = r0 + t;
  const bool row = i < k;
  float4 a = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  float area_a = 0.0f;
  int32_t label = 0;
  if (row) {
    a = boxes[b * n + i];
    area_a = area(a);
    label = labels ? labels[b * n + i] : 0;
  }
  // with sorted runs, the row tile's largest label (its last row's)
  const int32_t last =
      sorted_runs ? labels[b * n + min(r0 + kBlock, k) - 1] : 0;
  u64* out = mask + b * win * n;
  for (int64_t cb = rb + blockIdx.y; cb * kBlock < k && cb - rb < win;
       cb += gridDim.y) {
    const int64_t j0 = cb * kBlock;
    // labels ascend: no later column tile shares a label either (uniform)
    if (sorted_runs && labels[b * n + j0] > last) break;
    __syncthreads();  // the previous tile's reads are done
    if (j0 + t < k) {
      cols[t] = boxes[b * n + j0 + t];
      col_area[t] = area(cols[t]);
      col_label[t] = labels ? labels[b * n + j0 + t] : 0;
    }
    __syncthreads();
    if (!row) continue;
    const int hi = (int)min((int64_t)kBlock, k - j0);
    u64 bits = 0;
    for (int c = 0; c < hi; ++c) {
      if (j0 + c <= i) continue;
      const float v = (labels && col_label[c] != label)
                          ? 0.0f
                          : iou(a, area_a, cols[c], col_area[c]);
      if (v > threshold) bits |= 1ull << c;
    }
    out[(cb - rb) * n + i] = bits;
  }
}

// The end of the run that starts at s: the first position past s whose
// label differs (the labels ascend), or k.  Warp-collective.
__device__ __forceinline__ int64_t run_end(const int32_t* __restrict__ lab,
                                           int64_t s, int64_t k) {
  const int lane = threadIdx.x & 31;
  const int32_t v = lab[s];
  for (int64_t q = s + 1; q < k; q += 4 * 32) {
    int32_t x[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int64_t p = q + u * 32 + lane;
      x[u] = p < k ? lab[p] : v;
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const unsigned m = __ballot_sync(kFull, x[u] != v);
      if (m) return q + u * 32 + (__ffs(m) - 1);
    }
  }
  return k;
}

// The OR of word w of the rows base + j for each bit j of `kept`, kLoads
// loads in flight; 0 for a lane without a word (`mine` false).
__device__ __forceinline__ u64 or_rows(const u64* __restrict__ col,
                                       int64_t base, u64 kept, bool mine) {
  u64 acc = 0;
  while (kept) {  // uniform: kept is the warp's
    u64 v[kLoads];
#pragma unroll
    for (int u = 0; u < kLoads; ++u) {
      const int j = kept ? __ffsll((long long)kept) - 1 : -1;
      kept &= kept - 1;
      v[u] = (mine && j >= 0) ? __ldg(col + base + j) : 0ull;
    }
#pragma unroll
    for (int u = 0; u < kLoads; ++u) acc |= v[u];
  }
  return acc;
}

// Word w of the rows base + j for each bit j of `kept`, ORed into `acc`,
// where the window holds no such word: the IoUs of each of those rows with
// the boxes w * 64 .. of the run (ending at e), as nms_mask_kernel computes
// them (`lab`: the labels to compare, or null), skipping boxes already set
// in `acc`.  A lane's own loop: no warp-collective step.  Not inlined:
// off the main path, its registers stay out of the scan's.
__device__ __noinline__ u64 far_bits(const float4* __restrict__ bx,
                        const int32_t* __restrict__ lab, int64_t base,
                        u64 kept, int64_t w, int64_t e, float threshold,
                        u64 acc) {
  const int64_t q0 = w * kBlock;
  const int hi = (int)min((int64_t)kBlock, e - q0);
  while (kept) {
    const int64_t r = base + __ffsll((long long)kept) - 1;
    kept &= kept - 1;
    const float4 a = bx[r];
    const float area_a = area(a);
    const int32_t la = lab ? lab[r] : 0;
    for (int c = 0; c < hi; ++c) {
      if ((acc >> c) & 1ull) continue;
      const float4 q = bx[q0 + c];
      const float v = (lab && lab[q0 + c] != la) ? 0.0f
                                                  : iou(a, area_a, q, area(q));
      if (v > threshold) acc |= 1ull << c;
    }
  }
  return acc;
}

// One warp's greedy walk over the run [s, e) of image b (`img`: the image's
// mask window, [d][row]; `bx`, `lab`: its boxes and the labels to compare
// or null, for the words past the window).  kRegs: the run spans at most 32
// words and lane l holds removed word w0 + l in a register; else `rem` (the
// warp's shared memory, one word a word of the run) holds them.
template <bool kRegs>
__device__ void scan_run(const u64* __restrict__ img,
                         const float4* __restrict__ bx,
                         const int32_t* __restrict__ lab,
                         const int64_t* __restrict__ perm,
                         uint8_t* __restrict__ keep, int64_t n, int64_t win,
                         float threshold, int64_t s, int64_t e, u64* rem) {
  const int lane = threadIdx.x & 31;
  const int64_t w0 = s / kBlock, w1 = (e - 1) / kBlock;
  u64 reg = 0;
  if (!kRegs) {
    for (int64_t w = w0 + lane; w <= w1; w += 32) rem[w - w0] = 0;
    __syncwarp();
  }
  // row c * 64 + h * 32 + lane's word c (its window's first) where that
  // row is in the run (and the row's place in the caller's order), else 0
  // (-1)
  auto diag = [&](int64_t c, int h, int64_t& to) -> u64 {
    const int64_t i = c * kBlock + h * 32 + lane;
    const bool in = i >= s && i < e;
    to = in ? (perm ? perm[i] : i) : -1;
    return in ? img[i] : 0ull;
  };
  int64_t to0, to1;
  u64 d0 = diag(w0, 0, to0), d1 = diag(w0, 1, to1);
  for (int64_t c = w0; c <= w1; ++c) {
    u64 cur = kRegs ? __shfl_sync(kFull, reg, (int)(c - w0)) : rem[c - w0];
    const int64_t base = c * kBlock;
    const int lo = (int)(max(s, base) - base);
    const int hi = (int)(min(e, base + kBlock) - base);
    u64 kept = 0;
#pragma unroll 8
    for (int j = lo; j < hi; ++j) {  // uniform
      const u64 dj = __shfl_sync(kFull, j < 32 ? d0 : d1, j & 31);
      if (!((cur >> j) & 1ull)) {
        kept |= 1ull << j;
        cur |= dj;
      }
    }
    if (to0 >= 0) keep[to0] = (uint8_t)((kept >> lane) & 1ull);
    if (to1 >= 0) keep[to1] = (uint8_t)((kept >> (32 + lane)) & 1ull);
    if (c < w1) {  // the next word's diagonal, ahead of this word's ORs
      d0 = diag(c + 1, 0, to0);
      d1 = diag(c + 1, 1, to1);
    }
    if (c == w1 || !kept) continue;  // uniform
    if (kRegs) {  // the run's words all lie in the window
      const int64_t w = w0 + lane;
      const bool mine = w > c && w <= w1;
      reg |= or_rows(img + (mine ? w - c : 0) * n, base, kept, mine);
    } else {
      // every lane runs the same trip count
      for (int64_t w = c + 1 + lane; w - lane <= w1; w += 32) {
        const bool mine = w <= w1;
        if (mine && w - c >= win) {
          rem[w - w0] = far_bits(bx, lab, base, kept, w, e, threshold,
                                 rem[w - w0]);
        } else {
          const u64 acc =
              or_rows(img + (mine ? w - c : 0) * n, base, kept, mine);
          if (mine) rem[w - w0] |= acc;
        }
      }
      __syncwarp();
    }
  }
}

// 64 registers a thread at most: 32 warps a block
__global__ void __launch_bounds__(kWarps * 32)
    nms_scan_kernel(const u64* __restrict__ mask,
                                const float4* __restrict__ boxes,
                                const int32_t* __restrict__ labels,
                                const int32_t* __restrict__ counts,
                                const int64_t* __restrict__ perm,
                                uint8_t* __restrict__ keep, int64_t n,
                                int64_t words, int64_t win,
                                float threshold) {
  extern __shared__ u64 rem_all[];  // a region of `words` words a warp
  __shared__ int next_chunk;
  const int64_t b = blockIdx.x;
  const int64_t k = scan_count(counts, b, n);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int64_t* p = perm ? perm + b * n : nullptr;
  uint8_t* kb = keep + b * n;
  for (int64_t i = k + threadIdx.x; i < n; i += blockDim.x)
    kb[p ? p[i] : i] = 0;  // past the count: not kept
  if (threadIdx.x == 0) next_chunk = 0;
  __syncthreads();
  const u64* img = mask + b * win * n;
  const float4* bx = boxes + b * n;
  // with perm, labels ascend and mark the runs; without, the one run's
  // pairs compare them
  const int32_t* lab = (labels && p) ? labels + b * n : nullptr;
  const int32_t* cmp = (labels && !p) ? labels + b * n : nullptr;
  u64* rem = rem_all + (size_t)warp * words;
  for (;;) {
    int ch = 0;
    if (lane == 0) ch = atomicAdd(&next_chunk, 1);
    ch = __shfl_sync(kFull, ch, 0);
    const int64_t p0 = (int64_t)ch * 32;
    if (p0 >= k) break;
    const int64_t q = p0 + lane;
    const bool start =
        q < k && (q == 0 || (lab != nullptr && lab[q] != lab[q - 1]));
    unsigned starts = __ballot_sync(kFull, start);
    while (starts) {  // the runs that start in this chunk
      const int64_t s = p0 + (__ffs(starts) - 1);
      starts &= starts - 1;
      const int64_t e = lab ? run_end(lab, s, k) : k;
      if ((e - 1) / kBlock - s / kBlock < 32)
        scan_run<true>(img, bx, cmp, p, kb, n, win, threshold, s, e, rem);
      else
        scan_run<false>(img, bx, cmp, p, kb, n, win, threshold, s, e, rem);
    }
  }
}

}  // namespace

extern "C" {

// labels: int32 (B, N) or null; perm: int64 (B, N) or null, given where
// the wrapper reordered each image's prefix by label (labels ascend along
// it; perm maps a position of that order to the caller's), which needs
// labels; mask: (B, win, N) 8-byte scratch, win = min(ceil(N / 64), 32).
int dt_nms(const void* boxes, const void* labels, const void* counts,
           const void* perm, void* mask, void* keep, int64_t batch,
           int64_t n, float threshold, cudaStream_t stream) {
  if (batch == 0 || n == 0) return 0;
  if (perm != nullptr && labels == nullptr) return (int)cudaErrorInvalidValue;
  const int64_t words = (n + kBlock - 1) / kBlock;
  const int64_t win = words < kWin ? words : kWin;
  if (batch > 65535 || words > 0x7fffffff) return (int)cudaErrorInvalidValue;
  const unsigned groups = (unsigned)(win < kGroups ? win : kGroups);
  nms_mask_kernel<<<dim3((unsigned)words, groups, (unsigned)batch), kBlock,
                    0, stream>>>(
      static_cast<const float4*>(boxes), static_cast<const int32_t*>(labels),
      perm != nullptr, static_cast<const int32_t*>(counts),
      static_cast<u64*>(mask), n, win, threshold);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  // runs spanning more than 32 words keep their removed words in shared
  // memory, `words` of them a warp; fewer warps where they would not fit
  int warps = kWarps;
  size_t smem = 0;
  if (words > 32) {
    const size_t cap = 227 * 1024;
    const size_t per = (size_t)words * sizeof(u64);
    if (per > cap) return (int)cudaErrorInvalidValue;
    if ((size_t)warps * per > cap) warps = (int)(cap / per);
    smem = (size_t)warps * per;
    if (smem > 48 * 1024) {
      err = cudaFuncSetAttribute(nms_scan_kernel,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 (int)smem);
      if (err != cudaSuccess) return (int)err;
    }
  }
  nms_scan_kernel<<<(unsigned)batch, warps * 32, smem, stream>>>(
      static_cast<const u64*>(mask), static_cast<const float4*>(boxes),
      static_cast<const int32_t*>(labels),
      static_cast<const int32_t*>(counts),
      static_cast<const int64_t*>(perm), static_cast<uint8_t*>(keep), n,
      words, win, threshold);
  return (int)cudaGetLastError();
}

DT_CUDA_ERROR_STRING

}  // extern "C"
