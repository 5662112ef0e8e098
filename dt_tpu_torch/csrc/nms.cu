// Greedy non-max suppression over score-sorted boxes, one scan an image.
//
// Input: boxes (B, N, 4) f32, each image's boxes sorted best score first;
// optional labels (B, N) int32 in the same order; counts (B,) int32, the
// number of boxes an image scans (those above the score threshold, a prefix
// of the order).  Output: keep (B, N) bytes, 1 for a box kept, 0 for a box
// suppressed or past its image's count.  Box i is kept unless a kept box
// j < i overlaps it: (same label or no labels ? IoU(i, j) : 0) > threshold.
//
// Replaces the greedy scan of `nms` (dt_tpu/ops/detection.py:141-169), a
// lax.fori_loop over an N x N IoU matrix there, with no Pallas kernel
// behind it; eager PyTorch would need a host round trip a box.
//
// Two kernels, one launch of each a call:
//   - mask: block (cb, rb, b) of 64 threads compares 64 row boxes of image b
//     with 64 column boxes (in shared memory) and writes, for row i, one
//     64-bit word of the boxes j > i it overlaps.  Only the upper triangle
//     of words below the image's count is written; the scan reads no other.
//   - scan: one block an image keeps the "removed" bits of every box in
//     shared memory and walks the boxes in order; a box whose bit is clear
//     is kept and ORs its row of words into them.  The bit a box reads is
//     the same for every thread, so the branch is uniform and a suppressed
//     box costs no barrier.
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
// mask words are scratch); the least time is the larger of those over the
// card's f32 rate and its memory rate.  The mask kernel compares every pair
// of an image, cross-label pairs included, and the scan is a serial chain
// of kept boxes, each waiting for its row's words, which no bound counts.

#include "common.cuh"

namespace {

constexpr int kBlock = 64;  // boxes a block side, bits a word

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
                                const int32_t* __restrict__ counts,
                                unsigned long long* __restrict__ mask,
                                int64_t n, int64_t words, float threshold) {
  const int64_t b = blockIdx.z;
  const int64_t cb = blockIdx.x, rb = blockIdx.y;
  const int64_t k = scan_count(counts, b, n);
  if (cb < rb || rb * kBlock >= k || cb * kBlock >= k) return;
  __shared__ float4 cols[kBlock];
  __shared__ float col_area[kBlock];
  __shared__ int32_t col_label[kBlock];
  const int64_t j0 = cb * kBlock;
  const int t = threadIdx.x;
  if (j0 + t < k) {
    cols[t] = boxes[b * n + j0 + t];
    col_area[t] = area(cols[t]);
    col_label[t] = labels ? labels[b * n + j0 + t] : 0;
  }
  __syncthreads();
  const int64_t i = rb * kBlock + t;
  if (i >= k) return;
  const float4 a = boxes[b * n + i];
  const float area_a = area(a);
  const int32_t label = labels ? labels[b * n + i] : 0;
  const int64_t hi = min((int64_t)kBlock, k - j0);
  unsigned long long bits = 0;
  for (int64_t c = 0; c < hi; ++c) {
    if (j0 + c <= i) continue;
    float v = iou(a, area_a, cols[c], col_area[c]);
    if (labels && col_label[c] != label) v = 0.0f;
    if (v > threshold) bits |= 1ull << c;
  }
  mask[(b * n + i) * words + cb] = bits;
}

__global__ void nms_scan_kernel(const unsigned long long* __restrict__ mask,
                                const int32_t* __restrict__ counts,
                                uint8_t* __restrict__ keep, int64_t n,
                                int64_t words) {
  extern __shared__ unsigned long long removed[];
  const int64_t b = blockIdx.x;
  const int64_t k = scan_count(counts, b, n);
  const int64_t used = (k + kBlock - 1) / kBlock;
  for (int64_t w = threadIdx.x; w < used; w += blockDim.x) removed[w] = 0;
  for (int64_t i = threadIdx.x; i < n; i += blockDim.x) keep[b * n + i] = 0;
  __syncthreads();
  for (int64_t i = 0; i < k; ++i) {
    if ((removed[i / kBlock] >> (i % kBlock)) & 1ull) continue;  // uniform
    __syncthreads();  // every thread has read bit i before any word changes
    if (threadIdx.x == 0) keep[b * n + i] = 1;
    const unsigned long long* row = mask + (b * n + i) * words;
    for (int64_t w = i / kBlock + threadIdx.x; w < used; w += blockDim.x)
      removed[w] |= row[w];
    __syncthreads();
  }
}

}  // namespace

extern "C" {

// mask: (B, N, words) 8-byte scratch, words = ceil(N / 64).
int dt_nms(const void* boxes, const void* labels, const void* counts,
           void* mask, void* keep, int64_t batch, int64_t n, float threshold,
           cudaStream_t stream) {
  if (batch == 0 || n == 0) return 0;
  const int64_t words = (n + kBlock - 1) / kBlock;
  if (words > 65535 || batch > 65535) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)words * sizeof(unsigned long long);
  if (smem > 48 * 1024) return (int)cudaErrorInvalidValue;
  nms_mask_kernel<<<dim3((unsigned)words, (unsigned)words, (unsigned)batch),
                    kBlock, 0, stream>>>(
      static_cast<const float4*>(boxes), static_cast<const int32_t*>(labels),
      static_cast<const int32_t*>(counts),
      static_cast<unsigned long long*>(mask), n, words, threshold);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int threads = words < 32 ? 32 : (words > 256 ? 256 : (int)words);
  nms_scan_kernel<<<(unsigned)batch, threads, smem, stream>>>(
      static_cast<const unsigned long long*>(mask),
      static_cast<const int32_t*>(counts), static_cast<uint8_t*>(keep), n,
      words);
  return (int)cudaGetLastError();
}

DT_CUDA_ERROR_STRING

}  // extern "C"
