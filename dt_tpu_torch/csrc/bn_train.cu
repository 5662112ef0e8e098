// Training BatchNorm, pass 1: per-channel batch mean and variance over the
// (rows, C) view of an NHWC activation, as float32:
//   mean = sum(x) / n,  var = max(sum(x*x) / n - mean*mean, 0).
//
// Replaces the Pallas TPU kernel `_bn_partials_kernel` and the reduction
// after it in `_bn_train_fwd_impl` (dt_tpu/ops/pallas/kernels.py:101,107-140),
// the first of `fused_bn_train`'s two passes.  Pass 2 (normalize) is the
// bn_act kernel of bn_act.cu, called by the wrapper with scale and bias made
// from this pass's mean and var, as the TPU wrapper calls `_bn_act_kernel`.
// The variance is E[x^2] - mean^2 clamped at 0, not Welford: the TPU kernel's
// formula is the oracle.
//
// Bound: bytes.  x is read once (rows * C * itemsize bytes) for two adds and
// a multiply per element, far below the H100's 295 operations per byte, so
// the least time is those bytes over 3.35 TB/s.  The design:
//   - threadIdx.x walks 16-byte channel vectors (coalesced rows), threadIdx.y
//     and blockIdx.x walk rows; each thread keeps f32 sums for its channels
//     in registers over many rows, so x is read once at full width;
//   - no float atomics: each block writes its partial sums to scratch, and a
//     second small kernel adds the partials of each channel in a fixed order
//     (a warp per channel, then a fixed butterfly), so the same input gives
//     the same bits on every launch;
//   - no row padding: the loops stop at `rows`.
// The partials are nblk * C * 8 bytes; the wrapper picks nblk so that they
// stay a small fraction of x at the shapes of a ResNet.

#include "common.cuh"

namespace {

using dt::Pack;
using dt::to_float;

constexpr int kThreads = 256;

// grid = (nblk, ceil(vecs / blockDim.x)); block = (bx, by), bx * by <= 256.
// Block b sums rows [b * rows_per_block, (b + 1) * rows_per_block).
template <typename T, int VEC>
__global__ void bn_partials_kernel(const T* __restrict__ x,
                                   float* __restrict__ psum,
                                   float* __restrict__ psq, int64_t rows,
                                   int64_t vecs_per_row,
                                   int64_t rows_per_block) {
  __shared__ float sh_s[kThreads * VEC];
  __shared__ float sh_q[kThreads * VEC];
  using P = Pack<T, VEC>;
  const P* xp = reinterpret_cast<const P*>(x);
  const int64_t cv = blockIdx.y * (int64_t)blockDim.x + threadIdx.x;
  const int64_t r0 = blockIdx.x * rows_per_block;
  const int64_t r1 = r0 + rows_per_block < rows ? r0 + rows_per_block : rows;
  float s[VEC], q[VEC];
#pragma unroll
  for (int k = 0; k < VEC; ++k) s[k] = q[k] = 0.0f;
  if (cv < vecs_per_row) {
#pragma unroll 4
    for (int64_t r = r0 + threadIdx.y; r < r1; r += blockDim.y) {
      const P in = xp[r * vecs_per_row + cv];
#pragma unroll
      for (int k = 0; k < VEC; ++k) {
        const float v = to_float(in.v[k]);
        s[k] = __fadd_rn(s[k], v);
        q[k] = __fmaf_rn(v, v, q[k]);
      }
    }
  }
  const int slot = (threadIdx.y * blockDim.x + threadIdx.x) * VEC;
#pragma unroll
  for (int k = 0; k < VEC; ++k) {
    sh_s[slot + k] = s[k];
    sh_q[slot + k] = q[k];
  }
  __syncthreads();
  if (threadIdx.y != 0 || cv >= vecs_per_row) return;
  // row 0 of the block adds the other rows' sums in order: fixed, so the
  // result does not depend on scheduling
  for (int ty = 1; ty < (int)blockDim.y; ++ty) {
    const int o = (ty * blockDim.x + threadIdx.x) * VEC;
#pragma unroll
    for (int k = 0; k < VEC; ++k) {
      s[k] = __fadd_rn(s[k], sh_s[o + k]);
      q[k] = __fadd_rn(q[k], sh_q[o + k]);
    }
  }
  const int64_t channels = vecs_per_row * VEC;
  float* ps = psum + blockIdx.x * channels + cv * VEC;
  float* pq = psq + blockIdx.x * channels + cv * VEC;
#pragma unroll
  for (int k = 0; k < VEC; ++k) {
    ps[k] = s[k];
    pq[k] = q[k];
  }
}

// One warp per channel: lane l adds the partials of blocks l, l + 32, ... in
// order, then a fixed butterfly over the lanes; lane 0 forms mean and var.
__global__ void bn_finalize_kernel(const float* __restrict__ psum,
                                   const float* __restrict__ psq,
                                   int64_t nblk, int64_t channels, float n,
                                   float* __restrict__ mean,
                                   float* __restrict__ var) {
  const int64_t c = blockIdx.x * (int64_t)blockDim.y + threadIdx.y;
  if (c >= channels) return;  // whole warps leave together
  float s = 0.0f, q = 0.0f;
  for (int64_t b = threadIdx.x; b < nblk; b += 32) {
    s = __fadd_rn(s, psum[b * channels + c]);
    q = __fadd_rn(q, psq[b * channels + c]);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    s = __fadd_rn(s, __shfl_xor_sync(0xffffffffu, s, off));
    q = __fadd_rn(q, __shfl_xor_sync(0xffffffffu, q, off));
  }
  if (threadIdx.x != 0) return;
  const float m = __fdiv_rn(s, n);
  float v = __fsub_rn(__fdiv_rn(q, n), __fmul_rn(m, m));
  if (v < 0.0f) v = 0.0f;  // keeps NaN, as jnp.maximum(v, 0) does
  mean[c] = m;
  var[c] = v;
}

template <typename T, int VEC>
cudaError_t launch(const void* x, float* psum, float* psq, float* mean,
                   float* var, int64_t rows, int64_t channels, int64_t nblk,
                   cudaStream_t stream) {
  const int64_t vecs = channels / VEC;
  const int bx = vecs < kThreads ? (int)vecs : kThreads;
  const int by = kThreads / bx;
  const int64_t gy = (vecs + bx - 1) / bx;
  const int64_t rows_per_block = (rows + nblk - 1) / nblk;
  bn_partials_kernel<T, VEC><<<dim3((unsigned)nblk, (unsigned)gy),
                               dim3(bx, by), 0, stream>>>(
      static_cast<const T*>(x), psum, psq, rows, vecs, rows_per_block);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int per_block = 8;  // channels (warps) per finalize block
  bn_finalize_kernel<<<(unsigned)((channels + per_block - 1) / per_block),
                       dim3(32, per_block), 0, stream>>>(
      psum, psq, nblk, channels, (float)rows, mean, var);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16.  x is contiguous (rows, channels);
// scratch holds 2 * nblk * channels floats; mean and var are (channels,)
// float32.  1 <= nblk <= 65535; rows, channels > 0.
// Launches two kernels on `stream` and returns the first failing launch's
// cudaError_t (0 on success).
int dt_bn_stats(const void* x, void* scratch, void* mean, void* var,
                int64_t rows, int64_t channels, int64_t nblk, int dtype,
                void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* psum = static_cast<float*>(scratch);
  float* psq = psum + nblk * channels;
  float* m = static_cast<float*>(mean);
  float* v = static_cast<float*>(var);
  const int itemsize = dtype == 0 ? 4 : 2;
  const bool vec = (channels * itemsize) % 16 == 0 && dt::aligned16(x);
  if (dtype == 0) {
    return vec ? launch<float, 4>(x, psum, psq, m, v, rows, channels, nblk, s)
               : launch<float, 1>(x, psum, psq, m, v, rows, channels, nblk,
                                  s);
  }
  if (dtype == 1) {
    return vec ? launch<__nv_bfloat16, 8>(x, psum, psq, m, v, rows, channels,
                                          nblk, s)
               : launch<__nv_bfloat16, 1>(x, psum, psq, m, v, rows, channels,
                                          nblk, s);
  }
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"

DT_CUDA_ERROR_STRING
