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
// the least time is those bytes over 3.35 TB/s.  One launch does it all:
//   - the grid is (channel slices, row blocks); threadIdx.x walks 16-byte
//     channel vectors of the slice (coalesced rows); the threads of a block
//     take rows round-robin across the whole grid, so that its blocks read
//     neighbouring rows at the same time, four or eight loads in flight a
//     thread (rows past the end read as 0); each thread keeps f32 sums of its
//     channels in registers, then the block adds them in a fixed tree and
//     writes them as its partials;
//   - the block that draws the last ticket of its slice (an integer
//     atomicAdd between __threadfences, so every other block's partials are
//     visible to it) adds the slice's partials in row-block order, its
//     threads walking channels (coalesced), writes mean and var, and resets
//     the ticket to 0 for the next launch.  The ticket picks who adds, never
//     the order: no float atomics, and two launches give the same bits;
//   - the wrapper picks the geometry (ops/kernels.py `stats_geometry`): the
//     partials stay within 1/16 of x's bytes and within two rounds of loads
//     a thread of the last block; slices of 256 channels, or fewer, give
//     ~2 blocks an SM, all resident at once, so that few serial round trips
//     to memory remain.
// The tickets are one counter a slice, shared by every launch on the
// device: two launches must not run at once (the wrapper orders launches
// on different streams).  They reset themselves, so a CUDA graph of
// launches replays.

#include "common.cuh"

namespace {

using dt::from_float;
using dt::Pack;
using dt::to_float;

constexpr int kThreads = 256;
constexpr int kParts = 4;  // rows of partials a thread loads at once

template <int VEC>
struct Sums {
  float s[VEC], q[VEC];
};

// Block-wide sum of every thread's sums over threadIdx.y, in a fixed order
// (the same on every launch); the result lands in threadIdx.y == 0.  With
// g = ceil(sqrt(by)), thread y < g adds rows y, y + g, ... of the block,
// then row 0 adds those g sums: four barriers for any block shape.  sh
// holds 2 * VEC values a thread, value-major, so that neighbouring threads
// touch neighbouring banks.
template <int VEC>
__device__ __forceinline__ void block_sum(Sums<VEC>& a, float* sh) {
  const int bx = blockDim.x, by = blockDim.y, n = bx * by;
  if (by == 1) return;
  int g = 1;
  while (g * g < by) ++g;
  const int tid = threadIdx.y * bx + threadIdx.x;
#pragma unroll
  for (int k = 0; k < VEC; ++k) {
    sh[k * n + tid] = a.s[k];
    sh[(VEC + k) * n + tid] = a.q[k];
  }
  __syncthreads();
  if (threadIdx.y < g) {
    for (int y = threadIdx.y + g; y < by; y += g) {
      const int o = y * bx + threadIdx.x;
#pragma unroll
      for (int k = 0; k < VEC; ++k) {
        a.s[k] = __fadd_rn(a.s[k], sh[k * n + o]);
        a.q[k] = __fadd_rn(a.q[k], sh[(VEC + k) * n + o]);
      }
    }
  }
  __syncthreads();
  if (threadIdx.y > 0 && threadIdx.y < g) {
#pragma unroll
    for (int k = 0; k < VEC; ++k) {
      sh[k * n + tid] = a.s[k];
      sh[(VEC + k) * n + tid] = a.q[k];
    }
  }
  __syncthreads();
  if (threadIdx.y == 0) {
    for (int y = 1; y < g; ++y) {
      const int o = y * bx + threadIdx.x;
#pragma unroll
      for (int k = 0; k < VEC; ++k) {
        a.s[k] = __fadd_rn(a.s[k], sh[k * n + o]);
        a.q[k] = __fadd_rn(a.q[k], sh[(VEC + k) * n + o]);
      }
    }
  }
  __syncthreads();  // sh is free again
}

// VEC floats of a partial row, through L2 (other blocks wrote them), or 0
// past the last row: adding +0 leaves a sum's bits as they are.
template <int VEC>
__device__ __forceinline__ void load_partial(const float* p, bool valid,
                                             float (&v)[VEC]) {
  if constexpr (VEC % 4 == 0) {
#pragma unroll
    for (int k = 0; k < VEC; k += 4) {
      const float4 f = valid
                           ? __ldcg(reinterpret_cast<const float4*>(p + k))
                           : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      v[k] = f.x;
      v[k + 1] = f.y;
      v[k + 2] = f.z;
      v[k + 3] = f.w;
    }
  } else {
#pragma unroll
    for (int k = 0; k < VEC; ++k) v[k] = valid ? __ldcg(p + k) : 0.0f;
  }
}

// grid = (slices, row_blocks); block = (bx, by), bx * by <= kThreads; bx
// vectors of VEC channels a slice.  Thread (tx, ty) of block (sl, rb) takes
// channel vector sl * bx + tx of rows rb * by + ty + j * row_blocks * by, j
// = 0, 1, ...: the grid's blocks read neighbouring rows at the same time.
// With more than one row block, part holds row_blocks x C sums, then as
// many sums of squares, and tickets one zeroed counter a slice, left zeroed.
template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
    bn_stats_kernel(const T* __restrict__ x, float* __restrict__ part,
                    unsigned* __restrict__ tickets, float* __restrict__ mean,
                    float* __restrict__ var, int64_t rows, int vecs_per_row) {
  __shared__ float sh[2 * kThreads * VEC];
  __shared__ bool last;
  using P = Pack<T, VEC>;
  const P* xp = reinterpret_cast<const P*>(x);
  const int by = blockDim.y;
  const int cv = blockIdx.x * blockDim.x + threadIdx.x;
  const bool live = cv < vecs_per_row;
  const int64_t channels = (int64_t)vecs_per_row * VEC;
  const int rb = blockIdx.y, nrb = gridDim.y;
  const int64_t stride = (int64_t)nrb * by;
  // rows of x a thread loads at once: eight 16-byte loads of f32, four of
  // bf16, whose eight values each take registers once converted (more
  // would take registers, and so resident blocks)
  constexpr int ROWS = VEC == 8 ? 4 : 8;

  Sums<VEC> a;
  P zero;
#pragma unroll
  for (int k = 0; k < VEC; ++k) {
    a.s[k] = a.q[k] = 0.0f;
    zero.v[k] = from_float<T>(0.0f);
  }
  if (live) {
    // ROWS loads in flight, rows past the end read as 0 (+0 changes no sum)
    for (int64_t r = (int64_t)rb * by + threadIdx.y; r < rows;
         r += ROWS * stride) {
      P in[ROWS];
#pragma unroll
      for (int u = 0; u < ROWS; ++u) {
        const int64_t ru = r + u * stride;
        in[u] = ru < rows ? xp[ru * vecs_per_row + cv] : zero;
      }
#pragma unroll
      for (int u = 0; u < ROWS; ++u) {
#pragma unroll
        for (int k = 0; k < VEC; ++k) {
          const float v = to_float(in[u].v[k]);
          a.s[k] = __fadd_rn(a.s[k], v);
          a.q[k] = __fmaf_rn(v, v, a.q[k]);
        }
      }
    }
  }
  block_sum(a, sh);

  if (nrb > 1) {
    // publish this block's sums, then draw a ticket of the slice
    float* ps = part + cv * VEC;
    float* pq = ps + nrb * channels;
    if (threadIdx.y == 0 && live) {
#pragma unroll
      for (int k = 0; k < VEC; ++k) {
        ps[rb * channels + k] = a.s[k];
        pq[rb * channels + k] = a.q[k];
      }
    }
    // the barrier orders the block's stores before thread 0's fence, which
    // releases them with the ticket (and acquires the others' for the last)
    __syncthreads();
    if (threadIdx.x == 0 && threadIdx.y == 0) {
      __threadfence();
      last = atomicAdd(&tickets[blockIdx.x], 1u) == (unsigned)(nrb - 1);
      if (last) {
        tickets[blockIdx.x] = 0u;  // every other block has drawn
        __threadfence();
      }
    }
    __syncthreads();
    if (!last) return;

    // the slice's last block: thread y adds row blocks y, y + by, ... in
    // order, then the fixed tree
#pragma unroll
    for (int k = 0; k < VEC; ++k) a.s[k] = a.q[k] = 0.0f;
    if (live) {
      for (int b = threadIdx.y; b < nrb; b += kParts * by) {
        float s[kParts][VEC], q[kParts][VEC];
#pragma unroll
        for (int u = 0; u < kParts; ++u) {
          const int bu = b + u * by;
          load_partial<VEC>(ps + bu * channels, bu < nrb, s[u]);
          load_partial<VEC>(pq + bu * channels, bu < nrb, q[u]);
        }
#pragma unroll
        for (int u = 0; u < kParts; ++u) {
#pragma unroll
          for (int k = 0; k < VEC; ++k) {
            a.s[k] = __fadd_rn(a.s[k], s[u][k]);
            a.q[k] = __fadd_rn(a.q[k], q[u][k]);
          }
        }
      }
    }
    block_sum(a, sh);
  }

  if (threadIdx.y != 0 || !live) return;
  const float n = (float)rows;
#pragma unroll
  for (int k = 0; k < VEC; ++k) {
    const float m = __fdiv_rn(a.s[k], n);
    float v = __fsub_rn(__fdiv_rn(a.q[k], n), __fmul_rn(m, m));
    if (v < 0.0f) v = 0.0f;  // keeps NaN, as jnp.maximum(v, 0) does
    mean[cv * VEC + k] = m;
    var[cv * VEC + k] = v;
  }
}

template <typename T, int VEC>
cudaError_t launch(const void* x, float* part, unsigned* tickets, float* mean,
                   float* var, int64_t rows, int64_t channels, int bx, int by,
                   int slices, int row_blocks, cudaStream_t stream) {
  bn_stats_kernel<T, VEC><<<dim3((unsigned)slices, (unsigned)row_blocks),
                            dim3(bx, by), 0, stream>>>(
      static_cast<const T*>(x), part, tickets, mean, var, rows,
      (int)(channels / VEC));
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16.  x is contiguous (rows, channels),
// 16-byte aligned when vec > 1; vec (channels a thread loads at once) is 1,
// or 16 bytes of x's dtype when channels * itemsize is a multiple of 16.
// The launch: grid (slices, row_blocks), block (bx, by), bx * by <= 256,
// bx * slices * vec >= channels.  scratch holds 2 * row_blocks * channels
// floats (none when row_blocks == 1), tickets `slices` zeroed unsigned
// counters, left zeroed; mean and var are (channels,) float32.
// Launches one kernel on `stream` and returns its cudaError_t (0 on
// success).
int dt_bn_stats(const void* x, void* scratch, void* tickets, void* mean,
                void* var, int64_t rows, int64_t channels, int dtype, int vec,
                int bx, int by, int slices, int row_blocks, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* part = static_cast<float*>(scratch);
  unsigned* t = static_cast<unsigned*>(tickets);
  float* m = static_cast<float*>(mean);
  float* v = static_cast<float*>(var);
  const int want_vec = dtype == 0 ? 4 : 8;
  if (rows < 1 || channels < 1 || bx < 1 || by < 1 || bx * by > kThreads ||
      slices < 1 || row_blocks < 1 || row_blocks > 65535 ||
      channels % vec != 0 || (int64_t)bx * slices * vec < channels ||
      (vec != 1 && (vec != want_vec || !dt::aligned16(x))))
    return (int)cudaErrorInvalidValue;
  if (dtype == 0) {
    return vec == 1 ? launch<float, 1>(x, part, t, m, v, rows, channels, bx,
                                       by, slices, row_blocks, s)
                    : launch<float, 4>(x, part, t, m, v, rows, channels, bx,
                                       by, slices, row_blocks, s);
  }
  if (dtype == 1) {
    return vec == 1 ? launch<__nv_bfloat16, 1>(x, part, t, m, v, rows,
                                               channels, bx, by, slices,
                                               row_blocks, s)
                    : launch<__nv_bfloat16, 8>(x, part, t, m, v, rows,
                                               channels, bx, by, slices,
                                               row_blocks, s);
  }
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"

DT_CUDA_ERROR_STRING
