// Inference BatchNorm (+ optional ReLU) over the (rows, C) view of an NHWC
// activation: y = x * scale + bias, then y < 0 ? 0 : y.
//
// Replaces the Pallas TPU kernel `_bn_act_kernel` driven by
// `fused_bn_inference` (dt_tpu/ops/pallas/kernels.py:43,52).  The wrapper
// (dt_tpu_torch/ops/kernels.py) precomputes scale = gamma * rsqrt(var + eps)
// and bias = beta - mean * gamma * rsqrt(var + eps) in f32 and casts them to
// x's dtype, exactly as the TPU wrapper does.
//
// Bound: bytes.  One multiply, one add and a compare per element against
// 2 * rows * C * itemsize bytes moved (x read once, y written once; scale and
// bias are C elements each), far below the H100's 295 operations per byte,
// so the least time is those bytes over 3.35 TB/s.  The design therefore only
// tries to move each byte once at full width:
//   - threadIdx.x walks channel vectors, so neighbouring threads touch
//     neighbouring 16-byte vectors of a row (coalesced); threadIdx.y and a
//     grid-stride loop walk rows.  Each thread keeps its channels' scale and
//     bias in registers for all of its rows.
//   - 16-byte vector loads and stores when C * itemsize is a multiple of 16
//     and every pointer is 16-byte aligned (every ResNet BN); a scalar path
//     otherwise (C = 3, odd widths, offset views).
//   - No row padding: the loops stop at `rows`, so a ragged tail costs
//     nothing (the TPU kernel padded to whole 256-row blocks).
//
// Rounding follows eager PyTorch's `x * scale + bias`, so the kernel and the
// plain version agree bit for bit: the product is rounded, then the sum.
// __fmul_rn/__fadd_rn keep nvcc from contracting them into one FMA; in bf16
// each step is computed in f32 and rounded to bf16 (round to nearest even).
// ReLU keeps NaN, as jnp.maximum(y, 0) does.

#include "common.cuh"

namespace {

using dt::Pack;
using dt::from_float;
using dt::round_as;
using dt::to_float;

// grid.y * block.x covers the channel vectors, grid.x * block.y the rows.
template <typename T, int VEC>
__global__ void bn_act_kernel(const T* __restrict__ x,
                              const T* __restrict__ scale,
                              const T* __restrict__ bias, T* __restrict__ y,
                              int64_t rows, int64_t vecs_per_row, bool relu) {
  using P = Pack<T, VEC>;
  const P* xp = reinterpret_cast<const P*>(x);
  P* yp = reinterpret_cast<P*>(y);
  for (int64_t cv = blockIdx.y * (int64_t)blockDim.x + threadIdx.x;
       cv < vecs_per_row; cv += (int64_t)gridDim.y * blockDim.x) {
    float s[VEC], b[VEC];
#pragma unroll
    for (int k = 0; k < VEC; ++k) {
      s[k] = to_float(scale[cv * VEC + k]);
      b[k] = to_float(bias[cv * VEC + k]);
    }
    for (int64_t r = blockIdx.x * (int64_t)blockDim.y + threadIdx.y; r < rows;
         r += (int64_t)gridDim.x * blockDim.y) {
      const int64_t i = r * vecs_per_row + cv;
      P in = xp[i];
      P out;
#pragma unroll
      for (int k = 0; k < VEC; ++k) {
        float p = round_as<T>(__fmul_rn(to_float(in.v[k]), s[k]));
        float v = round_as<T>(__fadd_rn(p, b[k]));
        if (relu && v < 0.0f) v = 0.0f;
        out.v[k] = from_float<T>(v);
      }
      yp[i] = out;
    }
  }
}

template <typename T, int VEC>
cudaError_t launch(const void* x, const void* scale, const void* bias, void* y,
                   int64_t rows, int64_t channels, bool relu,
                   cudaStream_t stream) {
  const int64_t vecs = channels / VEC;
  const int bx = vecs < 256 ? (int)vecs : 256;
  const int by = 256 / bx;
  int64_t gx = (rows + by - 1) / by;
  if (gx > 65535) gx = 65535;  // the row loop covers the rest
  int64_t gy = (vecs + bx - 1) / bx;
  if (gy > 65535) gy = 65535;  // the channel loop covers the rest
  bn_act_kernel<T, VEC><<<dim3((unsigned)gx, (unsigned)gy), dim3(bx, by), 0,
                          stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(scale),
      static_cast<const T*>(bias), static_cast<T*>(y), rows, vecs, relu);
  return cudaGetLastError();
}

using dt::aligned16;

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16.  x and y are contiguous (rows, channels);
// scale and bias are (channels,) of the same dtype.  Launches on `stream` and
// returns the launch's cudaError_t (0 on success); rows and channels > 0.
int dt_bn_act(const void* x, const void* scale, const void* bias, void* y,
              int64_t rows, int64_t channels, int dtype, int relu,
              void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int itemsize = dtype == 0 ? 4 : 2;
  const bool vec = (channels * itemsize) % 16 == 0 && aligned16(x) &&
                   aligned16(y) && aligned16(scale) && aligned16(bias);
  if (dtype == 0) {
    return vec ? launch<float, 4>(x, scale, bias, y, rows, channels, relu, s)
               : launch<float, 1>(x, scale, bias, y, rows, channels, relu, s);
  }
  if (dtype == 1) {
    return vec ? launch<__nv_bfloat16, 8>(x, scale, bias, y, rows, channels,
                                          relu, s)
               : launch<__nv_bfloat16, 1>(x, scale, bias, y, rows, channels,
                                          relu, s);
  }
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"

DT_CUDA_ERROR_STRING
