// The pointwise stage of an LSTM cell, after the gate matmuls: from the f32
// gate pre-activations (B, 4H) in order i, f, g, o and the cell state c (B,
// H),
//   c' = sigmoid(f) * c + sigmoid(i) * tanh(g),   h' = sigmoid(o) * tanh(c'),
// with h' in f32 and c' in c's dtype (f32 or bf16).
//
// Replaces the Pallas TPU kernel `_lstm_point_kernel` run by
// `_lstm_pointwise_fwd` for `lstm_pointwise` (dt_tpu/ops/pallas/kernels.py:
// 319,349,330).  The TPU kernel tiles whole rows of 256 into VMEM and pads a
// ragged batch; here one thread owns one (row, j < H) and the grid-stride
// loop stops at B * H, so a ragged B costs no padding copy.
//
// Bound: bytes.  A call reads 4H gates and H of c and writes 2H per row,
// 28 * B * H bytes in f32 (0.18 MB at B = 32, H = 200: ~0.05 us at
// 3.35 TB/s), with ~20 operations per element.  The LM runs it once per time
// step and layer, so its time is the launch floor, not its bytes; the design
// only reads each byte once, coalesced: neighbouring threads take
// neighbouring j, so each of the four gate columns j, H+j, 2H+j, 3H+j and c
// is read by a warp as one run of consecutive words.  A persistent cell over
// the time steps is later work.
//
// Rounding follows the plain PyTorch version op by op: sigmoid is
// 1 / (1 + exp(-x)) and tanh is tanhf, both the correctly rounded (non
// fast-math) library versions; __fmul_rn / __fadd_rn keep nvcc from fusing
// f * c + i * g into FMAs the plain version does not have.

#include "common.cuh"

namespace {

using dt::from_float;
using dt::to_float;

__device__ __forceinline__ float sigmoid(float x) {
  return 1.0f / (1.0f + expf(-x));
}

template <typename C>
__global__ void lstm_point_kernel(const float* __restrict__ gates,
                                  const C* __restrict__ c,
                                  float* __restrict__ h_out,
                                  C* __restrict__ c_out, int64_t rows,
                                  int64_t hidden) {
  const int64_t n = rows * hidden;
  for (int64_t idx = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; idx < n;
       idx += (int64_t)gridDim.x * blockDim.x) {
    const int64_t r = idx / hidden, j = idx - r * hidden;
    const float* g = gates + r * 4 * hidden + j;
    const float i = sigmoid(g[0]);
    const float f = sigmoid(g[hidden]);
    const float gg = tanhf(g[2 * hidden]);
    const float o = sigmoid(g[3 * hidden]);
    const float cn =
        __fadd_rn(__fmul_rn(f, to_float(c[idx])), __fmul_rn(i, gg));
    h_out[idx] = __fmul_rn(o, tanhf(cn));
    c_out[idx] = from_float<C>(cn);
  }
}

template <typename C>
cudaError_t launch(const void* gates, const void* c, void* h_out, void* c_out,
                   int64_t rows, int64_t hidden, cudaStream_t stream) {
  constexpr int threads = 256;
  int64_t blocks = (rows * hidden + threads - 1) / threads;
  if (blocks > 65535) blocks = 65535;  // the grid-stride loop does the rest
  lstm_point_kernel<C><<<(unsigned)blocks, threads, 0, stream>>>(
      static_cast<const float*>(gates), static_cast<const C*>(c),
      static_cast<float*>(h_out), static_cast<C*>(c_out), rows, hidden);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// gates: contiguous f32 (rows, 4 * hidden); c and c_out: contiguous (rows,
// hidden) of c_dtype (0 = float32, 1 = bfloat16); h_out: contiguous f32
// (rows, hidden).  rows, hidden > 0.  Launches on `stream` and returns the
// launch's cudaError_t (0 on success).
int dt_lstm_point(const void* gates, const void* c, void* h_out, void* c_out,
                  int64_t rows, int64_t hidden, int c_dtype, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (c_dtype == 0)
    return launch<float>(gates, c, h_out, c_out, rows, hidden, s);
  if (c_dtype == 1)
    return launch<__nv_bfloat16>(gates, c, h_out, c_out, rows, hidden, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"

DT_CUDA_ERROR_STRING
