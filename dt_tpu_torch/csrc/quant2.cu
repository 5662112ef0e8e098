// 2-bit gradient quantization with error feedback, and its inverse.
//
// quantize: x = grad + residual (float32); code 1 if x >= t, 2 if x <= -t,
// else 0 (NaN gives 0); the new residual is x - decode(code), with decode
// 1 -> +t, 2 -> -t, 0 -> 0.  Sixteen codes pack into one 32-bit word,
// element 16w + i at bits 2i of word w; the last word's tail is zero.
// dequantize: word w's code i -> element 16w + i, codes 1 -> +t, 2 -> -t,
// 0 and 3 -> 0, trimmed to n elements.
//
// Replace the Pallas TPU kernels `_quant2_kernel` (driven by `quantize_2bit`)
// and `_dequant2_kernel` (driven by `dequantize_2bit`),
// dt_tpu/ops/pallas/kernels.py:233,251 and :284,293.  Words are int32 here
// and reinterpreted as uint32 at the numpy boundary, as the TPU kernel packs
// through int32.  Every result is bit-exact against the numpy oracle
// (dt_tpu/parallel/compression.py:75-119): each step is one correctly
// rounded float op (__fadd_rn, __fsub_rn) on the same values.
//
// Bound: bytes.  quantize reads grad and residual and writes the residual
// and the words, 12.25 bytes per element; dequantize reads 0.25 and writes
// 4.  A few compares per element are nothing against that, so the least
// time is the bytes over 3.35 TB/s.  The design moves each byte once, at
// full width: a thread takes four consecutive elements (one 16-byte load of
// each input and one 16-byte store, when aligned), so a warp reads 512
// contiguous bytes per access; four neighbouring lanes hold one word's 16
// codes and OR their bytes together with two shuffles, and the first of
// them writes the word.  No shared memory and no atomics.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ unsigned code_of(float x, float t) {
  return x >= t ? 1u : (x <= -t ? 2u : 0u);
}

__device__ __forceinline__ float decode(unsigned code, float t) {
  return code == 1u ? t : (code == 2u ? -t : 0.0f);
}

// Thread q takes elements [4q, 4q + 4); lanes 4j..4j+3 make word q / 4.
__global__ void quantize_kernel(const float* __restrict__ grad,
                                const float* __restrict__ residual,
                                int32_t* __restrict__ packed,
                                float* __restrict__ new_residual, int64_t n,
                                int64_t words, float t, bool vec) {
  const int64_t quads = words * 4;
  // the loop bound is a whole number of blocks, so every lane of a warp
  // runs every iteration and the shuffles see all 32 lanes
  const int64_t span = (quads + kThreads - 1) / kThreads * kThreads;
  const int64_t stride = (int64_t)gridDim.x * kThreads;
  for (int64_t base = (int64_t)blockIdx.x * kThreads; base < span;
       base += stride) {
    const int64_t q = base + threadIdx.x;
    const int64_t e = q * 4;
    unsigned bits = 0;
    if (vec && e + 4 <= n) {
      const float4 g = reinterpret_cast<const float4*>(grad)[q];
      const float4 r = reinterpret_cast<const float4*>(residual)[q];
      const float x0 = __fadd_rn(g.x, r.x), x1 = __fadd_rn(g.y, r.y);
      const float x2 = __fadd_rn(g.z, r.z), x3 = __fadd_rn(g.w, r.w);
      const unsigned c0 = code_of(x0, t), c1 = code_of(x1, t);
      const unsigned c2 = code_of(x2, t), c3 = code_of(x3, t);
      float4 o;
      o.x = __fsub_rn(x0, decode(c0, t));
      o.y = __fsub_rn(x1, decode(c1, t));
      o.z = __fsub_rn(x2, decode(c2, t));
      o.w = __fsub_rn(x3, decode(c3, t));
      reinterpret_cast<float4*>(new_residual)[q] = o;
      bits = c0 | (c1 << 2) | (c2 << 4) | (c3 << 6);
    } else if (q < quads) {
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        if (e + k < n) {
          const float x = __fadd_rn(grad[e + k], residual[e + k]);
          const unsigned c = code_of(x, t);
          new_residual[e + k] = __fsub_rn(x, decode(c, t));
          bits |= c << (2 * k);
        }
      }
    }
    bits <<= 8 * (q & 3);
    bits |= __shfl_xor_sync(0xffffffffu, bits, 1);
    bits |= __shfl_xor_sync(0xffffffffu, bits, 2);
    if (q < quads && (q & 3) == 0) packed[q >> 2] = (int32_t)bits;
  }
}

// Thread q writes elements [4q, 4q + 4) from byte q % 4 of word q / 4.
__global__ void dequantize_kernel(const int32_t* __restrict__ packed,
                                  float* __restrict__ out, int64_t n, float t,
                                  bool vec) {
  const int64_t quads = (n + 3) / 4;
  const int64_t stride = (int64_t)gridDim.x * kThreads;
  for (int64_t q = (int64_t)blockIdx.x * kThreads + threadIdx.x; q < quads;
       q += stride) {
    const unsigned bits = (unsigned)packed[q >> 2] >> (8 * (q & 3));
    const int64_t e = q * 4;
    if (vec && e + 4 <= n) {
      float4 o;
      o.x = decode(bits & 3u, t);
      o.y = decode((bits >> 2) & 3u, t);
      o.z = decode((bits >> 4) & 3u, t);
      o.w = decode((bits >> 6) & 3u, t);
      reinterpret_cast<float4*>(out)[q] = o;
    } else {
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        if (e + k < n) out[e + k] = decode((bits >> (2 * k)) & 3u, t);
      }
    }
  }
}

unsigned grid_for(int64_t quads) {
  const int64_t blocks = (quads + kThreads - 1) / kThreads;
  const int64_t cap = 132 * 16;  // enough blocks to fill the H100's 132 SMs
  return (unsigned)(blocks < cap ? blocks : cap);
}

}  // namespace

extern "C" {

// grad, residual and new_residual are n contiguous floats; packed holds
// ceil(n / 16) int32 words.  n > 0.  Returns the launch's cudaError_t.
int dt_quantize_2bit(const void* grad, const void* residual, void* packed,
                     void* new_residual, int64_t n, float threshold,
                     void* stream) {
  const int64_t words = (n + 15) / 16;
  const bool vec = dt::aligned16(grad) && dt::aligned16(residual) &&
                   dt::aligned16(new_residual);
  quantize_kernel<<<grid_for(words * 4), kThreads, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(grad), static_cast<const float*>(residual),
      static_cast<int32_t*>(packed), static_cast<float*>(new_residual), n,
      words, threshold, vec);
  return (int)cudaGetLastError();
}

// packed holds ceil(n / 16) int32 words; out is n contiguous floats.  n > 0.
int dt_dequantize_2bit(const void* packed, void* out, int64_t n,
                       float threshold, void* stream) {
  dequantize_kernel<<<grid_for((n + 3) / 4), kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(packed), static_cast<float*>(out), n,
      threshold, dt::aligned16(out));
  return (int)cudaGetLastError();
}

}  // extern "C"

DT_CUDA_ERROR_STRING
