// int8 x int8 -> int32 convolution as an implicit GEMM, with the float
// epilogue of the JAX package's quantized_conv2d / quantized_dense fused:
//
//   acc[m, n] = sum_k A[m, k] * B[k, n]                       (int32)
//   out[m, n] = cast<T>(__fadd_rn(__fdiv_rn(__int2float_rn(acc), d), bias[n]))
//
// over NHWC input x (batch, H, W, C) and HWIO weights w (KH, KW, C, N):
// m runs over the output pixels (batch, OH, OW), k = (ky * KW + kx) * C + c
// over the filter taps, and A[m, k] is the input pixel the tap sees, zero
// outside the padded image.  B is w itself: HWIO is already K x N row-major.
// d is x_scale * w_scale (one f32 in device memory, read by every thread,
// so no scale crosses to the host), the bias is
// optional, T is float or bfloat16 (__float2bfloat16_rn).  Each step is the
// correctly rounded op the JAX code applies in that order (acc.astype(f32),
// /, +, astype), so the output is bit-equal to the plain version's.
// quantized_dense is the 1x1, stride-1 case over (M, 1, 1, K).
//
// Replaces no Pallas kernel: the JAX package computes both functions with
// lax.conv_general_dilated / lax.dot_general and
// preferred_element_type=int32 (dt_tpu/ops/quantization.py:52,65), which
// XLA lowers to the TPU's int8 matrix unit.  PyTorch has no int8
// convolution on CUDA and its int8 matmul (torch._int_mm) takes only some
// shapes, so this kernel is the port's path for both functions.
//
// Bound: operations (2 M N K at the H100's 1,979 dense int8 TOP/s) for the
// wide layers, bytes (x, w and the output once each over 3.35 TB/s) for
// the thin ones.  The design is the simple one: a block computes a 128 x 64
// tile of the output with 8 warps (4 along M x 2 along N, 32 x 32 each) on
// mma.sync m16n8k32 s8 (the int8 tensor-core instruction of sm_80+; wgmma
// with s8 and TMA loads are later work).  Each 64-deep step of K gathers the
// A tile (128 pixels x 64 taps) into shared memory, 16 bytes a load where C
// is a multiple of 16 (16 taps then share one pixel and lie contiguous in
// memory), byte by byte otherwise (the stem's C = 3), and the B tile (64
// taps x 64 channels), transposed in shared memory for the .col operand.
// Rows of both tiles are 80 bytes apart, so the fragment loads of a warp
// hit 32 distinct banks.  Taps past K and pixels in the padding are int8
// zeros: exact, because the quantization is symmetric (no zero point).
// Domain: K <= 133,144, so 127^2 K fits in int32 (the wrapper refuses more).

#include "common.cuh"

namespace {

constexpr int BM = 128, BN = 64, BK = 64;
constexpr int kThreads = 256;
constexpr int LDS = BK + 16;  // bytes between rows of a shared tile

struct Geo {
  int64_t batch, h, w, c;  // input (NHWC)
  int kh, kw, oh, ow, n;   // filter, output pixels, output channels
  int sh, sw, ph, pw;      // strides, low pads
  int64_t m, k;            // GEMM rows (batch * OH * OW) and depth
};

__device__ __forceinline__ void mma_s8(int (&acc)[4], const unsigned (&a)[4],
                                       const unsigned (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(acc[0]), "+r"(acc[1]), "+r"(acc[2]), "+r"(acc[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

union Pack16 {  // 16 int8 values, as one 16-byte load or store
  int4 v;
  int8_t b[16];
};

__device__ __forceinline__ unsigned lds32(const int8_t* p) {
  return *reinterpret_cast<const unsigned*>(p);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    qconv_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
                 const float* __restrict__ bias,
                 const float* __restrict__ divisor, T* __restrict__ out,
                 Geo g, bool vec_a, bool vec_b) {
  __shared__ __align__(16) int8_t As[BM * LDS];
  __shared__ __align__(16) int8_t Bs[BN * LDS];
  const int tid = threadIdx.x;
  const int64_t m0 = (int64_t)blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;

  // A tile: thread tid fills 16 bytes at column kc of rows tid / 4 and
  // tid / 4 + 64; their pixels are fixed for the whole K loop.
  const int kc = (tid & 3) * 16;
  int64_t img[2];
  int iy0[2], ix0[2];
  bool row_ok[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int64_t m = m0 + (tid >> 2) + 64 * i;
    row_ok[i] = m < g.m;
    const int64_t mm = row_ok[i] ? m : 0;
    const int64_t per_img = (int64_t)g.oh * g.ow;
    img[i] = mm / per_img;
    const int rem = (int)(mm - img[i] * per_img);
    const int oy = rem / g.ow, ox = rem - (rem / g.ow) * g.ow;
    iy0[i] = oy * g.sh - g.ph;
    ix0[i] = ox * g.sw - g.pw;
  }
  // B tile: thread tid reads 16 channels of tap row kb.
  const int kb = tid >> 2, nb = (tid & 3) * 16;

  const int warp = tid >> 5, lane = tid & 31;
  const int wm = (warp & 3) * 32, wn = (warp >> 2) * 32;
  const int gr = lane >> 2, tq = lane & 3;
  int acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

  for (int64_t k0 = 0; k0 < g.k; k0 += BK) {
    // --- gather A: 128 pixels x 64 taps -------------------------------
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      int4 v = make_int4(0, 0, 0, 0);
      const int64_t k = k0 + kc;
      if (vec_a) {  // C % 16 == 0: the 16 taps share one pixel
        if (row_ok[i] && k < g.k) {
          const int64_t tap = k / g.c;
          const int64_t ci = k - tap * g.c;
          const int fy = (int)(tap / g.kw), fx = (int)(tap - fy * g.kw);
          const int iy = iy0[i] + fy, ix = ix0[i] + fx;
          if (iy >= 0 && iy < g.h && ix >= 0 && ix < g.w)
            v = *reinterpret_cast<const int4*>(
                x + ((img[i] * g.h + iy) * g.w + ix) * g.c + ci);
        }
      } else {
        Pack16 p;
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          int8_t val = 0;
          const int64_t kj = k + j;
          if (row_ok[i] && kj < g.k) {
            const int64_t tap = kj / g.c;
            const int64_t ci = kj - tap * g.c;
            const int fy = (int)(tap / g.kw), fx = (int)(tap - fy * g.kw);
            const int iy = iy0[i] + fy, ix = ix0[i] + fx;
            if (iy >= 0 && iy < g.h && ix >= 0 && ix < g.w)
              val = x[((img[i] * g.h + iy) * g.w + ix) * g.c + ci];
          }
          p.b[j] = val;
        }
        v = p.v;
      }
      *reinterpret_cast<int4*>(As + ((tid >> 2) + 64 * i) * LDS + kc) = v;
    }
    // --- B: 64 taps x 64 channels, stored transposed (channel-major) --
    {
      Pack16 p;
      const int64_t k = k0 + kb;
      if (vec_b) {  // N % 16 == 0
        p.v = make_int4(0, 0, 0, 0);
        if (k < g.k && n0 + nb < g.n)
          p.v = *reinterpret_cast<const int4*>(w + k * g.n + n0 + nb);
      } else {
#pragma unroll
        for (int j = 0; j < 16; ++j)
          p.b[j] = (k < g.k && n0 + nb + j < g.n) ? w[k * g.n + n0 + nb + j]
                                                  : (int8_t)0;
      }
#pragma unroll
      for (int j = 0; j < 16; ++j) Bs[(nb + j) * LDS + kb] = p.b[j];
    }
    __syncthreads();

    // --- 2 x 32 deep steps of mma.sync m16n8k32 -----------------------
#pragma unroll
    for (int ks = 0; ks < BK; ks += 32) {
      unsigned a[2][4], bf[4][2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int8_t* p = As + (wm + i * 16 + gr) * LDS + ks + tq * 4;
        a[i][0] = lds32(p);
        a[i][1] = lds32(p + 8 * LDS);
        a[i][2] = lds32(p + 16);
        a[i][3] = lds32(p + 8 * LDS + 16);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int8_t* p = Bs + (wn + j * 8 + gr) * LDS + ks + tq * 4;
        bf[j][0] = lds32(p);
        bf[j][1] = lds32(p + 16);
      }
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) mma_s8(acc[i][j], a[i], bf[j]);
    }
    __syncthreads();
  }

  // --- epilogue: the JAX order, each op correctly rounded -------------
  const float d = *divisor;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int64_t m = m0 + wm + i * 16 + gr + (e >> 1) * 8;
        const int n = n0 + wn + j * 8 + tq * 2 + (e & 1);
        if (m < g.m && n < g.n) {
          float v = __fdiv_rn(__int2float_rn(acc[i][j][e]), d);
          if (bias != nullptr) v = __fadd_rn(v, bias[n]);
          out[m * g.n + n] = dt::from_float<T>(v);
        }
      }
}

}  // namespace

extern "C" {

// x: contiguous int8 (batch, h, w, c); wt: contiguous int8 (kh, kw, c, n);
// bias: n floats or null; divisor: one float; out: contiguous (batch, oh,
// ow, n) of dtype (0 = float32, 1 = bfloat16).  ph, pw are the low pads (the high pads
// follow from oh, ow).  batch * oh * ow > 0, n > 0, kh * kw * c > 0.
// Launches on `stream`; returns the launch's cudaError_t.
int dt_qconv(const void* x, const void* wt, const void* bias,
             const void* divisor, void* out, int64_t batch, int64_t h,
             int64_t w, int64_t c, int kh, int kw, int n, int oh, int ow,
             int sh, int sw, int ph, int pw, int dtype, void* stream) {
  Geo g{batch, h, w, c, kh, kw, oh, ow, n, sh, sw, ph, pw,
        batch * oh * ow, (int64_t)kh * kw * c};
  const bool vec_a = (c % 16 == 0) && dt::aligned16(x);
  const bool vec_b = (n % 16 == 0) && dt::aligned16(wt);
  const dim3 grid((unsigned)((g.m + BM - 1) / BM),
                  (unsigned)((n + BN - 1) / BN));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int8_t* xp = static_cast<const int8_t*>(x);
  const int8_t* wp = static_cast<const int8_t*>(wt);
  const float* bp = static_cast<const float*>(bias);
  const float* dp = static_cast<const float*>(divisor);
  if (dtype == 1)
    qconv_kernel<__nv_bfloat16><<<grid, kThreads, 0, s>>>(
        xp, wp, bp, dp, static_cast<__nv_bfloat16*>(out), g, vec_a, vec_b);
  else
    qconv_kernel<float><<<grid, kThreads, 0, s>>>(
        xp, wp, bp, dp, static_cast<float*>(out), g, vec_a, vec_b);
  return (int)cudaGetLastError();
}

}  // extern "C"

DT_CUDA_ERROR_STRING
