// Flash attention forward: softmax(q k^T * scale) v with an online softmax
// over key tiles, f32 accumulators, optional causal mask; writes the output
// in q's dtype and the per-row logsumexp in f32.
//
// Replaces the Pallas TPU kernel `_attn_kernel` run by `_flash_fwd_pallas`
// for `flash_attention` (dt_tpu/ops/pallas/attention.py:40,100,213).  It
// computes what that kernel computes, not its block structure:
//   - the TPU grid (batch*heads, q blocks, kv blocks) runs its kv axis in
//     order with the running max, sum and accumulator in VMEM scratch; here
//     one CUDA block owns BQ = 64 query rows of one (batch, head) and loops
//     over the key tiles itself, the running max, sum and accumulator of
//     each row in registers;
//   - each tile is scored, then m_new = max(m, rowmax), p = exp(s - m_new),
//     corr = exp(m - m_new), l = l * corr + sum(p), acc = acc * corr + p v,
//     as the TPU kernel does per kv block; q, k and v are read in their dtype
//     and upcast to f32, as the TPU kernel upcasts them;
//   - masked scores are -1e30 (finite, as on the TPU, so exp(-1e30 - m) is
//     0 and never NaN); under `causal` the tiles past the block's last query
//     row are skipped; at the end l is clamped at 1e-30, out = acc / l and
//     lse = m + log(l).  The lse is (B*H, S), not the TPU's 128-lane
//     broadcast.
//
// Bound: operations.  At the main path's shape (B*H = 64, S = 2048, D = 64,
// causal) a call does 4 * B*H * D * S(S+1)/2 = 34.4 GFLOP against 67 MB of
// q, k, v and out in bf16, far above the H100's ~295 operations per byte, so
// its least time is those operations at the tensor cores' 989 TFLOP/s (bf16)
// or the CUDA cores' 67 TFLOP/s (f32 without TF32).  This first kernel does
// its arithmetic on the CUDA cores in f32 and is far from that bound; the
// design only keeps the CUDA cores fed:
//   - K and V tiles (BK = 32 keys) are staged in shared memory as f32, read
//     back as 16-byte float4s; every thread of a tile reads the same key
//     (a broadcast), so four FMAs cost one shared-memory load;
//   - D / 32 neighbouring threads share a query row, each holding 32 of its
//     dims (groups of 4 interleaved so that neighbouring threads read
//     neighbouring banks); a row's dot product is closed by an xor butterfly
//     over those lanes, whose sums every lane forms in the same order, so
//     all of them hold the same score;
//   - the causal skip halves the work, as on the TPU.
// Tensor-core tiles (mma.sync / wgmma), TMA and warp specialisation are the
// redesign's work.  No atomics: two launches give the same bits.
//
// expf/logf and the division are the correctly rounded (non fast-math)
// versions: nvcc is run without --use_fast_math.

#include "common.cuh"

namespace {

using dt::from_float;
using dt::to_float;

constexpr float NEG_INF = -1e30f;
constexpr int BQ = 64;  // query rows per block
constexpr int BK = 32;  // keys per shared-memory tile
constexpr int DPT = 32; // dims of a row per thread (8 float4 groups)
constexpr int G = DPT / 4;

struct Strides {  // element strides of a (B, S, H, D) tensor, D's is 1
  int64_t b, s, h;
};

template <typename T>
__device__ __forceinline__ float4 load4(const T* p) {
  return make_float4(to_float(p[0]), to_float(p[1]), to_float(p[2]),
                     to_float(p[3]));
}

__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

__device__ __forceinline__ void axpy4(float p, float4 v, float4& acc) {
  acc.x = fmaf(p, v.x, acc.x);
  acc.y = fmaf(p, v.y, acc.y);
  acc.z = fmaf(p, v.z, acc.z);
  acc.w = fmaf(p, v.w, acc.w);
}

// grid (ceil(sq / BQ), batch * heads); block BQ * (D / 32) threads.
template <typename T, int D>
__global__ void __launch_bounds__(BQ * (D / DPT))
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ out,
                     float* __restrict__ lse, int heads, int sq, int sk,
                     Strides qs, Strides ks, Strides vs, float scale,
                     bool causal) {
  constexpr int TPR = D / DPT;  // threads per query row
  constexpr int D4 = D / 4;
  __shared__ float4 k_tile[BK][D4];
  __shared__ float4 v_tile[BK][D4];

  const int tid = threadIdx.x;
  const int t = tid % TPR;  // this thread's share of the row's dims
  const int bh = blockIdx.y;
  const int b = bh / heads, h = bh % heads;
  const int q0 = blockIdx.x * BQ;
  const int qi = q0 + tid / TPR;
  const bool live = qi < sq;

  float4 qr[G], acc[G];
  const T* qrow = q + b * qs.b + h * qs.h + (int64_t)qi * qs.s;
#pragma unroll
  for (int g = 0; g < G; ++g) {
    qr[g] = live ? load4(qrow + 4 * (t + TPR * g)) : make_float4(0, 0, 0, 0);
    acc[g] = make_float4(0, 0, 0, 0);
  }
  float m = NEG_INF, l = 0.0f;

  const int n_kt = (sk + BK - 1) / BK;
  const int kt_end = causal ? min(n_kt, (q0 + BQ - 1) / BK + 1) : n_kt;
  const T* kbase = k + b * ks.b + h * ks.h;
  const T* vbase = v + b * vs.b + h * vs.h;

  for (int kt = 0; kt < kt_end; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // every thread is done with the previous tile
    for (int idx = tid; idx < BK * D4; idx += blockDim.x) {
      const int j = idx / D4, c = idx % D4;
      const int key = k0 + j;
      float4 kv = make_float4(0, 0, 0, 0), vv = make_float4(0, 0, 0, 0);
      if (key < sk) {
        kv = load4(kbase + (int64_t)key * ks.s + 4 * c);
        vv = load4(vbase + (int64_t)key * vs.s + 4 * c);
      }
      k_tile[j][c] = kv;
      v_tile[j][c] = vv;
    }
    __syncthreads();

    float s[BK];
    float m_cur = NEG_INF;
#pragma unroll
    for (int j = 0; j < BK; ++j) {
      float part = 0.0f;
#pragma unroll
      for (int g = 0; g < G; ++g) part = dot4(qr[g], k_tile[j][t + TPR * g],
                                              part);
#pragma unroll
      for (int off = TPR / 2; off > 0; off >>= 1)
        part += __shfl_xor_sync(0xffffffffu, part, off);
      const int key = k0 + j;
      float sc = part * scale;
      if (key >= sk || (causal && key > qi)) sc = NEG_INF;
      s[j] = sc;
      m_cur = fmaxf(m_cur, sc);
    }
    const float m_new = fmaxf(m, m_cur);
    const float corr = expf(m - m_new);
    float psum = 0.0f;
#pragma unroll
    for (int j = 0; j < BK; ++j) {
      s[j] = expf(s[j] - m_new);
      psum += s[j];
    }
    l = l * corr + psum;
#pragma unroll
    for (int g = 0; g < G; ++g) {
      acc[g].x *= corr;
      acc[g].y *= corr;
      acc[g].z *= corr;
      acc[g].w *= corr;
    }
#pragma unroll
    for (int j = 0; j < BK; ++j) {
#pragma unroll
      for (int g = 0; g < G; ++g) axpy4(s[j], v_tile[j][t + TPR * g], acc[g]);
    }
    m = m_new;
  }

  if (!live) return;
  const float lc = fmaxf(l, 1e-30f);
  T* orow = out + (((int64_t)b * sq + qi) * heads + h) * D;
#pragma unroll
  for (int g = 0; g < G; ++g) {
    T* o = orow + 4 * (t + TPR * g);
    o[0] = from_float<T>(acc[g].x / lc);
    o[1] = from_float<T>(acc[g].y / lc);
    o[2] = from_float<T>(acc[g].z / lc);
    o[3] = from_float<T>(acc[g].w / lc);
  }
  if (t == 0) lse[(int64_t)bh * sq + qi] = m + logf(lc);
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   void* lse, int64_t batch, int64_t heads, int64_t sq,
                   int64_t sk, Strides qs, Strides ks, Strides vs, float scale,
                   bool causal, cudaStream_t stream) {
  const dim3 grid((unsigned)((sq + BQ - 1) / BQ), (unsigned)(batch * heads));
  flash_fwd_kernel<T, D><<<grid, BQ * (D / DPT), 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out),
      static_cast<float*>(lse), (int)heads, (int)sq, (int)sk, qs, ks, vs,
      scale, causal);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(int64_t d, const void* q, const void* k, const void* v,
                     void* out, void* lse, int64_t batch, int64_t heads,
                     int64_t sq, int64_t sk, Strides qs, Strides ks,
                     Strides vs, float scale, bool causal,
                     cudaStream_t stream) {
  switch (d) {
    case 32:
      return launch<T, 32>(q, k, v, out, lse, batch, heads, sq, sk, qs, ks,
                           vs, scale, causal, stream);
    case 64:
      return launch<T, 64>(q, k, v, out, lse, batch, heads, sq, sk, qs, ks,
                           vs, scale, causal, stream);
    case 128:
      return launch<T, 128>(q, k, v, out, lse, batch, heads, sq, sk, qs, ks,
                            vs, scale, causal, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// q, k, v: (batch, sq|sk, heads, d) with element strides (b, s, h) each and
// stride 1 along d; out: contiguous (batch, sq, heads, d) of their dtype;
// lse: contiguous f32 (batch * heads, sq).  dtype: 0 = float32, 1 =
// bfloat16; d is 32, 64 or 128; batch * heads <= 65535; sq, sk >= 1.
// Launches on `stream` and returns the launch's cudaError_t (0 on success).
int dt_flash_attn_fwd(const void* q, const void* k, const void* v, void* out,
                      void* lse, int64_t batch, int64_t heads, int64_t sq,
                      int64_t sk, int64_t d, int64_t qsb, int64_t qss,
                      int64_t qsh, int64_t ksb, int64_t kss, int64_t ksh,
                      int64_t vsb, int64_t vss, int64_t vsh, float scale,
                      int causal, int dtype, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (batch * heads > 65535 || batch * heads < 1 || sq < 1 || sk < 1 ||
      sq > 0x7fffffff || sk > 0x7fffffff)
    return (int)cudaErrorInvalidValue;
  const Strides qs{qsb, qss, qsh}, ks{ksb, kss, ksh}, vs{vsb, vss, vsh};
  if (dtype == 0)
    return dispatch<float>(d, q, k, v, out, lse, batch, heads, sq, sk, qs,
                           ks, vs, scale, causal != 0, s);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(d, q, k, v, out, lse, batch, heads, sq,
                                   sk, qs, ks, vs, scale, causal != 0, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"

DT_CUDA_ERROR_STRING
