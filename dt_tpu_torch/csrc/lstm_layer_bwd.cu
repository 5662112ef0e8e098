// The backward of one LSTM layer window (BPTT), for f32 and bf16: from the
// saved f32 pre-activations gates_t (T, B, 4H), the cell states c_t (T, B,
// H), c0 and Wh (H, 4H), and the gradients dhs, dcs (T, B, H) reaching h_t
// and c_t from outside, it walks from the last step processed to the first:
//   dG_t, dc_new = the cell's backward at (gates_t, c_{t-1}, dhs_t + dh,
//                  dcs_t + dc),     dc <- dc_new * f,     dh = dG_t Wh^T,
// and writes every dG_t (T, B, 4H) and the final dh, dc (the gradients of
// h0 and c0).  The weight gradients are products of dG with the saved
// inputs, done after the launch as plain matrix products.
//
// Replaces, on the path of `lstm` with the fused cell, the custom VJP of the
// Pallas TPU kernel `_lstm_point_kernel`: `_lstm_pointwise_bwd`
// (dt_tpu/ops/pallas/kernels.py:381-404), which the JAX package's autodiff
// of `lax.scan` (dt_tpu/ops/rnn.py:84-114) chains through the steps, one
// small kernel a step.  Here the chain is one launch a layer window; before
// it, the port's backward was a Python loop of ~18 launches a step.
//
// bf16 follows the roundings that autograd of the stepped bf16 cell makes:
// dhs_t + dh and dcs_t + dc are bf16 sums, the cell's backward runs in f32,
// dc and dG_t are rounded to bf16 (the cotangents of `.float()`), and dh is a
// bf16 product (f32 sums, rounded once).  f32 rounds nowhere but in f32.
//
// Bound: bytes, on paper.  A window reads the gates (4 B 4H a step, f32),
// c, dhs, dcs and writes dG (16 + 3 s + 4 s bytes per (row, unit) a step, s
// the element size) and does 2 T B 4H H operations (358 MFLOP at T 35, B
// 32, H 200: 5.3 us at the f32 67 TFLOP/s against ~12 MB, 3.6 us at 3.35
// TB/s).  As in the forward the steps are serial, and the design is the
// forward's cluster plan turned around:
//   - One cluster of n = min(16, H) blocks walks the steps for `rows` batch
//     rows (geometry from ops/kernels.py `layer_bwd_geometry`).  Block j
//     owns hidden units [j H / n, (j + 1) H / n): one thread a (row, unit)
//     keeps that unit's dh and dc in registers for the window and applies
//     the cell's backward to its four gates.
//   - It writes dG_t to memory and pushes its slice of dG_t into every
//     peer's buffer over distributed shared memory; the buffers hold the
//     whole dG_t of the cluster's rows (4H wide), double-buffered by the
//     step's parity, so one cluster barrier a step suffices.
//   - Then dh = dG_t Wh^T for the block's own units: Wh's rows of those
//     units sit in shared memory when they fit (H 200: 13 x 804 f32, 41.8
//     KB), else (H 650) they are read from L2; each thread forms a 4-row x
//     4-unit tile over one of KS slices of the 4H inputs (f32 FMAs in
//     ascending order, on the CUDA cores in both dtypes), and the owner adds
//     the KS partial tiles in slice order.
//   - The next step's gates, c_{t-1}, dhs and dcs are loaded into registers
//     before the barrier, so their latency hides behind the product.
// The cell's backward follows the plain version op by op (sigmoid as
// 1 / (1 + expf(-x)), tanhf, every product and sum by __fmul_rn /
// __fadd_rn / __fsub_rn in its order).  Every sum has a fixed order and
// there are no atomics: two launches give the same bits.

#include "common.cuh"

namespace {

using dt::from_float;
using dt::round_as;
using dt::to_float;

constexpr int NT = 512;     // threads a block
constexpr int PMAX = 4;     // (row, unit) pairs a thread at most
constexpr int KS_MAX = 32;  // slices of the 4H inputs

__host__ __device__ constexpr int round4(int v) { return (v + 3) / 4 * 4; }

// Shared-memory layout of one block; ops/kernels.py `_layer_bwd_bytes`
// computes the same total: two dG buffers (R x SC elements), Wh's rows of
// the block's units (U4 x SC) when `wsm`, KS partial tiles (R x U4 f32).
struct Geo {
  int per_max, U4, SC, RG, UG, tiles, KC;
  int dg_elems, w_elems, scr;
  int64_t bytes;
};

__host__ __device__ inline Geo make_geo(int H, int n, int R, int KS,
                                        bool wsm, int elem) {
  Geo g;
  g.per_max = (H + n - 1) / n;
  g.U4 = round4(g.per_max);
  g.SC = 4 * H + 4;
  g.RG = (R + 3) / 4;
  g.UG = g.U4 / 4;
  g.tiles = g.RG * g.UG;
  g.KC = round4((4 * H + KS - 1) / KS);
  g.dg_elems = R * g.SC;
  g.w_elems = wsm ? g.U4 * g.SC : 0;
  g.scr = KS * R * g.U4;
  g.bytes = (int64_t)elem * (2 * g.dg_elems + g.w_elems) + 4 * (int64_t)g.scr;
  return g;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(r));
  return r;
}

__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.release.aligned;\n"
      "barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

__device__ __forceinline__ uint32_t mapa(const void* local, uint32_t rank) {
  uint32_t remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
               : "=r"(remote)
               : "r"(smem_u32(local)), "r"(rank));
  return remote;
}

// Store v (already rounded to the element type) at the address of `local`
// in the shared memory of block `rank`.
__device__ __forceinline__ void st_peer(const float* local, uint32_t rank,
                                        float v) {
  asm volatile("st.shared::cluster.f32 [%0], %1;" ::"r"(mapa(local, rank)),
               "f"(v)
               : "memory");
}
__device__ __forceinline__ void st_peer(const __nv_bfloat16* local,
                                        uint32_t rank, float v) {
  const uint16_t bits = __bfloat16_as_ushort(__float2bfloat16_rn(v));
  asm volatile("st.shared::cluster.u16 [%0], %1;" ::"r"(mapa(local, rank)),
               "h"(bits)
               : "memory");
}

// Four consecutive elements as f32 (16-byte f32 or 8-byte bf16 loads).
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 v = *reinterpret_cast<const uint2*>(p);
  return make_float4(__uint_as_float(v.x << 16),
                     __uint_as_float(v.x & 0xffff0000u),
                     __uint_as_float(v.y << 16),
                     __uint_as_float(v.y & 0xffff0000u));
}
__device__ __forceinline__ float4 ldg4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}
__device__ __forceinline__ float4 ldg4(const __nv_bfloat16* p) {
  const uint2 v = __ldg(reinterpret_cast<const uint2*>(p));
  return make_float4(__uint_as_float(v.x << 16),
                     __uint_as_float(v.x & 0xffff0000u),
                     __uint_as_float(v.y << 16),
                     __uint_as_float(v.y & 0xffff0000u));
}

__device__ __forceinline__ float sigmoid(float x) {
  return 1.0f / (1.0f + expf(-x));
}

// What step i (the i-th processed backward) reads: the gates, c_{t-1}, and
// the outside gradients of h_t and c_t, of each of this thread's pairs.
template <typename T>
__device__ __forceinline__ void load_step(
    float (&gv)[PMAX][4], float (&cv)[PMAX], float (&oh)[PMAX],
    float (&oc)[PMAX], const float* __restrict__ gates,
    const T* __restrict__ cs, const T* __restrict__ c0,
    const T* __restrict__ dhs, const T* __restrict__ dcs, int i, int Tn,
    int B, int H, int row0, int u0, int per, int pairs, int tid,
    int reverse) {
  const int s = Tn - 1 - i;  // the forward's step index
  const int t = reverse ? Tn - 1 - s : s;
  const int tp = reverse ? t + 1 : t - 1;  // the step before, in time
#pragma unroll
  for (int q = 0; q < PMAX; ++q) {
    const int p = tid + q * NT;
    if (p < pairs) {
      const int r = p / per, u = p % per;
      const int64_t o = ((int64_t)t * B + row0 + r) * H + u0 + u;
      const float* g = gates + ((int64_t)t * B + row0 + r) * 4 * H + u0 + u;
#pragma unroll
      for (int gi = 0; gi < 4; ++gi) gv[q][gi] = __ldg(g + gi * H);
      cv[q] = to_float(s == 0 ? c0[(int64_t)(row0 + r) * H + u0 + u]
                              : cs[((int64_t)tp * B + row0 + r) * H + u0 +
                                   u]);
      oh[q] = to_float(dhs[o]);
      oc[q] = to_float(dcs[o]);
    }
  }
}

// grid: n * clusters blocks in clusters of n; NT threads; Geo::bytes of
// dynamic shared memory.  WSM: Wh's rows of the block's units in shared
// memory.
template <typename T, bool WSM>
__global__ void __launch_bounds__(NT, 1)
    lstm_layer_bwd_kernel(const float* __restrict__ gates,
                          const T* __restrict__ cs, const T* __restrict__ c0,
                          const T* __restrict__ wh,
                          const T* __restrict__ dhs,
                          const T* __restrict__ dcs, T* __restrict__ dgates,
                          T* __restrict__ dh0, T* __restrict__ dc0, int Tn,
                          int B, int H, int n, int R, int KS, int reverse) {
  extern __shared__ float4 smem4[];
  const Geo g = make_geo(H, n, R, KS, WSM, (int)sizeof(T));
  T* dg_buf = reinterpret_cast<T*>(smem4);                  // [2][R][SC]
  T* w_s = dg_buf + 2 * g.dg_elems;                         // [U4][SC]
  float* scr = reinterpret_cast<float*>(w_s + g.w_elems);   // [KS][R][U4]

  const int tid = threadIdx.x;
  const int j = (int)cluster_rank();
  const int row0 = (blockIdx.x / n) * R;
  const int rows = min(R, B - row0);
  const int u0 = j * H / n;
  const int per = (j + 1) * H / n - u0;
  const int H4g = 4 * H;
  const int pairs = rows * per;

  for (int i = tid; i < 2 * g.dg_elems; i += NT)
    dg_buf[i] = from_float<T>(0.0f);  // pad rows and columns stay 0
  if constexpr (WSM) {
    for (int i = tid; i < g.w_elems; i += NT) {
      const int u = i / g.SC, k = i % g.SC;
      w_s[i] = (u < per && k < H4g) ? wh[(int64_t)(u0 + u) * H4g + k]
                                    : from_float<T>(0.0f);
    }
  }

  // this thread's tile of the product: rows 4 rg .. 4 rg + 3, units
  // 4 ug .. 4 ug + 3, inputs [k0, k1)
  const bool computes = tid < g.tiles * KS;
  const int ug = tid % g.UG, rg = (tid / g.UG) % g.RG, ks = tid / g.tiles;
  const int k0 = min(ks * g.KC, H4g), k1 = min(k0 + g.KC, H4g);

  float dh[PMAX], dc[PMAX], gv[PMAX][4], cv[PMAX], oh[PMAX], oc[PMAX];
#pragma unroll
  for (int q = 0; q < PMAX; ++q) dh[q] = dc[q] = 0.0f;
  load_step<T>(gv, cv, oh, oc, gates, cs, c0, dhs, dcs, 0, Tn, B, H, row0,
               u0, per, pairs, tid, reverse);
  cluster_sync();  // every block has started

  for (int i = 0; i < Tn; ++i) {
    const int s = Tn - 1 - i;
    const int t = reverse ? Tn - 1 - s : s;
    T* dbuf = dg_buf + (i & 1) * g.dg_elems;
#pragma unroll
    for (int q = 0; q < PMAX; ++q) {
      const int p = tid + q * NT;
      if (p >= pairs) continue;
      const int r = p / per, u = p % per;
      const float gh = round_as<T>(__fadd_rn(oh[q], dh[q]));
      const float gc = round_as<T>(__fadd_rn(oc[q], dc[q]));
      const float ig = sigmoid(gv[q][0]);
      const float fg = sigmoid(gv[q][1]);
      const float gg = tanhf(gv[q][2]);
      const float og = sigmoid(gv[q][3]);
      const float c = cv[q];
      const float cn = __fadd_rn(__fmul_rn(fg, c), __fmul_rn(ig, gg));
      const float tc = tanhf(cn);
      const float dcn = __fadd_rn(
          gc, __fmul_rn(__fmul_rn(gh, og),
                        __fsub_rn(1.0f, __fmul_rn(tc, tc))));
      float dg[4];
      dg[0] = round_as<T>(__fmul_rn(__fmul_rn(__fmul_rn(dcn, gg), ig),
                                    __fsub_rn(1.0f, ig)));
      dg[1] = round_as<T>(__fmul_rn(__fmul_rn(__fmul_rn(dcn, c), fg),
                                    __fsub_rn(1.0f, fg)));
      dg[2] = round_as<T>(__fmul_rn(__fmul_rn(dcn, ig),
                                    __fsub_rn(1.0f, __fmul_rn(gg, gg))));
      dg[3] = round_as<T>(__fmul_rn(__fmul_rn(__fmul_rn(gh, tc), og),
                                    __fsub_rn(1.0f, og)));
      dc[q] = round_as<T>(__fmul_rn(dcn, fg));
      T* grow = dgates + ((int64_t)t * B + row0 + r) * H4g + u0 + u;
      const T* dst = dbuf + r * g.SC + u0 + u;
#pragma unroll
      for (int gi = 0; gi < 4; ++gi) {
        grow[gi * H] = from_float<T>(dg[gi]);
        for (int q2 = 0; q2 < n; ++q2)
          st_peer(dst + gi * H, (uint32_t)q2, dg[gi]);
      }
    }
    if (i + 1 < Tn)  // the next step's inputs, behind the barrier
      load_step<T>(gv, cv, oh, oc, gates, cs, c0, dhs, dcs, i + 1, Tn, B, H,
                   row0, u0, per, pairs, tid, reverse);
    cluster_sync();  // dG_t of every block is in every block

    if (computes) {
      float acc[4][4];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int b = 0; b < 4; ++b) acc[a][b] = 0.0f;
      bool live[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) live[a] = 4 * rg + a < rows;
      const T* db = dbuf + 4 * rg * g.SC;
      for (int k = k0; k < k1; k += 4) {
        float4 dv[4];
#pragma unroll
        for (int a = 0; a < 4; ++a)
          dv[a] = live[a] ? load4(db + a * g.SC + k)
                          : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          const int u = 4 * ug + b;
          float4 w;
          if constexpr (WSM)
            w = load4(w_s + u * g.SC + k);
          else
            w = u < per ? ldg4(wh + (int64_t)(u0 + u) * H4g + k)
                        : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll
          for (int a = 0; a < 4; ++a) {
            float v = acc[a][b];
            v = fmaf(dv[a].x, w.x, v);
            v = fmaf(dv[a].y, w.y, v);
            v = fmaf(dv[a].z, w.z, v);
            v = fmaf(dv[a].w, w.w, v);
            acc[a][b] = v;
          }
        }
      }
#pragma unroll
      for (int a = 0; a < 4; ++a)
        if (live[a])
#pragma unroll
          for (int b = 0; b < 4; ++b)
            scr[(ks * R + 4 * rg + a) * g.U4 + 4 * ug + b] = acc[a][b];
    }
    __syncthreads();
#pragma unroll
    for (int q = 0; q < PMAX; ++q) {
      const int p = tid + q * NT;
      if (p >= pairs) continue;
      const int r = p / per, u = p % per;
      const float* part = scr + r * g.U4 + u;
      float v = part[0];
      for (int z = 1; z < KS; ++z) v += part[z * R * g.U4];
      dh[q] = round_as<T>(v);
    }
    // the next step's pushes go to the other buffer and its product writes
    // scr only after the next cluster barrier
  }
#pragma unroll
  for (int q = 0; q < PMAX; ++q) {
    const int p = tid + q * NT;
    if (p >= pairs) continue;
    const int r = p / per, u = p % per;
    const int64_t o = (int64_t)(row0 + r) * H + u0 + u;
    dh0[o] = from_float<T>(dh[q]);
    dc0[o] = from_float<T>(dc[q]);
  }
}

template <typename T, bool WSM>
cudaError_t launch(const void* gates, const void* cs, const void* c0,
                   const void* wh, const void* dhs, const void* dcs,
                   void* dgates, void* dh0, void* dc0, int Tn, int B, int H,
                   int n, int R, int KS, int clusters, int reverse,
                   size_t bytes, cudaStream_t stream) {
  static unsigned set = 0;  // devices whose attributes are set
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= 32) return cudaErrorInvalidDevice;
  if (!(set >> dev & 1u)) {
    err = cudaFuncSetAttribute(lstm_layer_bwd_kernel<T, WSM>,
                               cudaFuncAttributeNonPortableClusterSizeAllowed,
                               1);
    if (err != cudaSuccess) return err;
    err = cudaFuncSetAttribute(lstm_layer_bwd_kernel<T, WSM>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               232448);
    if (err != cudaSuccess) return err;
    set |= 1u << dev;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(n * clusters));
  cfg.blockDim = dim3(NT);
  cfg.dynamicSmemBytes = bytes;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)n;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(
      &cfg, lstm_layer_bwd_kernel<T, WSM>, static_cast<const float*>(gates),
      static_cast<const T*>(cs), static_cast<const T*>(c0),
      static_cast<const T*>(wh), static_cast<const T*>(dhs),
      static_cast<const T*>(dcs), static_cast<T*>(dgates),
      static_cast<T*>(dh0), static_cast<T*>(dc0), Tn, B, H, n, R, KS,
      reverse);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_any(int wsm, const void* gates, const void* cs,
                       const void* c0, const void* wh, const void* dhs,
                       const void* dcs, void* dgates, void* dh0, void* dc0,
                       int Tn, int B, int H, int n, int R, int KS,
                       int clusters, int reverse, size_t bytes,
                       cudaStream_t stream) {
  if (wsm)
    return launch<T, true>(gates, cs, c0, wh, dhs, dcs, dgates, dh0, dc0, Tn,
                           B, H, n, R, KS, clusters, reverse, bytes, stream);
  return launch<T, false>(gates, cs, c0, wh, dhs, dcs, dgates, dh0, dc0, Tn,
                          B, H, n, R, KS, clusters, reverse, bytes, stream);
}

}  // namespace

extern "C" {

// gates: contiguous f32 (T, B, 4H); cs, dhs, dcs: contiguous (T, B, H) and
// c0: contiguous (B, H) of `dtype` (0 = float32, 1 = bfloat16); wh:
// contiguous (H, 4H) of `dtype`, 16-byte aligned; dgates: (T, B, 4H), dh0
// and dc0: (B, H), contiguous, of `dtype`.  Geometry from
// `layer_bwd_geometry`: cluster size n (1..16, <= H), rows per cluster R,
// KS slices of the 4H inputs (1..32), `clusters` clusters, wsm = Wh's rows
// in shared memory, `bytes` the shared memory it computed (checked here).
// Launches on `stream` and returns the launch's cudaError_t (0 on success).
int dt_lstm_layer_bwd(const void* gates, const void* cs, const void* c0,
                      const void* wh, const void* dhs, const void* dcs,
                      void* dgates, void* dh0, void* dc0, int T, int B, int H,
                      int n, int R, int KS, int clusters, int wsm, int dtype,
                      int reverse, int64_t bytes, void* stream) {
  if (T < 1 || B < 1 || H < 1 || n < 1 || n > 16 || n > H || R < 1 ||
      KS < 1 || KS > KS_MAX || clusters < 1 || (int64_t)clusters * R < B ||
      (int64_t)(clusters - 1) * R >= B || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  const Geo g = make_geo(H, n, R, KS, wsm != 0, dtype == 0 ? 4 : 2);
  if (g.bytes != bytes || bytes > 232448 || g.tiles * KS > NT ||
      R * g.per_max > PMAX * NT || !dt::aligned16(wh))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)launch_any<float>(wsm, gates, cs, c0, wh, dhs, dcs, dgates,
                                  dh0, dc0, T, B, H, n, R, KS, clusters,
                                  reverse, (size_t)bytes, s);
  return (int)launch_any<__nv_bfloat16>(wsm, gates, cs, c0, wh, dhs, dcs,
                                        dgates, dh0, dc0, T, B, H, n, R, KS,
                                        clusters, reverse, (size_t)bytes, s);
}

}  // extern "C"

DT_CUDA_ERROR_STRING
