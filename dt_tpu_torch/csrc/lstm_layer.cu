// One LSTM layer over a whole window: from the input product xw (T, B, 4H),
// computed before the launch, and h0, c0 (B, H), every step
//   gates_t = xw_t + h_{t-1} Wh (+ b),
//   c_t = sigmoid(f) * c_{t-1} + sigmoid(i) * tanh(g),  h_t = sigmoid(o) * tanh(c_t)
// (gate order i, f, g, o), forward in time or, under `reverse`, from the last
// step to the first.  Writes h_t and c_t (T, B, H) and the f32
// pre-activations gates_t (T, B, 4H) that the backward
// (csrc/lstm_layer_bwd.cu) reads.  Two kernels: f32 (xw holds the bias) and
// bf16 (xw = bf16(x Wx) without the bias, b passed apart).
//
// Replaces the Pallas TPU kernel `_lstm_point_kernel` on the path of
// `lstm` with the fused cell (dt_tpu/ops/rnn.py:84-114, a lax.scan of
// `lstm_cell_fused`, dt_tpu/ops/pallas/kernels.py:410, whose pointwise
// stage is that kernel, :319).  The TPU runs one small kernel a step; here
// the whole scan is one launch, so the recurrent product and the pointwise
// stage of every step run without going back to the host.
//
// f32.  Bound: operations.  A window does 2 T B H 4H f32 FMA operations
// (358 MFLOP at T 35, B 32, H 200: 5.3 us at 67 TFLOP/s) against ~9.6 MB
// (2.9 us at 3.35 TB/s).  But the steps are serial: each needs all of
// h_{t-1}.  The design keeps that chain on chip:
//   - One thread-block cluster of n = min(16, H) blocks (a non-portable
//     size above 8) walks the T steps for `rows` batch rows; batch rows are
//     independent, so B is cut into clusters of `rows` rows (the geometry
//     comes from ops/kernels.py `layer_geometry`).
//   - Block j owns hidden units [j H / n, (j + 1) H / n) and all four of
//     their gate columns, so the pointwise stage stays inside the block.
//     Its columns of Wh sit in shared memory for the whole window when they
//     fit (H 200: 200 x 52 f32, 41.6 KB); else (H 650) it reads them from
//     L2 every step (Wh is 6.8 MB, the L2 50 MB).
//   - Every block keeps the whole h_{t-1} of its rows in shared memory,
//     double-buffered by the step's parity.  A step: each thread forms a
//     4-row x 4-column tile of the gate product over one of KS slices of
//     the H inputs (f32 FMAs in ascending k), the KS partial tiles are added
//     in slice order through shared memory, xw_t is added, and one thread a
//     (row, unit) applies the pointwise stage, writes h_t, c_t and the
//     gates to memory, and stores h_t into every peer block's next buffer
//     (distributed shared memory); then one cluster barrier
//     (barrier.cluster.arrive.release / wait.acquire) ends the step.
//   - c_{t-1} stays in the owning block's shared memory; xw_t is loaded at
//     the start of the step and used after the product, so its latency
//     hides behind the product.
//
// bf16.  It computes what the JAX package's scan of `lstm_cell_fused` does
// in bf16, with its roundings: hw = bf16(h_{t-1} Wh) (f32 sums), pre =
// bf16(xw_t + hw), gates = f32(pre) + f32(b), the pointwise stage in f32,
// and h_t = bf16(h'), c_t = bf16(c') carried into the next step.  Bound:
// bytes on paper, 2 T B H 4H operations at the bf16 tensor-core rate (358
// MFLOP: 0.36 us at 989 TFLOP/s) against ~6.0 MB (1.8 us at 3.35 TB/s);
// the serial chain of T steps in practice.  The cluster plan is the f32
// one (a block owns its units' four gate columns; h double-buffered in
// shared memory, as bf16, and pushed to the peers over distributed shared
// memory; one cluster barrier a step).  The product runs on the tensor
// cores: `mma.sync` m16n8k16 bf16 with f32 accumulators, the cluster's
// <= 16 rows one m16 tile (rows past the cluster's are zeros in the A
// fragments; `wgmma`'s 64-row tiles would be mostly padding).  Each warp
// takes (8-column tile, slice of the k tiles) items and keeps two
// accumulators (even and odd k tiles, added at the end), so consecutive
// `mma`s do not wait on each other; the KSPLIT slices' partial tiles are
// added in slice order through shared memory.  The block's columns of Wh
// sit transposed in shared memory as bf16 when they fit (H 200: 56 x 216,
// 24.2 KB); at H 650 (168 x 664, 223 KB, beside the h buffers) they do
// not, and the B fragments are read from L2.  b stays in registers for the
// window, and so does c; xw_{t+1} is loaded into registers right after
// step t's pointwise stage, so its latency hides behind the cluster barrier
// and the next product (its runs are 2-byte columns at any alignment, too
// narrow for cp.async).
//
// Rounding of the pointwise stage follows csrc/lstm_point.cu: sigmoid is
// 1 / (1 + expf(-x)), tanh is tanhf (both correctly rounded, no fast
// math), and __fmul_rn / __fadd_rn keep f * c + i * g unfused.  Every sum
// has a fixed order and there are no atomics: two launches give the same
// bits.

#include "common.cuh"

namespace {

constexpr int NT = 512;    // threads a block
constexpr int PMAX = 4;    // (row, unit) pairs a thread at most
constexpr int KS_MAX = 8;  // slices of the inputs

__host__ __device__ constexpr int round4(int v) { return (v + 3) / 4 * 4; }

// Shared-memory layout of one block, in floats; ops/kernels.py
// `layer_geometry` computes the same total.
struct Geo {
  int per_max, C4, H4, HS, R4, RG, CG, tiles, KC;
  int h_buf, w, scr, c, floats;
};

__host__ __device__ inline Geo make_geo(int H, int n, int R, int KS,
                                        bool wsm) {
  Geo g;
  g.per_max = (H + n - 1) / n;
  g.C4 = round4(4 * g.per_max);
  g.H4 = round4(H);
  g.HS = g.H4 + 4;  // h row stride: rows four apart fall in other banks
  g.R4 = round4(R);
  g.RG = g.R4 / 4;
  g.CG = g.C4 / 4;
  g.tiles = g.RG * g.CG;
  g.KC = round4((g.H4 + KS - 1) / KS);
  g.h_buf = g.R4 * g.HS;
  g.w = wsm ? g.H4 * g.C4 : 0;
  g.scr = KS * g.R4 * g.C4;
  g.c = R * g.per_max;
  g.floats = 2 * g.h_buf + g.w + g.scr + g.c;
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

// Every thread of every block of the cluster: shared-memory writes before
// it (local and remote) are seen by every thread after it.
__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.release.aligned;\n"
      "barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// Store v at the address of `local` in the shared memory of block `rank`.
__device__ __forceinline__ void st_peer(const float* local, uint32_t rank,
                                        float v) {
  uint32_t remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
               : "=r"(remote)
               : "r"(smem_u32(local)), "r"(rank));
  asm volatile("st.shared::cluster.f32 [%0], %1;" ::"r"(remote), "f"(v)
               : "memory");
}

__device__ __forceinline__ float sigmoid(float x) {
  return 1.0f / (1.0f + expf(-x));
}

__device__ __forceinline__ float lane(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// grid: n * clusters blocks in clusters of n; NT threads; Geo::floats * 4
// bytes of dynamic shared memory.  WSM: Wh's columns in shared memory.
template <bool WSM>
__global__ void __launch_bounds__(NT, 1)
    lstm_layer_kernel(const float* __restrict__ xw,
                      const float* __restrict__ h0,
                      const float* __restrict__ c0,
                      const float* __restrict__ wh, float* __restrict__ hs,
                      float* __restrict__ cs, float* __restrict__ gates,
                      int T, int B, int H, int n, int R, int KS,
                      int reverse) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const Geo g = make_geo(H, n, R, KS, WSM);
  float* h_buf = smem;                  // [2][R4][HS]
  float* w_s = h_buf + 2 * g.h_buf;     // [H4][C4] when WSM
  float* scr = w_s + g.w;               // [KS][R4][C4]
  float* c_s = scr + g.scr;             // [R][per]

  const int tid = threadIdx.x;
  const int j = (int)cluster_rank();
  const int row0 = (blockIdx.x / n) * R;
  const int rows = min(R, B - row0);
  const int u0 = j * H / n;
  const int per = (j + 1) * H / n - u0;
  const int H4g = 4 * H;  // a row of xw, gates and Wh
  const int pairs = rows * per;

  // h0 into buffer 0, zeros elsewhere (pad rows and columns stay 0)
  for (int i = tid; i < 2 * g.h_buf; i += NT) {
    const int r = i / g.HS, k = i % g.HS;
    h_buf[i] = (r < rows && k < H) ? h0[(int64_t)(row0 + r) * H + k] : 0.0f;
  }
  if constexpr (WSM) {
    for (int i = tid; i < g.w; i += NT) {
      const int k = i / g.C4, c = i % g.C4;
      float v = 0.0f;
      if (k < H && c < 4 * per)
        v = wh[(int64_t)k * H4g + (c / per) * H + u0 + c % per];
      w_s[i] = v;
    }
  }
  for (int p = tid; p < pairs; p += NT) {
    const int r = p / per, u = p % per;
    c_s[p] = c0[(int64_t)(row0 + r) * H + u0 + u];
  }

  // this thread's tile of the product: rows 4 rg .. 4 rg + 3, columns
  // 4 cg .. 4 cg + 3 (column c = gate * per + unit), inputs [k0, k1)
  const bool computes = tid < g.tiles * KS;
  const int cg = tid % g.CG, rg = (tid / g.CG) % g.RG, ks = tid / g.tiles;
  const int k0 = min(ks * g.KC, g.H4), k1 = min(k0 + g.KC, g.H4);
  int col_off[4];  // Wh column of each tile column, -1 past 4 per
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int c = 4 * cg + i;
    col_off[i] = c < 4 * per ? (c / per) * H + u0 + c % per : -1;
  }
  cluster_sync();  // every block has started and holds its initial state

  for (int s = 0; s < T; ++s) {
    const int t = reverse ? T - 1 - s : s;
    const int cur = s & 1;
    const int64_t step_row = (int64_t)t * B + row0;

    float xv[PMAX][4];
#pragma unroll
    for (int q = 0; q < PMAX; ++q) {
      const int p = tid + q * NT;
      if (p < pairs) {
        const int r = p / per, u = p % per;
        const float* x = xw + (step_row + r) * H4g + u0 + u;
#pragma unroll
        for (int gi = 0; gi < 4; ++gi) xv[q][gi] = x[gi * H];
      }
    }

    if (computes) {
      float acc[4][4];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int b = 0; b < 4; ++b) acc[a][b] = 0.0f;
      const float* hb = h_buf + cur * g.h_buf + 4 * rg * g.HS;
      for (int k = k0; k < k1; k += 4) {
        float4 hv[4];
#pragma unroll
        for (int a = 0; a < 4; ++a)
          hv[a] = *reinterpret_cast<const float4*>(hb + a * g.HS + k);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          float4 w;
          if constexpr (WSM) {
            w = *reinterpret_cast<const float4*>(w_s + (k + kk) * g.C4 +
                                                 4 * cg);
          } else {
            float wv[4];
#pragma unroll
            for (int b = 0; b < 4; ++b)
              wv[b] = (col_off[b] >= 0 && k + kk < H)
                          ? __ldg(wh + (int64_t)(k + kk) * H4g + col_off[b])
                          : 0.0f;
            w = make_float4(wv[0], wv[1], wv[2], wv[3]);
          }
#pragma unroll
          for (int a = 0; a < 4; ++a) {
            const float hk = lane(hv[a], kk);
            acc[a][0] = fmaf(hk, w.x, acc[a][0]);
            acc[a][1] = fmaf(hk, w.y, acc[a][1]);
            acc[a][2] = fmaf(hk, w.z, acc[a][2]);
            acc[a][3] = fmaf(hk, w.w, acc[a][3]);
          }
        }
      }
#pragma unroll
      for (int a = 0; a < 4; ++a)
        *reinterpret_cast<float4*>(scr + (ks * g.R4 + 4 * rg + a) * g.C4 +
                                   4 * cg) =
            make_float4(acc[a][0], acc[a][1], acc[a][2], acc[a][3]);
    }
    __syncthreads();

    float* h_next = h_buf + (cur ^ 1) * g.h_buf;
#pragma unroll
    for (int q = 0; q < PMAX; ++q) {
      const int p = tid + q * NT;
      if (p >= pairs) continue;
      const int r = p / per, u = p % per;
      float pre[4];
#pragma unroll
      for (int gi = 0; gi < 4; ++gi) {
        const float* part = scr + r * g.C4 + gi * per + u;
        float v = part[0];
        for (int z = 1; z < KS; ++z) v += part[z * g.R4 * g.C4];
        pre[gi] = xv[q][gi] + v;
      }
      float* grow = gates + (step_row + r) * H4g + u0 + u;
#pragma unroll
      for (int gi = 0; gi < 4; ++gi) grow[gi * H] = pre[gi];
      const float ig = sigmoid(pre[0]);
      const float fg = sigmoid(pre[1]);
      const float gg = tanhf(pre[2]);
      const float og = sigmoid(pre[3]);
      const float cn = __fadd_rn(__fmul_rn(fg, c_s[p]), __fmul_rn(ig, gg));
      const float hn = __fmul_rn(og, tanhf(cn));
      c_s[p] = cn;
      const int64_t o = (step_row + r) * H + u0 + u;
      hs[o] = hn;
      cs[o] = cn;
      if (s + 1 < T) {
        const float* dst = h_next + r * g.HS + u0 + u;
        for (int q2 = 0; q2 < n; ++q2) st_peer(dst, (uint32_t)q2, hn);
      }
    }
    cluster_sync();  // h_t is in every block; scr and c_s may be reused
  }
}

template <bool WSM>
cudaError_t launch(const void* xw, const void* h0, const void* c0,
                   const void* wh, void* hs, void* cs, void* gates, int T,
                   int B, int H, int n, int R, int KS, int clusters,
                   int reverse, size_t bytes, cudaStream_t stream) {
  static unsigned set = 0;  // devices whose attributes are set
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= 32) return cudaErrorInvalidDevice;
  if (!(set >> dev & 1u)) {
    err = cudaFuncSetAttribute(lstm_layer_kernel<WSM>,
                               cudaFuncAttributeNonPortableClusterSizeAllowed,
                               1);
    if (err != cudaSuccess) return err;
    err = cudaFuncSetAttribute(lstm_layer_kernel<WSM>,
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
      &cfg, lstm_layer_kernel<WSM>, static_cast<const float*>(xw),
      static_cast<const float*>(h0), static_cast<const float*>(c0),
      static_cast<const float*>(wh), static_cast<float*>(hs),
      static_cast<float*>(cs), static_cast<float*>(gates), T, B, H, n, R, KS,
      reverse);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bf16: the product on the tensor cores
// ---------------------------------------------------------------------------

namespace bf {

constexpr int NT = 512;        // threads a block
constexpr int NW = NT / 32;    // warps a block
constexpr int PMAX = 4;        // (row, unit) pairs a thread at most
constexpr int KSPLIT_MAX = 8;  // slices of the k tiles
constexpr int ROWS_MAX = 16;   // the rows of one m16 tile

__host__ __device__ constexpr int round8(int v) { return (v + 7) / 8 * 8; }
__host__ __device__ constexpr int round16(int v) { return (v + 15) / 16 * 16; }

// Shared-memory layout of one block; ops/kernels.py `_layer_bytes_bf16`
// computes the same total.  h rows and Wh's transposed columns have a
// stride of K16 + 8 bf16 (a word stride of 4 mod 8: the 8 rows or columns
// of a fragment load fall in distinct banks).
struct Geo {
  int per_max, C8, NT8, K16, KT, HS;
  int h_elems, w_elems, scr;  // one h buffer and Wh (bf16), partials (f32)
  int64_t bytes;
};

__host__ __device__ inline Geo make_geo(int H, int n, int R, int KSPLIT,
                                        bool wsm) {
  Geo g;
  g.per_max = (H + n - 1) / n;
  g.C8 = round8(4 * g.per_max);
  g.NT8 = g.C8 / 8;
  g.K16 = round16(H);
  g.KT = g.K16 / 16;
  g.HS = g.K16 + 8;
  g.h_elems = R * g.HS;
  g.w_elems = wsm ? g.C8 * g.HS : 0;
  g.scr = KSPLIT * R * g.C8;
  g.bytes = 2 * (int64_t)(2 * g.h_elems + g.w_elems) + 4 * (int64_t)g.scr;
  return g;
}

__device__ __forceinline__ float rnd(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ uint32_t ld32(const uint16_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// The pair (Wh[k][col], Wh[k + 1][col]) as one B-fragment register, zeros
// past H or for a padding column (col < 0), read from L2.
__device__ __forceinline__ uint32_t wh_pair(const uint16_t* __restrict__ wh,
                                            int col, int k, int H, int H4g) {
  if (col < 0) return 0u;
  const uint32_t lo = k < H ? __ldg(wh + (int64_t)k * H4g + col) : 0u;
  const uint32_t hi = k + 1 < H ? __ldg(wh + (int64_t)(k + 1) * H4g + col)
                                : 0u;
  return lo | hi << 16;
}

__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Store the bf16 bits v at the address of `local` in block `rank`.
__device__ __forceinline__ void st_peer16(const uint16_t* local,
                                          uint32_t rank, uint16_t v) {
  uint32_t remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
               : "=r"(remote)
               : "r"(smem_u32(local)), "r"(rank));
  asm volatile("st.shared::cluster.u16 [%0], %1;" ::"r"(remote), "h"(v)
               : "memory");
}

// xw_t's four gate values of each of this thread's pairs, as f32.
__device__ __forceinline__ void load_xw(float (&xv)[PMAX][4],
                                        const uint16_t* __restrict__ xw,
                                        int64_t step_row, int tid, int pairs,
                                        int per, int u0, int H) {
#pragma unroll
  for (int q = 0; q < PMAX; ++q) {
    const int p = tid + q * NT;
    if (p < pairs) {
      const int r = p / per, u = p % per;
      const uint16_t* x = xw + (step_row + r) * 4 * H + u0 + u;
#pragma unroll
      for (int gi = 0; gi < 4; ++gi)
        xv[q][gi] = __uint_as_float((uint32_t)__ldg(x + gi * H) << 16);
    }
  }
}

// grid: n * clusters blocks in clusters of n; NT threads; Geo::bytes of
// dynamic shared memory.  WSM: Wh's columns in shared memory.
template <bool WSM>
__global__ void __launch_bounds__(NT, 1)
    lstm_layer_bf16_kernel(const uint16_t* __restrict__ xw,
                           const uint16_t* __restrict__ bias,
                           const uint16_t* __restrict__ h0,
                           const uint16_t* __restrict__ c0,
                           const uint16_t* __restrict__ wh,
                           uint16_t* __restrict__ hs,
                           uint16_t* __restrict__ cs,
                           float* __restrict__ gates, int T, int B, int H,
                           int n, int R, int KSPLIT, int reverse) {
  extern __shared__ float4 smem4[];
  const Geo g = make_geo(H, n, R, KSPLIT, WSM);
  uint16_t* h_buf = reinterpret_cast<uint16_t*>(smem4);  // [2][R][HS]
  uint16_t* w_s = h_buf + 2 * g.h_elems;                 // [C8][HS] if WSM
  float* scr = reinterpret_cast<float*>(w_s + g.w_elems);  // [KSPLIT][R][C8]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int j = (int)cluster_rank();
  const int row0 = (blockIdx.x / n) * R;
  const int rows = min(R, B - row0);
  const int u0 = j * H / n;
  const int per = (j + 1) * H / n - u0;
  const int H4g = 4 * H;
  const int pairs = rows * per;

  // h0 into buffer 0, zeros elsewhere (pad columns stay 0)
  for (int i = tid; i < 2 * g.h_elems; i += NT) {
    const int r = i / g.HS, k = i % g.HS;
    h_buf[i] = (r < rows && k < H) ? h0[(int64_t)(row0 + r) * H + k]
                                   : (uint16_t)0;
  }
  if constexpr (WSM) {  // w_s[c][k] = Wh[k][column c of the block]
    // c fastest: neighbouring threads read neighbouring columns of a row
    // of Wh; unrolled so that a thread has several L2 reads in flight (at
    // H 650 a block reads 223 KB before its first step)
#pragma unroll 8
    for (int i = tid; i < g.w_elems; i += NT) {
      const int k = i / g.C8, c = i % g.C8;
      uint16_t v = 0;
      if (k < H && c < 4 * per)
        v = wh[(int64_t)k * H4g + (c / per) * H + u0 + c % per];
      w_s[c * g.HS + k] = v;
    }
  }
  float cst[PMAX], bv[PMAX][4], xv[PMAX][4];
#pragma unroll
  for (int q = 0; q < PMAX; ++q) {
    const int p = tid + q * NT;
    cst[q] = 0.0f;
    if (p < pairs) {
      const int r = p / per, u = p % per;
      cst[q] = __uint_as_float(
          (uint32_t)c0[(int64_t)(row0 + r) * H + u0 + u] << 16);
#pragma unroll
      for (int gi = 0; gi < 4; ++gi)
        bv[q][gi] = __uint_as_float((uint32_t)bias[gi * H + u0 + u] << 16);
    }
  }
  load_xw(xv, xw, (int64_t)(reverse ? T - 1 : 0) * B + row0, tid, pairs,
          per, u0, H);

  // this lane's place in the fragments: row (and column) gq, pair tq
  const int gq = lane >> 2, tq = lane & 3;
  const bool row_a = gq < rows, row_b = gq + 8 < rows;
  const int items = g.NT8 * KSPLIT;
  cluster_sync();  // every block has started and holds its initial state

  for (int s = 0; s < T; ++s) {
    const int t = reverse ? T - 1 - s : s;
    const int cur = s & 1;
    const int64_t step_row = (int64_t)t * B + row0;
    const uint16_t* hb = h_buf + cur * g.h_elems;

    for (int it = warp; it < items; it += NW) {
      const int nt = it % g.NT8, ks = it / g.NT8;
      const int kt0 = ks * g.KT / KSPLIT, kt1 = (ks + 1) * g.KT / KSPLIT;
      const int col = nt * 8 + gq;  // this lane's B column
      int colg = -1;  // its column of Wh, -1 for a padding column
      if (!WSM && col < 4 * per) colg = (col / per) * H + u0 + col % per;
      float d0[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      float d1[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      const uint16_t* ha = hb + gq * g.HS + 2 * tq;
      const uint16_t* hbr = ha + 8 * g.HS;
      for (int kt = kt0; kt < kt1; ++kt) {
        const int k = kt * 16;
        uint32_t a[4];
        a[0] = row_a ? ld32(ha + k) : 0u;
        a[1] = row_b ? ld32(hbr + k) : 0u;
        a[2] = row_a ? ld32(ha + k + 8) : 0u;
        a[3] = row_b ? ld32(hbr + k + 8) : 0u;
        uint32_t b0, b1;
        if constexpr (WSM) {
          const uint16_t* wc = w_s + col * g.HS + k + 2 * tq;
          b0 = ld32(wc);
          b1 = ld32(wc + 8);
        } else {
          b0 = wh_pair(wh, colg, k + 2 * tq, H, H4g);
          b1 = wh_pair(wh, colg, k + 2 * tq + 8, H, H4g);
        }
        if (kt & 1)
          mma(d1, a, b0, b1);
        else
          mma(d0, a, b0, b1);
      }
      float* sp = scr + (ks * R) * g.C8 + nt * 8 + 2 * tq;
      if (row_a) {
        sp[gq * g.C8] = d0[0] + d1[0];
        sp[gq * g.C8 + 1] = d0[1] + d1[1];
      }
      if (row_b) {
        sp[(gq + 8) * g.C8] = d0[2] + d1[2];
        sp[(gq + 8) * g.C8 + 1] = d0[3] + d1[3];
      }
    }
    __syncthreads();

    uint16_t* h_next = h_buf + (cur ^ 1) * g.h_elems;
#pragma unroll
    for (int q = 0; q < PMAX; ++q) {
      const int p = tid + q * NT;
      if (p >= pairs) continue;
      const int r = p / per, u = p % per;
      float pre[4];
#pragma unroll
      for (int gi = 0; gi < 4; ++gi) {
        const float* part = scr + r * g.C8 + gi * per + u;
        float v = part[0];
        for (int z = 1; z < KSPLIT; ++z) v += part[z * R * g.C8];
        pre[gi] = __fadd_rn(rnd(__fadd_rn(xv[q][gi], rnd(v))), bv[q][gi]);
      }
      float* grow = gates + (step_row + r) * H4g + u0 + u;
#pragma unroll
      for (int gi = 0; gi < 4; ++gi) grow[gi * H] = pre[gi];
      const float ig = sigmoid(pre[0]);
      const float fg = sigmoid(pre[1]);
      const float gg = tanhf(pre[2]);
      const float og = sigmoid(pre[3]);
      const float cn = __fadd_rn(__fmul_rn(fg, cst[q]), __fmul_rn(ig, gg));
      const float hn = __fmul_rn(og, tanhf(cn));
      const uint16_t cb = __bfloat16_as_ushort(__float2bfloat16_rn(cn));
      const uint16_t hbits = __bfloat16_as_ushort(__float2bfloat16_rn(hn));
      cst[q] = __uint_as_float((uint32_t)cb << 16);
      const int64_t o = (step_row + r) * H + u0 + u;
      hs[o] = hbits;
      cs[o] = cb;
      if (s + 1 < T) {
        const uint16_t* dst = h_next + r * g.HS + u0 + u;
        for (int q2 = 0; q2 < n; ++q2) st_peer16(dst, (uint32_t)q2, hbits);
      }
    }
    if (s + 1 < T)  // the next step's xw, behind the barrier and product
      load_xw(xv, xw, (int64_t)(reverse ? T - 2 - s : s + 1) * B + row0,
              tid, pairs, per, u0, H);
    cluster_sync();  // h_t is in every block; scr may be reused
  }
}

template <bool WSM>
cudaError_t launch(const void* xw, const void* b, const void* h0,
                   const void* c0, const void* wh, void* hs, void* cs,
                   void* gates, int T, int B, int H, int n, int R, int KS,
                   int clusters, int reverse, size_t bytes,
                   cudaStream_t stream) {
  static unsigned set = 0;  // devices whose attributes are set
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= 32) return cudaErrorInvalidDevice;
  if (!(set >> dev & 1u)) {
    err = cudaFuncSetAttribute(lstm_layer_bf16_kernel<WSM>,
                               cudaFuncAttributeNonPortableClusterSizeAllowed,
                               1);
    if (err != cudaSuccess) return err;
    err = cudaFuncSetAttribute(lstm_layer_bf16_kernel<WSM>,
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
      &cfg, lstm_layer_bf16_kernel<WSM>, static_cast<const uint16_t*>(xw),
      static_cast<const uint16_t*>(b), static_cast<const uint16_t*>(h0),
      static_cast<const uint16_t*>(c0), static_cast<const uint16_t*>(wh),
      static_cast<uint16_t*>(hs), static_cast<uint16_t*>(cs),
      static_cast<float*>(gates), T, B, H, n, R, KS, reverse);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace bf

}  // namespace

extern "C" {

// xw: contiguous f32 (T, B, 4H); h0, c0: contiguous f32 (B, H); wh:
// contiguous f32 (H, 4H); hs, cs: contiguous f32 (T, B, H); gates:
// contiguous f32 (T, B, 4H).  Geometry from `layer_geometry`: cluster
// size n (1..16, <= H), rows per cluster R, KS input slices, `clusters`
// clusters (clusters * R >= B > (clusters - 1) * R), wsm = Wh's columns in
// shared memory, `bytes` the shared memory it computed (checked here).
// Launches on `stream` and returns the launch's cudaError_t (0 on success).
int dt_lstm_layer(const void* xw, const void* h0, const void* c0,
                  const void* wh, void* hs, void* cs, void* gates, int T,
                  int B, int H, int n, int R, int KS, int clusters, int wsm,
                  int reverse, int64_t bytes, void* stream) {
  if (T < 1 || B < 1 || H < 1 || n < 1 || n > 16 || n > H || R < 1 ||
      KS < 1 || KS > KS_MAX || clusters < 1 || (int64_t)clusters * R < B ||
      (int64_t)(clusters - 1) * R >= B)
    return (int)cudaErrorInvalidValue;
  const Geo g = make_geo(H, n, R, KS, wsm != 0);
  if ((int64_t)g.floats * 4 != bytes || bytes > 232448 ||
      g.tiles * KS > NT || R * g.per_max > PMAX * NT)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (wsm)
    return (int)launch<true>(xw, h0, c0, wh, hs, cs, gates, T, B, H, n, R,
                             KS, clusters, reverse, (size_t)bytes, s);
  return (int)launch<false>(xw, h0, c0, wh, hs, cs, gates, T, B, H, n, R,
                            KS, clusters, reverse, (size_t)bytes, s);
}

// The bf16 layer: xw (T, B, 4H), the input product without the bias; b
// (4H,); h0, c0 (B, H); wh (H, 4H); hs, cs (T, B, H): all contiguous
// bf16; gates: contiguous f32 (T, B, 4H).  Geometry from `layer_geometry`
// with dtype bfloat16: cluster size n (1..16, <= H), rows per cluster R
// (1..16), KS slices of the k tiles (1..8), `clusters` clusters, wsm =
// Wh's columns in shared memory, `bytes` the shared memory it computed
// (checked here).
// Launches on `stream` and returns the launch's cudaError_t (0 on success).
int dt_lstm_layer_bf16(const void* xw, const void* b, const void* h0,
                       const void* c0, const void* wh, void* hs, void* cs,
                       void* gates, int T, int B, int H, int n, int R, int KS,
                       int clusters, int wsm, int reverse, int64_t bytes,
                       void* stream) {
  if (T < 1 || B < 1 || H < 1 || n < 1 || n > 16 || n > H || R < 1 ||
      R > bf::ROWS_MAX || KS < 1 || KS > bf::KSPLIT_MAX || clusters < 1 ||
      (int64_t)clusters * R < B || (int64_t)(clusters - 1) * R >= B)
    return (int)cudaErrorInvalidValue;
  const bf::Geo g = bf::make_geo(H, n, R, KS, wsm != 0);
  if (g.bytes != bytes || bytes > 232448 || KS > g.KT ||
      R * g.per_max > bf::PMAX * bf::NT)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (wsm)
    return (int)bf::launch<true>(xw, b, h0, c0, wh, hs, cs, gates, T, B, H,
                                 n, R, KS, clusters, reverse, (size_t)bytes,
                                 s);
  return (int)bf::launch<false>(xw, b, h0, c0, wh, hs, cs, gates, T, B, H, n,
                                R, KS, clusters, reverse, (size_t)bytes, s);
}

}  // extern "C"

DT_CUDA_ERROR_STRING
