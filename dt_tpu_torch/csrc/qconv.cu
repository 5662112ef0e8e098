// int8 x int8 -> int32 convolution as an implicit GEMM on Hopper's int8
// tensor cores, with the float epilogue of the JAX package's
// quantized_conv2d / quantized_dense fused:
//
//   acc[m, n] = sum_k A[m, k] * B[k, n]                       (int32)
//   out[m, n] = cast<T>(__fadd_rn(__fdiv_rn(__int2float_rn(acc), d), bias[n]))
//
// over NHWC input x (batch, H, W, C) and HWIO weights w (KH, KW, C, N): m
// runs over the output pixels (batch, OH, OW), k over the filter taps, and
// A[m, k] is the input pixel the tap sees, zero outside the padded image.
// The kernel reads x with its channels padded to Cp (16 | Cp, or Cp = 4 on
// the narrow route) and the weight packed as (N, KH * KWp * Cp) rows,
// k = (ky * KWp + kx) * Cp + c; the wrapper pads both with int8 zeros,
// which is exact, since the quantization is symmetric (no zero point).  d
// is x_scale * w_scale (one f32 in device memory, read by every thread, so
// no scale crosses to the host), the bias is optional, T is float or
// bfloat16 (__float2bfloat16_rn).  Each step is the correctly rounded op
// the JAX code applies in that order (acc.astype(f32), /, +, astype), and
// integer sums are exact in any order, so the output is bit-equal to the
// plain version's.  quantized_dense is the 1x1, stride-1 case over (M, 1,
// 1, K).
//
// Replaces no Pallas kernel: the JAX package computes both functions with
// lax.conv_general_dilated / lax.dot_general and
// preferred_element_type=int32 (dt_tpu/ops/quantization.py:52,65), which
// XLA lowers to the TPU's int8 matrix unit.  PyTorch has no int8
// convolution on CUDA and its int8 matmul (torch._int_mm) takes only some
// shapes, so this kernel is the port's path for both functions.
//
// Bound: bytes.  Over ResNet-50 v1 at batch 32 every layer moves more
// bytes than the H100's 1,979 int8 TOP/s make up for (the operations of
// all 53 convolutions take ~0.125 ms, their bytes ~0.51 ms at 3.35 TB/s),
// and ~80 % of those bytes are the f32 output (4 M N a layer).  So the
// design keeps loads in flight under the products and writes the output
// at full width:
//   - B is read K-major.  8-bit wgmma takes both operands K-major from
//     shared memory (no transpose bit) and HWIO is K x N with N
//     contiguous, so `dt_qconv_pack` writes the weight once as (N, Kc)
//     rows; the wrapper caches that copy (keyed by the weight's storage,
//     checked against its version counter and a weak reference to its
//     owner).  Each stage's B tile is one TMA load of BN rows x 128 bytes
//     in the 128-byte swizzle.
//   - A pipelined K loop on wgmma: a block is two consumer warpgroups (64
//     output pixels each, 128 in all) and PRODUCERS warps over a ring of
//     STAGES shared-memory stages (3 at BN 128, 4 at BN 64), each 128
//     bytes of K deep (one swizzle row), with mbarriers for full and
//     empty.  The consumers issue wgmma.mma_async m64nBNk32 s32.s8.s8 from
//     shared-memory descriptors, 4 a stage, keep one stage's products in
//     flight (wait_group 1) and release the stage before it; s32
//     accumulators in registers.  BN is 128, or 64 where N <= 64 or the
//     grid would not fill the card (the wrapper's qconv_plan).
//   - A without divisions in the loop, by one of three routes, named in
//     the wrapper (QCONV_ROUTES) and counted there:
//       tma: 1x1, stride 1, no padding: A is x viewed as an (M, Cp)
//         matrix, one TMA load a stage.
//       gather: every other layer: the producers fill the A tile with
//         16-byte cp.async (zero-fill, src-size 0, for padding pixels and
//         taps past K), each thread one 16-byte chunk of a row, so a
//         warp's load covers four 128-byte rows; each thread's (ky, kx, c)
//         walks by 128 bytes a stage in 32-bit integers.
//       narrow: C <= 4 and KW <= 8 (ResNet's stem, C = 3): Cp = 4 and the
//         filter's rows padded to KWp = 8 taps, so a 128-byte row of K is
//         4 filter rows and a warp loads one pixel's 4 x 8 taps with
//         4-byte cp.async, 2 stages of K for the 7x7 stem where 16
//         channels would take 7 and 5x the bytes.
//     Each row's pixel is decoded once before the loop (into shared
//     memory).  The producers' cp.async complete on the full barrier
//     (cp.async.mbarrier.arrive.noinc) beside the B tile's TMA bytes; the
//     consumers fence the async proxy before the products.  Two producer
//     warps at BN 128 and four at BN 64: one warp cannot issue the
//     gather's cp.async fast enough to keep the ring full.
//   - An epilogue at full width: each warpgroup converts its 64 x BN
//     accumulators element by element in the order above (the division
//     as two FMA corrections of a * RN(1 / d), exact by Markstein's
//     theorem: div_rn), stages them in the (then idle) ring, rows padded
//     by 8 elements so the staging is free of bank conflicts, and writes
//     them as 16-byte rows, a warp one contiguous run of the output
//     (element stores where N * sizeof(T) is not a multiple of 16).
//   - Two blocks an SM (~99 KB of shared memory each), so one block's
//     epilogue overlaps the other's K loop.
// Every mbarrier wait traps after 4 s, so a pipeline fault fails the launch
// instead of hanging the card.  Domain: K <= 133,144, so 127^2 K fits in
// int32 (the wrapper refuses more).

#include <string.h>

#include "common.cuh"

namespace {

using namespace dt;

constexpr int BM = 128;                  // output pixels a block
constexpr int BK = 128;                  // bytes of K a stage: a swizzle row
constexpr int CONSUMERS = 256;           // two warpgroups of 64 pixels
// how a block loads A (x): one TMA load a stage of x viewed as an (M, Cp)
// matrix; 16-byte cp.async of each tap's channels; 4-byte cp.async of
// each tap's pixel (Cp 4)
constexpr int ROUTE_TMA = 0, ROUTE_GATHER = 1, ROUTE_NARROW = 2;
constexpr int A_BYTES = BM * BK;
constexpr uint32_t SBO = 8 * BK / 16;    // 8-row core-matrix groups
constexpr int SWIZZLE_128B = 1;          // wgmma descriptor layout type

// Shared memory for tiles BN wide: the ring, each row's pixel, barriers.
// qconv_smem in ops/kernels.py mirrors SMEM; dt_qconv refuses a mismatch.
template <int BN> struct Cfg {
  // producer warps: as many as two blocks an SM leave registers for beside
  // the consumers' BN / 2 accumulators (90 registers a thread at BN 128,
  // 60 at BN 64; four at BN 128 would leave 80, too few for its wgmma)
  static constexpr int PRODUCERS = BN == 128 ? 2 : 4;
  static constexpr int THREADS = CONSUMERS + 32 * PRODUCERS;
  static constexpr int STAGES = BN == 128 ? 3 : 4;
  static constexpr int B_BYTES = BN * BK;
  static constexpr int RING = STAGES * (A_BYTES + B_BYTES);
  static constexpr int SMEM = 1024 + RING + BM * 16 + 2 * STAGES * 8;
  static constexpr int RS = BN + 8;  // a staged output row, in elements
  static_assert(2 * 64 * RS * 4 <= RING, "the output stage fits the ring");
};

struct Geo {
  int64_t m;              // GEMM rows: batch * OH * OW
  int h, w, cp;           // input (NHWC, cp channels, cp % 16 == 0)
  int kh, kw, oh, ow, n;  // filter, output pixels, output channels
  int sh, sw, ph, pw;     // strides, low pads
  int kc, k_steps;        // depth kh * kw * cp, and its 128-byte steps
  int n_tiles;            // output-channel tiles (the grid is m x n tiles)
};

// Where an output pixel's (ky, kx) = (0, 0) tap reads: the element offset
// of input pixel (iy0, ix0) of its image (negative where the tap lies in
// the padding); iy0 = -2^30 for rows past M, so no tap of theirs is in the
// image.
struct alignas(16) RowInfo {
  long long off;
  int iy0, ix0;
};

__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%3, %4}], [%2];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1)
      : "memory");
}

// N bytes (16: through L2 only; 4) from global to shared memory, `bytes`
// of them read and the rest zero-filled (0 writes N zeros).
template <int N = 16>
__device__ __forceinline__ void cp_async(uint32_t dst, const void* src,
                                         int bytes) {
  if constexpr (N == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(dst),
                 "l"(src), "r"(bytes)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;" ::"r"(dst),
                 "l"(src), "n"(N), "r"(bytes)
                 : "memory");
}

// An arrival on `bar` once every cp.async this thread issued has landed
// (counted among the barrier's expected arrivals).
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];" ::"r"(
                   smem_u32(bar))
               : "memory");
}

// Order the gather's cp.async writes (generic proxy) before wgmma's reads
// of them (async proxy).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(threads) : "memory");
}

template <int N> __device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// Keep the compiler from moving reads or writes of an accumulator across
// the asynchronous product that owns it.
template <int N> __device__ __forceinline__ void pin(int (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// m64nNk32, s8 x s8 into s32 accumulators, both operands K-major from
// shared memory; accumulates (scale-d 1) into d.
__device__ __forceinline__ void wgmma_s8_n64(int (&d)[32], uint64_t da,
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p;\n}\n"
      :
        "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]),
        "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]),
        "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31])
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_s8_n128(int (&d)[64], uint64_t da,
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p;\n}\n"
      :
        "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]),
        "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]),
        "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
        "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]),
        "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]),
        "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

template <int BN>
__device__ __forceinline__ void mma_s8(int (&d)[BN / 2], uint64_t da,
                                       uint64_t db) {
  if constexpr (BN == 64) wgmma_s8_n64(d, da, db);
  else wgmma_s8_n128(d, da, db);
}

// a / d correctly rounded, given y = RN(1 / d): two FMA corrections of a
// y (Markstein: once q is within 1 ulp of a / d, r = a - d q is exact and
// RN(q + r y) = RN(a / d)).  For |d| in [1e-28, 1e28] and a an integer
// below 2^31 in magnitude no step overflows or underflows.
__device__ __forceinline__ float div_rn(float a, float d, float y) {
  float q = __fmul_rn(a, y);
  float r = __fmaf_rn(-q, d, a);
  q = __fmaf_rn(r, y, q);
  r = __fmaf_rn(-q, d, a);
  return __fmaf_rn(r, y, q);
}

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  __nv_bfloat162 v;
  v.x = __float2bfloat16_rn(a);
  v.y = __float2bfloat16_rn(b);
  *reinterpret_cast<__nv_bfloat162*>(p) = v;
}

// grid (m tiles x n tiles, n fastest); Cfg<BN>::THREADS threads and
// Cfg<BN>::SMEM bytes of dynamic shared memory.  Warps 0-7 are the two
// consumer warpgroups (pixels m0 + 64 wg ...), warps 8 and up the producers.
// `ta` is read on the tma route only.
template <int BN, typename T>
__global__ void __launch_bounds__(Cfg<BN>::THREADS, 2)
    qconv_wgmma(const __grid_constant__ CUtensorMap ta,
                const __grid_constant__ CUtensorMap tb,
                const int8_t* __restrict__ x, const float* __restrict__ bias,
                const float* __restrict__ divisor, T* __restrict__ out,
                Geo g, int route, int vec_out) {
  using C = Cfg<BN>;
  constexpr int ST = C::STAGES, PRODUCERS = C::PRODUCERS;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  uint8_t* base = smem_raw + (((raw + 1023u) & ~1023u) - raw);  // swizzle
  uint8_t* a_s = base;                                            // atoms
  uint8_t* b_s = a_s + ST * A_BYTES;
  RowInfo* rows = reinterpret_cast<RowInfo*>(b_s + ST * C::B_BYTES);
  uint64_t* full = reinterpret_cast<uint64_t*>(rows + BM);
  uint64_t* empty = full + ST;

  const int n0 = (int)(blockIdx.x % (unsigned)g.n_tiles) * BN;
  const int64_t m0 = (int64_t)(blockIdx.x / (unsigned)g.n_tiles) * BM;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < ST; ++s) {
      // tma: the one expect_tx arrival; else it and the producers' cp.async
      mbar_init(&full[s], route == ROUTE_TMA ? 1 : 1 + 32 * PRODUCERS);
      mbar_init(&empty[s], CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (warp >= CONSUMERS / 32) {
    // ------------------------------------------------------ producers
    const int pt = threadIdx.x - CONSUMERS;  // 0 .. 32 PRODUCERS - 1
    if (route == ROUTE_TMA) {
      if (pt == 0) {
        for (int t = 0; t < g.k_steps; ++t) {
          const int s = t % ST;
          if (t >= ST) mbar_wait(&empty[s], (t / ST - 1) & 1);
          mbar_expect_tx(&full[s], A_BYTES + C::B_BYTES);
          tma_load_2d(a_s + s * A_BYTES, &ta, &full[s], t * BK, (int)m0);
          tma_load_2d(b_s + s * C::B_BYTES, &tb, &full[s], t * BK, n0);
        }
      }
      return;
    }
    // each row's pixel, decoded once
    const int64_t per_img = (int64_t)g.oh * g.ow;
    for (int r = pt; r < BM; r += 32 * PRODUCERS) {
      const int64_t m = m0 + r;
      RowInfo ri{0, -(1 << 30), 0};
      if (m < g.m) {
        const int64_t img = m / per_img;
        const int rem = (int)(m - img * per_img);
        const int oy = rem / g.ow, ox = rem - (rem / g.ow) * g.ow;
        ri.iy0 = oy * g.sh - g.ph;
        ri.ix0 = ox * g.sw - g.pw;
        ri.off = ((img * g.h + ri.iy0) * g.w + ri.ix0) * (int64_t)g.cp;
      }
      rows[r] = ri;
    }
    named_sync(1, 32 * PRODUCERS);
    const uint32_t a0 = smem_u32(a_s);
    if (route == ROUTE_GATHER) {
      // this thread's 16-byte chunk j of rows rl + 4 PRODUCERS i: k = 16 j
      // + 128 t, walked as (ky, kx, c) by 128 bytes a stage
      const int j = pt & 7, rl = pt >> 3;
      int c = (16 * j) % g.cp;
      const int tap = (16 * j) / g.cp;
      int ky = tap / g.kw, kx = tap - (tap / g.kw) * g.kw;
      const int dc = BK % g.cp, dtap = BK / g.cp;
      const int qa = dtap / g.kw, ra = dtap - qa * g.kw;
      const int qb = (dtap + 1) / g.kw, rb = dtap + 1 - qb * g.kw;
      for (int t = 0; t < g.k_steps; ++t) {
        const int s = t % ST;
        if (t >= ST) mbar_wait(&empty[s], (t / ST - 1) & 1);
        if (pt == 0) {
          mbar_expect_tx(&full[s], C::B_BYTES);
          tma_load_2d(b_s + s * C::B_BYTES, &tb, &full[s], t * BK, n0);
        }
        const bool k_ok = ky < g.kh;  // k < Kc
        const int64_t tap_off = ((int64_t)ky * g.w + kx) * g.cp + c;
        const uint32_t dst = a0 + s * A_BYTES;
#pragma unroll 8
        for (int i = 0; i < BM / (4 * PRODUCERS); ++i) {
          // row r's chunk j lies at r * 128 + (j ^ (r % 8)) * 16 (the
          // 128-byte swizzle)
          const int r = rl + 4 * PRODUCERS * i;
          const RowInfo ri = rows[r];
          const int iy = ri.iy0 + ky, ix = ri.ix0 + kx;
          const bool ok = k_ok && (unsigned)iy < (unsigned)g.h &&
                          (unsigned)ix < (unsigned)g.w;
          cp_async(dst + r * BK + ((j ^ (r & 7)) << 4),
                   ok ? x + ri.off + tap_off : x, ok ? 16 : 0);
        }
        cp_async_arrive(&full[s]);
        // k += 128: c by 128 % Cp, the tap by 128 / Cp (+ 1 on a carry)
        c += dc;
        const bool carry = c >= g.cp;
        if (carry) c -= g.cp;
        kx += carry ? rb : ra;
        ky += carry ? qb : qa;
        if (kx >= g.kw) {
          kx -= g.kw;
          ++ky;
        }
      }
    } else {
      // narrow (Cp 4, KW <= 8): k = (ky * 8 + kx) * 4 + c, so a 128-byte
      // row of K is 4 filter rows of 8 taps; thread pt loads tap (4 t + p
      // / 8, p % 8), p = pt % 32, of rows pt / 32 + PRODUCERS i: the 4
      // bytes of one input pixel, 0 past the filter or the image
      const int p = pt & 31, rl = pt >> 5;
      const int kx = p & 7;
      for (int t = 0; t < g.k_steps; ++t) {
        const int s = t % ST;
        if (t >= ST) mbar_wait(&empty[s], (t / ST - 1) & 1);
        if (pt == 0) {
          mbar_expect_tx(&full[s], C::B_BYTES);
          tma_load_2d(b_s + s * C::B_BYTES, &tb, &full[s], t * BK, n0);
        }
        const int ky = 4 * t + (p >> 3);
        const bool k_ok = ky < g.kh && kx < g.kw;
        const int64_t tap_off = ((int64_t)ky * g.w + kx) * 4;
        const uint32_t dst = a0 + s * A_BYTES + (p & 3) * 4;
#pragma unroll 8
        for (int i = 0; i < BM / PRODUCERS; ++i) {
          const int r = rl + PRODUCERS * i;
          const RowInfo ri = rows[r];
          const int iy = ri.iy0 + ky, ix = ri.ix0 + kx;
          const bool ok = k_ok && (unsigned)iy < (unsigned)g.h &&
                          (unsigned)ix < (unsigned)g.w;
          cp_async<4>(dst + r * BK + (((p >> 2) ^ (r & 7)) << 4),
                      ok ? x + ri.off + tap_off : x, ok ? 4 : 0);
        }
        cp_async_arrive(&full[s]);
      }
    }
    asm volatile("cp.async.wait_all;" ::: "memory");  // none outlives us
    return;
  }

  // ------------------------------------------------------- consumers
  const int wg = warp / 4;
  int acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0;
  const uint32_t a_addr = smem_u32(a_s) + wg * 64 * BK;
  const uint32_t b_addr = smem_u32(b_s);
  for (int t = 0; t < g.k_steps; ++t) {
    const int s = t % ST;
    mbar_wait(&full[s], (t / ST) & 1);
    fence_proxy_async();
    pin(acc);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 32; ++kk)
      mma_s8<BN>(acc,
                 desc(a_addr + s * A_BYTES + 32 * kk, 1, SBO, SWIZZLE_128B),
                 desc(b_addr + s * C::B_BYTES + 32 * kk, 1, SBO,
                      SWIZZLE_128B));
    wg_commit();
    wg_wait<1>();  // step t - 1's products are done: release its stage
    pin(acc);
    if (t > 0) mbar_arrive(&empty[(t - 1) % ST]);
  }
  wg_wait<0>();
  pin(acc);

  // ------------------------------------------------------- epilogue
  // every consumer is done with the ring: it becomes the output stage
  named_sync(2, CONSUMERS);
  constexpr int RS = C::RS;
  T* st = reinterpret_cast<T*>(base) + wg * 64 * RS;
  const float d = *divisor;
  const float y = __frcp_rn(d);  // d outside [1e-28, 1e28]: __fdiv_rn
  const bool fast = isfinite(y) && fabsf(d) >= 1e-28f && fabsf(d) <= 1e28f;
  // the accumulator layout: rows wr and wr + 8 of the warpgroup's 64,
  // columns 8 j + col and + 1
  const int wr = 16 * (warp % 4) + lane / 4;
  const int col = 2 * (lane % 4);
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int nn = 8 * j + col;
    float b0 = 0.0f, b1 = 0.0f;
    if (bias != nullptr) {
      if (n0 + nn < g.n) b0 = bias[n0 + nn];
      if (n0 + nn + 1 < g.n) b1 = bias[n0 + nn + 1];
    }
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const float a0 = __int2float_rn(acc[4 * j + 2 * half]);
      const float a1 = __int2float_rn(acc[4 * j + 2 * half + 1]);
      float v0 = fast ? div_rn(a0, d, y) : __fdiv_rn(a0, d);
      float v1 = fast ? div_rn(a1, d, y) : __fdiv_rn(a1, d);
      if (bias != nullptr) {
        v0 = __fadd_rn(v0, b0);
        v1 = __fadd_rn(v1, b1);
      }
      store2(st + (wr + 8 * half) * RS + nn, v0, v1);
    }
  }
  named_sync(3 + wg, 128);
  const int tid = threadIdx.x % 128;
  const int64_t row0 = m0 + 64 * wg;
  if (vec_out) {  // N * sizeof(T) % 16 == 0: 16-byte chunks, never past N
    constexpr int PER = 16 / (int)sizeof(T);  // elements a chunk
    constexpr int CPR = BN / PER;             // chunks a row
#pragma unroll 4
    for (int f = tid; f < 64 * CPR; f += 128) {
      const int r = f / CPR, q = f % CPR;
      const int64_t m = row0 + r;
      const int n = n0 + q * PER;
      if (m < g.m && n < g.n)
        *reinterpret_cast<int4*>(out + m * g.n + n) =
            *reinterpret_cast<const int4*>(st + r * RS + q * PER);
    }
  } else {
    for (int f = tid; f < 64 * BN; f += 128) {
      const int r = f / BN, q = f % BN;
      const int64_t m = row0 + r;
      const int n = n0 + q;
      if (m < g.m && n < g.n) out[m * g.n + n] = st[r * RS + q];
    }
  }
}

// The packed weight: p[n, (ky * KWp + kx) * Cp + c] = w[ky, kx, c, n], 0
// for kx >= KW or c >= C.  64 x 64 tiles through shared memory, so both
// the reads (rows of w, N contiguous) and the writes (rows of p, K
// contiguous) are coalesced; a thread issues its 16 loads before it uses
// any, so their latencies overlap.  Run once a weight (the wrapper caches
// its output), or on every call for a weight it cannot cache.
__global__ void __launch_bounds__(256)
    qconv_pack_kernel(const int8_t* __restrict__ w, int8_t* __restrict__ p,
                      int kh, int kw, int kwp, int c, int cp, int n) {
  __shared__ int8_t tile[64][65];
  const int kc = kh * kwp * cp;  // < 2^31: dt_qconv_pack checks
  const int k0 = blockIdx.x * 64, n0 = blockIdx.y * 64;
  const int tx = threadIdx.x % 64, ty = threadIdx.x / 64;
  int8_t v[16];
#pragma unroll
  for (int u = 0; u < 16; ++u) {
    const int k = k0 + ty + 4 * u;
    const int tap = k / cp;  // ky * kwp + kx
    const int ci = k - tap * cp;
    const int ky = tap / kwp, kx = tap - ky * kwp;
    v[u] = k < kc && ci < c && kx < kw && n0 + tx < n
               ? w[((int64_t)(ky * kw + kx) * c + ci) * n + n0 + tx]
               : (int8_t)0;
  }
#pragma unroll
  for (int u = 0; u < 16; ++u) tile[ty + 4 * u][tx] = v[u];
  __syncthreads();
#pragma unroll
  for (int u = 0; u < 16; ++u) {
    const int i = ty + 4 * u, k = k0 + tx;
    if (n0 + i < n && k < kc) p[(int64_t)(n0 + i) * kc + k] = tile[tx][i];
  }
}

// A 2-D int8 map over a row-major (rows, cols) matrix, boxes of (128
// bytes, box_rows) in the 128-byte swizzle; reads past either edge are 0.
bool encode_2d(CUtensorMap* map, const void* ptr, int64_t rows, int64_t cols,
               int box_rows) {
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols};
  const cuuint32_t box[2] = {(cuuint32_t)BK, (cuuint32_t)box_rows};
  const cuuint32_t unit[2] = {1, 1};
  const EncodeTiled fn = encoder();
  return fn != nullptr &&
         fn(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(ptr),
            dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int BN, typename T>
cudaError_t launch(const CUtensorMap& ta, const CUtensorMap& tb,
                   const int8_t* x, const float* bias, const float* divisor,
                   T* out, const Geo& g, int64_t tiles, int route,
                   bool vec_out, cudaStream_t stream) {
  static unsigned sized = 0;  // devices whose shared-memory limit is set
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= 32) return cudaErrorInvalidDevice;
  if (!(sized >> dev & 1u)) {
    err = cudaFuncSetAttribute(qconv_wgmma<BN, T>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               Cfg<BN>::SMEM);
    if (err != cudaSuccess) return err;
    sized |= 1u << dev;
  }
  qconv_wgmma<BN, T>
      <<<(unsigned)tiles, Cfg<BN>::THREADS, Cfg<BN>::SMEM, stream>>>(
      ta, tb, x, bias, divisor, out, g, route, vec_out ? 1 : 0);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_bn(int bn, const CUtensorMap& ta, const CUtensorMap& tb,
                      const int8_t* x, const float* bias,
                      const float* divisor, T* out, const Geo& g,
                      int64_t tiles, int route, bool vec_out,
                      cudaStream_t stream) {
  return bn == 128 ? launch<128, T>(ta, tb, x, bias, divisor, out, g, tiles,
                                    route, vec_out, stream)
                   : launch<64, T>(ta, tb, x, bias, divisor, out, g, tiles,
                                   route, vec_out, stream);
}

}  // namespace

extern "C" {

// x: contiguous int8 (batch, h, w, cp), 16-byte aligned; cp % 16 == 0, or
// cp == 4 on the narrow route; wp: the packed weight from dt_qconv_pack,
// contiguous int8 (n, kh * kwp * cp) with kwp = kw (8 on the narrow
// route); bias: n floats or null; divisor: one float; out: contiguous
// (batch, oh, ow, n) of dtype (0 = float32, 1 = bfloat16).  ph, pw are
// the low pads (the high pads follow from oh, ow).  bn (64 or 128), route
// (0 tma: 1x1, stride 1, no padding; 1 gather; 2 narrow: cp 4, kw <= 8),
// vec_out (n * sizeof(T) % 16 == 0) and smem (Cfg<bn>::SMEM) come from the
// wrapper's plan; a launch that does not match them is refused.  batch *
// oh * ow > 0, n > 0.  Launches on `stream`; returns the launch's
// cudaError_t.
int dt_qconv(const void* x, const void* wp, const void* bias,
             const void* divisor, void* out, int64_t batch, int64_t h,
             int64_t w, int64_t cp, int kh, int kw, int n, int oh, int ow,
             int sh, int sw, int ph, int pw, int dtype, int bn, int route,
             int vec_out, int64_t smem, void* stream) {
  const int64_t m = batch * oh * ow;
  const bool narrow = route == ROUTE_NARROW;
  const int64_t kc = (int64_t)kh * (narrow ? 8 : kw) * cp;
  const int esize = dtype == 1 ? 2 : 4;
  if (m <= 0 || n <= 0 || kc <= 0 || kc >= (1ll << 31) ||
      h >= (1ll << 31) || w >= (1ll << 31) || !dt::aligned16(x) ||
      !dt::aligned16(wp) || (bn != 64 && bn != 128) ||
      smem != (bn == 128 ? Cfg<128>::SMEM : Cfg<64>::SMEM) ||
      (vec_out && (int64_t)n * esize % 16 != 0) || route < ROUTE_TMA ||
      route > ROUTE_NARROW || (narrow ? cp != 4 || kw > 8 : cp % 16 != 0))
    return (int)cudaErrorInvalidValue;
  if (route == ROUTE_TMA &&
      (kh != 1 || kw != 1 || sh != 1 || sw != 1 || ph != 0 || pw != 0 ||
       oh != h || ow != w || m >= (1ll << 31)))
    return (int)cudaErrorInvalidValue;
  const int n_tiles = (n + bn - 1) / bn;
  const int64_t tiles = (m + BM - 1) / BM * n_tiles;
  if (tiles >= (1ll << 31)) return (int)cudaErrorInvalidValue;
  Geo g{m, (int)h, (int)w, (int)cp, kh, kw, oh, ow, n, sh, sw, ph, pw,
        (int)kc, (int)((kc + BK - 1) / BK), n_tiles};
  CUtensorMap ta, tb;
  memset(&ta, 0, sizeof(ta));
  if ((route == ROUTE_TMA && !encode_2d(&ta, x, m, cp, BM)) ||
      !encode_2d(&tb, wp, n, kc, bn))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int8_t* xp = static_cast<const int8_t*>(x);
  const float* bp = static_cast<const float*>(bias);
  const float* dp = static_cast<const float*>(divisor);
  if (dtype == 1)
    return (int)launch_bn(bn, ta, tb, xp, bp, dp,
                          static_cast<__nv_bfloat16*>(out), g, tiles, route,
                          vec_out != 0, s);
  return (int)launch_bn(bn, ta, tb, xp, bp, dp, static_cast<float*>(out), g,
                        tiles, route, vec_out != 0, s);
}

// w: contiguous int8 (kh, kw, c, n) (HWIO); p: contiguous int8 (n, kh *
// kwp * cp), kwp >= kw, cp >= c.  Launches on `stream`; returns the
// launch's cudaError_t.
int dt_qconv_pack(const void* w, void* p, int kh, int kw, int kwp, int c,
                  int cp, int n, void* stream) {
  const int64_t kc = (int64_t)kh * kwp * cp;
  if (kc <= 0 || n <= 0 || cp < c || kwp < kw || kc >= (1ll << 31))
    return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)((kc + 63) / 64), (unsigned)((n + 63) / 64));
  qconv_pack_kernel<<<grid, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(w), static_cast<int8_t*>(p), kh, kw, kwp, c,
      cp, n);
  return (int)cudaGetLastError();
}

}  // extern "C"

DT_CUDA_ERROR_STRING
