// Flash attention forward: softmax(q k^T * scale) v with an online softmax
// over key tiles, f32 accumulators, optional causal mask; writes the output
// in q's dtype and the per-row logsumexp in f32.
//
// Replaces the Pallas TPU kernel `_attn_kernel` run by `_flash_fwd_pallas`
// for `flash_attention` (dt_tpu/ops/pallas/attention.py:40,100,213).  It
// computes what that kernel computes, not its block structure: the TPU grid
// (batch*heads, q blocks, kv blocks) runs its kv axis in order with the
// running max, sum and accumulator in VMEM scratch; here a CUDA block owns a
// q block of one (batch, head) and loops over the key tiles itself, with
// those running values in registers.  Per tile, as the TPU kernel does per
// kv block: m_new = max(m, rowmax(s)), p = exp(s - m_new), corr = exp(m -
// m_new), l = l * corr + sum(p), acc = acc * corr + p v.  Masked scores are
// -1e30 (finite, so a masked p is exp(-1e30 - m) = 0, never NaN); under
// `causal` the tiles past the block's last query row are skipped; at the end
// l is clamped at 1e-30, out = acc / l and lse = m + log(l).  The lse is
// (B*H, S), not the TPU's 128-lane broadcast.  No atomics and no split of
// the keys across blocks: two launches give the same bits.
//
// Bound: operations.  At the main path's shape (B*H = 64, S = 2048, D = 64,
// causal) a call does 4 * B*H * D * S(S+1)/2 = 34.4 GFLOP against 67 MB of
// q, k, v and out in bf16, far above the H100's ~295 operations per byte, so
// its least time is those operations at the tensor cores' 989 TFLOP/s (bf16)
// or, for f32, at the CUDA cores' 67 TFLOP/s (0.513 ms; done as 3xTF32 on
// the tensor cores it is 3 x 34.4 GFLOP at 495 TFLOP/s, 0.208 ms).  Both
// dtypes share one pipeline on Hopper's tensor cores:
//   - A block holds 64 query rows a consumer warpgroup and one producer
//     warp.  The producer's TMA loads bring the Q tile once and K/V tiles
//     into a two-stage shared-memory ring, with mbarriers for full and empty
//     stages, so the next tile's load overlaps this tile's products.  TMA
//     reads the (B, S, H, D) views through 4-D tensor maps over (D, H, S,
//     B) with the caller's strides (starts and strides on 16 bytes, which
//     the wrapper checks), writes the 128-byte swizzle wgmma reads (64 or
//     32 bytes where a tile's rows are that narrow: bf16 D = 32 and 16, f32
//     D = 16 and 8), and fills rows past S with 0.
//   - Head dims 8, 16, 32, 64 and 128.  A bf16 wgmma's K is 16, so at bf16
//     D = 8 the Q, K and V boxes are 16 wide over the 8 columns and TMA
//     fills the other 8 with 0: the products see zeros there and the store
//     writes D columns.  The f32 K step is 8, so f32 D = 8 needs no pad.
//   - The softmax runs on the f32 accumulators in log2 units (s * scale *
//     log2(e), one ex2 a score, the hardware's approximate exp2, 2 ulp); l
//     sums the f32 p.  Only tiles on the diagonal (or ragged past sk) are
//     masked; heavy q-blocks launch first (blockIdx.y counts down), so the
//     short ones fill the tail.
//
// bfloat16 (`tc::flash_fwd_tc`, the main path): two consumer warpgroups
//   (128 rows), 64-key tiles, two blocks an SM at D <= 64.
//   - S = Q K^T is a bf16 wgmma (m64nBKk16, both operands from shared
//     memory) into f32 registers: a bf16 product is exact in f32, so only
//     the order of the sums differs from the TPU kernel's upcast-then-dot.
//   - p is rounded to bf16, in registers, as the A operand of O += P V
//     (wgmma m64nDk16, V from shared memory, transposed): the one place
//     where the result departs from the TPU kernel's f32 p, by at most 2^-8
//     max|v|.  At D 8 and 16 p is split into two bf16 terms and P V is two
//     products, since one ulp of a row of so few columns is a tighter bound.
// float32 (`tc::flash_fwd_3xtf32`): 3xTF32.  Each f32 operand x is split
//   into hi = tf32(x) and lo = tf32(x - hi) (cvt.rna), and each product is
//   lo.hi + hi.lo + hi.hi into the f32 accumulators (wgmma m64nNk8 tf32):
//   what is dropped, lo.lo and the rounding of lo, is ~2^-22 of |x y|, so
//   the result keeps about f32 accuracy at a third of the TF32 rate.
//   - 32-bit wgmma operands must be K-major (no transpose bit).  Q and K
//     have D contiguous, so S = Q K^T reads them as TMA wrote them, split
//     in place (hi) and beside (lo) by the consumers.  V (keys x D) is not:
//     each tile is transposed by the consumers into V^T (D x keys) hi and lo
//     tiles before O += P V.
//   - P comes from registers: the accumulator gives a thread keys 2t, 2t +
//     1 of each group of 8, where a tf32 A fragment wants columns t and t +
//     4; V^T stores each group of 8 keys in the order 0 2 4 6 1 3 5 7, so
//     the fragment is the accumulator's registers as they are (route: V^T
//     permuted while it is transposed).
//   - Shared memory fits one block an SM (Cfg32: 176 KB at D 64 and 128),
//     two consumer warpgroups and 64-key tiles at D <= 64, one warpgroup
//     and 32-key tiles at D 128.  Each tile: the consumers split K and
//     transpose V, meet at a barrier, run S, the softmax and P V, and meet
//     again before the next tile's split.
//
// logf and the divisions are the correctly rounded (non fast-math)
// versions: nvcc is run without --use_fast_math.

#include <cuda.h>  // CUtensorMap and its enums; nothing new is linked

#include "common.cuh"

namespace {

constexpr float NEG_INF = -1e30f;

struct Strides {  // element strides of a (B, S, H, D) tensor, D's is 1
  int64_t b, s, h;
};

// ---------------------------------------------------------------------------
// tensor cores (wgmma), TMA loads, one producer warp; bfloat16 first
// ---------------------------------------------------------------------------
namespace tc {

constexpr int BQ = 128;            // query rows per block
constexpr int STAGES = 2;          // K/V tiles in flight
constexpr int CONSUMERS = 256;     // two warpgroups of 64 query rows each
constexpr int THREADS = CONSUMERS + 32;  // + the producer warp
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

// wgmma descriptor swizzle mode of a tile whose rows are `row` bytes: 1 =
// 128B, 2 = 64B, 3 = 32B (TMA writes the same pattern, `tma_swizzle`).
constexpr int swizzle_mode(int row) {
  return row == 128 ? 1 : row == 64 ? 2 : 3;
}

// Shared-memory geometry for head dim D.  The tiles are DP columns wide: D,
// or 16 at D = 8, since a bf16 wgmma's K is 16; the box of a D = 8 tensor is
// then 16 wide and TMA fills its columns past D with 0, so Q K^T and P V
// see zeros there and only D columns are stored.  A tile is stored as panels
// of PW columns, each row of a panel one swizzle row (128 bytes, or 64 at D =
// 32, 32 at D = 8 and 16), as TMA writes a box of (PW, rows) with that
// swizzle.
template <int D> struct Cfg {
  static constexpr int DP = D < 16 ? 16 : D;
  static constexpr int PW = DP < 64 ? DP : 64;
  static constexpr int NP = DP / PW;
  static constexpr int ROW = PW * 2;                // bytes of a panel row
  static constexpr int BK = 64;                    // keys per tile
  // blocks an SM holds: two at D <= 64 (~94 registers a thread), so that
  // four consumer warpgroups share its tensor cores and exp units; one at
  // D = 128, whose 64 f32 accumulators a thread would spill at two
  static constexpr int BLOCKS_PER_SM = D <= 64 ? 2 : 1;
  static constexpr int SWZ = swizzle_mode(ROW);
  // At D <= 16 p goes to the tensor cores as two bf16 terms, bf16(p) and
  // bf16(p - bf16(p)), two P V products: with so few columns a row, one
  // rounding of p (2^-9 of max |v|) can exceed one ulp of the row's
  // largest |out|, the bf16 kernel's bound; the second term leaves 2^-17.
  static constexpr bool SPLIT_P = D <= 16;
  static constexpr int Q_BYTES = BQ * DP * 2;
  static constexpr int KV_BYTES = BK * DP * 2;      // one K or V tile
  static constexpr int SMEM = 1024 + Q_BYTES + 2 * STAGES * KV_BYTES + 64;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_u32(bar))
               : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}

__device__ __forceinline__ uint64_t global_ns() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// Wait for the phase of `bar` with this parity to complete.  A wait that
// has not completed after 4 s traps (the launch then fails with an error)
// rather than hang the card on a pipeline fault.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t b = smem_u32(bar);
  if (mbar_try_wait(b, parity)) return;
  const uint64_t t0 = global_ns();
  while (!mbar_try_wait(b, parity)) {
    if (global_ns() - t0 > 4000000000ull) __trap();
  }
}

// TMA: a 4-D box of `map` at coordinates (c0 .. c3) into shared memory,
// completing `bytes` on `bar`.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int c0, int c1, int c2,
                                         int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%3, %4, %5, %6}], [%2];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// wgmma shared-memory matrix descriptor: start address, leading and stride
// byte offsets (16-byte units) and the swizzle mode.
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo,
                                         uint32_t sbo, int swizzle) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         static_cast<uint64_t>(lbo & 0x3FFF) << 16 |
         static_cast<uint64_t>(sbo & 0x3FFF) << 32 |
         static_cast<uint64_t>(swizzle) << 62;
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wg_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}
// Keep the compiler from moving reads or writes of an accumulator across
// the asynchronous product that owns it.
template <int N>
__device__ __forceinline__ void pin(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// The two bf16 halves of a pack_bf16 word, as floats.
__device__ __forceinline__ float bf16_lo(uint32_t w) {
  return __uint_as_float(w << 16);
}
__device__ __forceinline__ float bf16_hi(uint32_t w) {
  return __uint_as_float(w & 0xffff0000u);
}

// m64nNk16, bf16 in, f32 accumulators.  ss: A and B from shared memory
// (both K-major); rs: A from registers, B from shared memory, B transposed
// (its N axis contiguous, as V's rows hold the head dims).
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da,
                                            uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{" 
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da,
                                            uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{" 
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(accumulate));
}

__device__ __forceinline__ void wgmma_rs_n16(float (&d)[8],
                                            const uint32_t (&a)[4],
                                            uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, {%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_rs_n32(float (&d)[16],
                                            const uint32_t (&a)[4],
                                            uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{" 
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                            const uint32_t (&a)[4],
                                            uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{" 
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                            const uint32_t (&a)[4],
                                            uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{" 
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <int N>
__device__ __forceinline__ void mma_ss(float (&d)[N / 2], uint64_t da,
                                       uint64_t db, int accumulate) {
  if constexpr (N == 64) wgmma_ss_n64(d, da, db, accumulate);
  else wgmma_ss_n128(d, da, db, accumulate);
}

template <int N>
__device__ __forceinline__ void mma_rs(float (&d)[N / 2],
                                       const uint32_t (&a)[4], uint64_t db) {
  if constexpr (N == 16) wgmma_rs_n16(d, a, db);
  else if constexpr (N == 32) wgmma_rs_n32(d, a, db);
  else if constexpr (N == 64) wgmma_rs_n64(d, a, db);
  else wgmma_rs_n128(d, a, db);
}

// m64nNk8, tf32 in, f32 accumulators (3xTF32 kernel).  ss: A and B from
// shared memory, both K-major (32-bit operands take no transpose); rs: A
// from registers, B from shared memory, K-major.
__device__ __forceinline__ void tf32_ss_n32(float (&d)[16], uint64_t da,
                                            uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(accumulate));
}

__device__ __forceinline__ void tf32_ss_n64(float (&d)[32], uint64_t da,
                                            uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

__device__ __forceinline__ void tf32_rs_n8(float (&d)[4],
                                           const uint32_t (&a)[4],
                                           uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %9, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, %8, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void tf32_rs_n16(float (&d)[8],
                                            const uint32_t (&a)[4],
                                            uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, {%8, %9, %10, %11}, %12, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void tf32_rs_n32(float (&d)[16],
                                            const uint32_t (&a)[4],
                                            uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void tf32_rs_n64(float (&d)[32],
                                            const uint32_t (&a)[4],
                                            uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void tf32_rs_n128(float (&d)[64],
                                            const uint32_t (&a)[4],
                                            uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}


// grid (batch * heads, ceil(sq / BQ)); THREADS threads; Cfg<D>::SMEM bytes
// of dynamic shared memory.  Warps 0-7 are two consumer warpgroups (query
// rows q0 + 64 * wg ...), warp 8 the producer.
template <int D>
__global__ void __launch_bounds__(THREADS, Cfg<D>::BLOCKS_PER_SM)
    flash_fwd_tc(const __grid_constant__ CUtensorMap tq,
                 const __grid_constant__ CUtensorMap tk,
                 const __grid_constant__ CUtensorMap tv,
                 __nv_bfloat16* __restrict__ out, float* __restrict__ lse,
                 int heads, int sq, int sk, float scale_log2, int causal) {
  using C = Cfg<D>;
  constexpr int BK = C::BK, DP = C::DP;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  uint8_t* base = smem_raw + (((raw + 1023u) & ~1023u) - raw);  // swizzle
  uint8_t* q_s = base;                                            // atoms
  uint8_t* k_s = q_s + C::Q_BYTES;
  uint8_t* v_s = k_s + STAGES * C::KV_BYTES;
  uint64_t* full = reinterpret_cast<uint64_t*>(v_s + STAGES * C::KV_BYTES);
  uint64_t* empty = full + STAGES;
  uint64_t* q_full = empty + STAGES;

  const int bh = blockIdx.x;
  const int b = bh / heads, h = bh % heads;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;  // heavy q-blocks first
  const int n_kt = (sk + BK - 1) / BK;
  const int n_tiles = causal ? min(n_kt, (q0 + BQ - 1) / BK + 1) : n_kt;

  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], CONSUMERS);
    }
    mbar_init(q_full, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (warp == CONSUMERS / 32) {
    // producer: Q once, then K and V tile by tile into the ring
    if (lane == 0) {
      mbar_expect_tx(q_full, C::Q_BYTES);
#pragma unroll
      for (int p = 0; p < C::NP; ++p)
        tma_load(q_s + p * BQ * C::ROW, &tq, q_full, p * C::PW, h, q0, b);
      for (int t = 0; t < n_tiles; ++t) {
        const int s = t % STAGES;
        if (t >= STAGES) mbar_wait(&empty[s], (t / STAGES - 1) & 1);
        mbar_expect_tx(&full[s], 2 * C::KV_BYTES);
#pragma unroll
        for (int p = 0; p < C::NP; ++p) {
          tma_load(k_s + s * C::KV_BYTES + p * BK * C::ROW, &tk, &full[s],
                   p * C::PW, h, t * BK, b);
          tma_load(v_s + s * C::KV_BYTES + p * BK * C::ROW, &tv, &full[s],
                   p * C::PW, h, t * BK, b);
        }
      }
    }
    return;
  }

  // consumers: warpgroup wg owns rows [q0 + 64 wg, q0 + 64 wg + 64); this
  // thread the rows r and r + 8 of its warp's 16, columns 2 (lane % 4) + j
  // of every 8-column chunk (the wgmma accumulator layout)
  const int wg = warp / 4;
  const int row_lo = q0 + 64 * wg;
  const int r = row_lo + 16 * (warp % 4) + lane / 4;
  const int col = 2 * (lane % 4);
  const int my_tiles = causal ? min(n_kt, (row_lo + 63) / BK + 1) : n_kt;

  float o[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) o[i] = 0.0f;
  float m[2] = {NEG_INF, NEG_INF};  // running max of s * scale * log2(e)
  float l[2] = {0.0f, 0.0f};        // this thread's share of the row sums
  const uint32_t q_addr = smem_u32(q_s) + 64 * wg * C::ROW;
  constexpr uint32_t SBO = 8 * C::ROW / 16;  // 8-row core-matrix groups

  mbar_wait(q_full, 0);
  for (int t = 0; t < n_tiles; ++t) {
    const int s = t % STAGES;
    mbar_wait(&full[s], (t / STAGES) & 1);
    if (t < my_tiles) {  // uniform over the warpgroup
      // S = Q K^T: DP / 16 steps of 16 dims
      float sc[BK / 2];
      const uint32_t k_addr = smem_u32(k_s + s * C::KV_BYTES);
      wg_fence();
#pragma unroll
      for (int c = 0; c < DP / 16; ++c) {
        const int p = c * 16 / C::PW;                // panel
        const uint32_t in_row = c * 16 % C::PW * 2;  // bytes into its rows
        mma_ss<BK>(sc, desc(q_addr + p * BQ * C::ROW + in_row, 1, SBO, C::SWZ),
                   desc(k_addr + p * BK * C::ROW + in_row, 1, SBO, C::SWZ),
                   c > 0);
      }
      wg_commit();
      wg_wait_all();
      pin(sc);

      // scale into log2 units, mask the diagonal and ragged tiles
      const int k0 = t * BK;
      const bool mask = (causal && k0 + BK - 1 > row_lo) || k0 + BK > sk;
      float mx[2] = {m[0], m[1]};
#pragma unroll
      for (int i = 0; i < BK / 2; ++i) {
        const int half = (i / 2) % 2;  // row r or r + 8
        float v = sc[i] * scale_log2;
        if (mask) {
          const int key = k0 + 8 * (i / 4) + col + i % 2;
          if (key >= sk || (causal && key > r + 8 * half)) v = NEG_INF;
        }
        sc[i] = v;
        mx[half] = fmaxf(mx[half], v);
      }
      float corr[2];
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        mx[half] = fmaxf(mx[half], __shfl_xor_sync(0xffffffffu, mx[half], 1));
        mx[half] = fmaxf(mx[half], __shfl_xor_sync(0xffffffffu, mx[half], 2));
        corr[half] = ex2(m[half] - mx[half]);
        m[half] = mx[half];
      }
      // p = exp(s - m_new) in f32; l sums the f32 p; P goes to the tensor
      // cores rounded to bf16, in the A-operand layout of the P V product
      float ps[2] = {0.0f, 0.0f};
      uint32_t pa[BK / 16][4];
      uint32_t pl[C::SPLIT_P ? BK / 16 : 1][4];  // p - bf16(p), split only
#pragma unroll
      for (int c = 0; c < BK / 16; ++c) {
        float p[8];
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const int i = 8 * c + e;
          p[e] = ex2(sc[i] - m[(i / 2) % 2]);
          ps[(i / 2) % 2] += p[e];
        }
        pa[c][0] = pack_bf16(p[0], p[1]);  // row r,     keys 16c + col
        pa[c][1] = pack_bf16(p[2], p[3]);  // row r + 8, keys 16c + col
        pa[c][2] = pack_bf16(p[4], p[5]);  // row r,     keys 16c + 8 + col
        pa[c][3] = pack_bf16(p[6], p[7]);  // row r + 8, keys 16c + 8 + col
        if constexpr (C::SPLIT_P) {
#pragma unroll
          for (int j = 0; j < 4; ++j)
            pl[c][j] = pack_bf16(p[2 * j] - bf16_lo(pa[c][j]),
                                 p[2 * j + 1] - bf16_hi(pa[c][j]));
        }
      }
#pragma unroll
      for (int half = 0; half < 2; ++half) l[half] = l[half] * corr[half] +
                                                     ps[half];
#pragma unroll
      for (int i = 0; i < DP / 2; ++i) o[i] *= corr[(i / 2) % 2];

      // O += P V: BK / 16 steps of 16 keys
      const uint32_t v_addr = smem_u32(v_s + s * C::KV_BYTES);
      pin(o);
      wg_fence();
#pragma unroll
      for (int c = 0; c < BK / 16; ++c) {
        const uint64_t dv = desc(v_addr + c * 16 * C::ROW, BK * C::ROW / 16,
                                 SBO, C::SWZ);
        mma_rs<DP>(o, pa[c], dv);
        if constexpr (C::SPLIT_P) mma_rs<DP>(o, pl[c], dv);
      }
      wg_commit();
      wg_wait_all();
      pin(o);
    }
    mbar_arrive(&empty[s]);  // this thread is done with stage s
  }

  // out = acc / max(l, 1e-30), lse = m + log(l); rows past sq and columns
  // past D (the zero padding at D = 8) are not stored
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    float lt = l[half];
    lt += __shfl_xor_sync(0xffffffffu, lt, 1);
    lt += __shfl_xor_sync(0xffffffffu, lt, 2);
    const float lc = fmaxf(lt, 1e-30f);
    const int row = r + 8 * half;
    if (row >= sq) continue;
    __nv_bfloat16* orow = out + (((int64_t)b * sq + row) * heads + h) * D;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      const float* a = &o[4 * n + 2 * half];
      *reinterpret_cast<__nv_bfloat162*>(orow + 8 * n + col) =
          __floats2bfloat162_rn(a[0] / lc, a[1] / lc);
    }
    if (lane % 4 == 0) lse[(int64_t)bh * sq + row] = m[half] * LN2 + logf(lc);
  }
}

// cuTensorMapEncodeTiled, looked up once through the runtime's entry-point
// query (nothing beyond the runtime is linked).
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encoder() {
  static EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// A 4-D map over (D, heads, S, batch) of a (B, S, H, D) view with element
// strides st and `esize`-byte elements, boxes of (pw, 1, rows, 1); rows
// past S, and columns past D where pw > d, read as 0.
bool encode_map(CUtensorMap* map, CUtensorMapDataType type, int esize,
                int d, int pw, CUtensorMapSwizzle swizzle, const void* ptr,
                int64_t batch, int64_t heads, int64_t s, const Strides& st,
                int rows) {
  const cuuint64_t dims[4] = {(cuuint64_t)d, (cuuint64_t)heads, (cuuint64_t)s,
                              (cuuint64_t)batch};
  const cuuint64_t strides[3] = {(cuuint64_t)(st.h * esize),
                                 (cuuint64_t)(st.s * esize),
                                 (cuuint64_t)(st.b * esize)};
  const cuuint32_t box[4] = {(cuuint32_t)pw, 1, (cuuint32_t)rows, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const EncodeTiled fn = encoder();
  return fn != nullptr &&
         fn(map, type, 4, const_cast<void*>(ptr), dims, strides, box, unit,
            CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// TMA's swizzle for tiles of `row`-byte rows (the pattern swizzle_mode
// names to wgmma).
CUtensorMapSwizzle tma_swizzle(int row) {
  return row == 128  ? CU_TENSOR_MAP_SWIZZLE_128B
         : row == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                     : CU_TENSOR_MAP_SWIZZLE_32B;
}

// The bf16 kernel's map: panels of Cfg<D>::PW columns over the tensor's D
// (a D = 8 box is 16 wide: its columns past D read as 0).
template <int D>
bool encode(CUtensorMap* map, const void* ptr, int64_t batch, int64_t heads,
            int64_t s, const Strides& st, int rows) {
  using C = Cfg<D>;
  return encode_map(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, D, C::PW,
                    tma_swizzle(C::ROW), ptr, batch, heads, s, st, rows);
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   void* lse, int64_t batch, int64_t heads, int64_t sq,
                   int64_t sk, Strides qs, Strides ks, Strides vs, float scale,
                   bool causal, cudaStream_t stream) {
  using C = Cfg<D>;
  CUtensorMap tq, tk, tv;
  if (!encode<D>(&tq, q, batch, heads, sq, qs, BQ) ||
      !encode<D>(&tk, k, batch, heads, sk, ks, C::BK) ||
      !encode<D>(&tv, v, batch, heads, sk, vs, C::BK))
    return cudaErrorInvalidValue;
  static unsigned sized = 0;  // devices whose shared-memory limit is set
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= 32) return cudaErrorInvalidDevice;
  if (!(sized >> dev & 1u)) {
    err = cudaFuncSetAttribute(flash_fwd_tc<D>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               C::SMEM);
    if (err != cudaSuccess) return err;
    sized |= 1u << dev;
  }
  const dim3 grid((unsigned)(batch * heads), (unsigned)((sq + BQ - 1) / BQ));
  flash_fwd_tc<D><<<grid, THREADS, C::SMEM, stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(out), static_cast<float*>(lse),
      (int)heads, (int)sq, (int)sk, scale * LOG2E, causal ? 1 : 0);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// float32: 3xTF32 on the tensor cores (wgmma), the same TMA pipeline
// ---------------------------------------------------------------------------

// Round to TF32 (10 mantissa bits, to nearest, ties away from zero): the
// bits a tf32 wgmma operand keeps.
__device__ __forceinline__ float tf32_rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return __uint_as_float(r);
}

__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// Barrier 1 over the consumer threads (the producer warp keeps running).
__device__ __forceinline__ void consumers_sync(int count) {
  asm volatile("bar.sync 1, %0;" ::"r"(count) : "memory");
}

// Geometry for head dim D.  Q, K and V tiles are f32 panels of 32 columns
// (128-byte rows, 128-byte swizzle) written by TMA or by the split pass; at
// D 16 and 8 one panel of D columns, its rows 64 or 32 bytes with the
// swizzle of that width (one K step of 8 tf32 is 32 bytes, so no padding).
// V^T tiles are 128-byte panels of 32 keys at every D.  Shared memory a
// block, D 64: Q and Q_lo 2 x 32 KB, two stages of raw K and V 2 x 32 KB,
// K_lo, V^T and V^T_lo 3 x 16 KB: 176 KB, one block an SM.  D 128: one
// warpgroup of 64 rows and 32-key tiles keep the same 176 KB (128 rows and
// 64 keys would need 352 KB); D 32: 89 KB; D 16: 45 KB; D 8: 23 KB.
template <int D> struct Cfg32 {
  static constexpr int WG = D <= 64 ? 2 : 1;    // consumer warpgroups
  static constexpr int BQ = 64 * WG;            // query rows a block
  static constexpr int BK = D <= 64 ? 64 : 32;  // keys a tile
  static constexpr int CONSUMERS = 128 * WG;
  static constexpr int THREADS = CONSUMERS + 32;  // + the producer warp
  static constexpr int PW = D < 32 ? D : 32;      // f32 columns a panel
  static constexpr int ROW = PW * 4;              // bytes of a panel row
  static constexpr int SWZ = swizzle_mode(ROW);
  static constexpr int KPR = ROW / 32;            // K steps of 8 in a row
  static constexpr int NP = D / PW;               // panels of Q, K, V rows
  static constexpr int Q_BYTES = BQ * D * 4;
  static constexpr int KV_BYTES = BK * D * 4;  // one K, V or V^T tile
  static constexpr int SMEM =
      1024 + 2 * Q_BYTES + 2 * STAGES * KV_BYTES + 3 * KV_BYTES + 64;
};

// x -> (hi, lo) in place over `n` floats: hi = tf32(x) where x was, lo =
// tf32(x - hi) at the same offset of `lo` (the split is elementwise, so
// the swizzled layout carries over).
__device__ __forceinline__ void split_tile(float* x, float* lo, int n,
                                           int tid, int threads) {
  float4* x4 = reinterpret_cast<float4*>(x);
  float4* lo4 = reinterpret_cast<float4*>(lo);
  for (int i = tid; i < n / 4; i += threads) {
    const float4 v = x4[i];
    float4 h, l;
    h.x = tf32_rna(v.x);
    h.y = tf32_rna(v.y);
    h.z = tf32_rna(v.z);
    h.w = tf32_rna(v.w);
    l.x = tf32_rna(v.x - h.x);
    l.y = tf32_rna(v.y - h.y);
    l.z = tf32_rna(v.z - h.z);
    l.w = tf32_rna(v.w - h.w);
    x4[i] = h;
    lo4[i] = l;
  }
}

// Byte offset of f32 element (row, col) in a tile of ROW-byte panel rows
// with the swizzle of that width, `rows` rows a panel (the layout TMA writes
// and a K-major wgmma operand reads): the 16-byte chunk of a row is XORed
// with bits 7 and up of the row's offset (row % 8 at 128 bytes, row / 2 % 4
// at 64, row / 4 % 2 at 32), the tile starting on 1024 bytes.
template <int ROW = 128>
__device__ __forceinline__ int swz(int row, int col, int rows) {
  constexpr int PWF = ROW / 4, CHUNKS = ROW / 16;
  return (col / PWF) * rows * ROW + row * ROW +
         ((((col % PWF) / 4) ^ (row * ROW / 128 % CHUNKS)) * 16) +
         (col % 4) * 4;
}

// V (BK keys x D, from TMA, ROW-byte panel rows) -> V^T (D x BK, keys
// contiguous: the K-major B operand of O += P V, 128-byte panels) split into
// hi and lo.  Within each group of 8 keys V^T holds them in the order 0 2 4
// 6 1 3 5 7: the P fragment that the accumulator layout gives a thread
// (keys 2t and 2t + 1 of a group) then sits where a tf32 A fragment wants
// its columns t and t + 4.
template <int D, int BK, int ROW>
__device__ __forceinline__ void transpose_split(const uint8_t* v,
                                                uint8_t* vt_hi,
                                                uint8_t* vt_lo, int tid,
                                                int threads) {
  for (int q = tid; q < BK * D / 4; q += threads) {
    const int key = q % BK, dc = q / BK;  // lanes: neighbouring keys
    const float4 x = *reinterpret_cast<const float4*>(
        v + swz<ROW>(key, 4 * dc, BK));
    const int kk = key % 8;
    const int pos = key - kk + (kk % 2 ? 4 + kk / 2 : kk / 2);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float val = e == 0 ? x.x : e == 1 ? x.y : e == 2 ? x.z : x.w;
      const float hi = tf32_rna(val);
      const int off = swz(4 * dc + e, pos, D);
      *reinterpret_cast<float*>(vt_hi + off) = hi;
      *reinterpret_cast<float*>(vt_lo + off) = tf32_rna(val - hi);
    }
  }
}

template <int N>
__device__ __forceinline__ void mma32_ss(float (&d)[N / 2], uint64_t da,
                                         uint64_t db, int accumulate) {
  if constexpr (N == 32) tf32_ss_n32(d, da, db, accumulate);
  else tf32_ss_n64(d, da, db, accumulate);
}

template <int N>
__device__ __forceinline__ void mma32_rs(float (&d)[N / 2],
                                         const uint32_t (&a)[4],
                                         uint64_t db) {
  if constexpr (N == 8) tf32_rs_n8(d, a, db);
  else if constexpr (N == 16) tf32_rs_n16(d, a, db);
  else if constexpr (N == 32) tf32_rs_n32(d, a, db);
  else if constexpr (N == 64) tf32_rs_n64(d, a, db);
  else tf32_rs_n128(d, a, db);
}

// grid (batch * heads, ceil(sq / BQ)); THREADS threads; Cfg32<D>::SMEM
// bytes of dynamic shared memory.  Warps 0 .. 4 WG - 1 are the consumer
// warpgroups (query rows q0 + 64 * wg ...), the last warp the producer.
template <int D>
__global__ void __launch_bounds__(Cfg32<D>::THREADS, 1)
    flash_fwd_3xtf32(const __grid_constant__ CUtensorMap tq,
                     const __grid_constant__ CUtensorMap tk,
                     const __grid_constant__ CUtensorMap tv,
                     float* __restrict__ out, float* __restrict__ lse,
                     int heads, int sq, int sk, float scale_log2,
                     int causal) {
  using C = Cfg32<D>;
  constexpr int BK = C::BK, BQ = C::BQ, NC = C::CONSUMERS;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  uint8_t* base = smem_raw + (((raw + 1023u) & ~1023u) - raw);  // swizzle
  uint8_t* q_s = base;                                            // atoms
  uint8_t* q_lo = q_s + C::Q_BYTES;
  uint8_t* k_s = q_lo + C::Q_BYTES;
  uint8_t* v_s = k_s + STAGES * C::KV_BYTES;
  uint8_t* k_lo = v_s + STAGES * C::KV_BYTES;
  uint8_t* vt_hi = k_lo + C::KV_BYTES;
  uint8_t* vt_lo = vt_hi + C::KV_BYTES;
  uint64_t* full = reinterpret_cast<uint64_t*>(vt_lo + C::KV_BYTES);
  uint64_t* empty = full + STAGES;
  uint64_t* q_full = empty + STAGES;

  const int bh = blockIdx.x;
  const int b = bh / heads, h = bh % heads;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;  // heavy q-blocks first
  const int n_kt = (sk + BK - 1) / BK;
  const int n_tiles = causal ? min(n_kt, (q0 + BQ - 1) / BK + 1) : n_kt;

  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], NC);
    }
    mbar_init(q_full, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (warp == NC / 32) {
    // producer: Q once, then raw K and V tile by tile into the ring
    if (lane == 0) {
      mbar_expect_tx(q_full, C::Q_BYTES);
#pragma unroll
      for (int p = 0; p < C::NP; ++p)
        tma_load(q_s + p * BQ * C::ROW, &tq, q_full, p * C::PW, h, q0, b);
      for (int t = 0; t < n_tiles; ++t) {
        const int s = t % STAGES;
        if (t >= STAGES) mbar_wait(&empty[s], (t / STAGES - 1) & 1);
        mbar_expect_tx(&full[s], 2 * C::KV_BYTES);
#pragma unroll
        for (int p = 0; p < C::NP; ++p) {
          tma_load(k_s + s * C::KV_BYTES + p * BK * C::ROW, &tk, &full[s],
                   p * C::PW, h, t * BK, b);
          tma_load(v_s + s * C::KV_BYTES + p * BK * C::ROW, &tv, &full[s],
                   p * C::PW, h, t * BK, b);
        }
      }
    }
    return;
  }

  // consumers: warpgroup wg owns rows [q0 + 64 wg, q0 + 64 wg + 64); this
  // thread the rows r and r + 8 of its warp's 16, columns 2 (lane % 4) + j
  // of every 8-column chunk (the wgmma accumulator layout)
  const int tid = threadIdx.x;
  const int wg = warp / 4;
  const int row_lo = q0 + 64 * wg;
  const int r = row_lo + 16 * (warp % 4) + lane / 4;
  const int col = 2 * (lane % 4);
  const int my_tiles = causal ? min(n_kt, (row_lo + 63) / BK + 1) : n_kt;
  constexpr uint32_t SBO = 8 * C::ROW / 16;  // 8-row core-matrix groups
  constexpr uint32_t SBO_T = 8 * 128 / 16;   // the same in V^T's panels

  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.0f;
  float m[2] = {NEG_INF, NEG_INF};  // running max of s * scale * log2(e)
  float l[2] = {0.0f, 0.0f};        // this thread's share of the row sums
  const uint32_t q_hi_addr = smem_u32(q_s) + 64 * wg * C::ROW;
  const uint32_t q_lo_addr = smem_u32(q_lo) + 64 * wg * C::ROW;

  mbar_wait(q_full, 0);
  split_tile(reinterpret_cast<float*>(q_s), reinterpret_cast<float*>(q_lo),
             BQ * D, tid, NC);
  for (int t = 0; t < n_tiles; ++t) {
    const int s = t % STAGES;
    uint8_t* k_tile = k_s + s * C::KV_BYTES;
    mbar_wait(&full[s], (t / STAGES) & 1);
    // every consumer splits a share of K (in place) and transposes V
    split_tile(reinterpret_cast<float*>(k_tile),
               reinterpret_cast<float*>(k_lo), BK * D, tid, NC);
    transpose_split<D, BK, C::ROW>(v_s + s * C::KV_BYTES, vt_hi, vt_lo, tid,
                                   NC);
    fence_async_smem();  // the split tiles are read by wgmma
    consumers_sync(NC);

    float sc[BK / 2];
    if (t < my_tiles) {  // uniform over the warpgroup
      // S = Q K^T as lo.hi + hi.lo + hi.hi, D / 8 steps of 8 dims
      const uint32_t k_hi_addr = smem_u32(k_tile), k_lo_addr = smem_u32(k_lo);
      wg_fence();
#pragma unroll
      for (int c = 0; c < D / 8; ++c) {
        constexpr int KPR = C::KPR, SW = C::SWZ;
        const uint32_t at = c / KPR * BQ * C::ROW + c % KPR * 32;  // A: panel
        const uint32_t bt = c / KPR * BK * C::ROW + c % KPR * 32;  // B
        mma32_ss<BK>(sc, desc(q_lo_addr + at, 1, SBO, SW),
                     desc(k_hi_addr + bt, 1, SBO, SW), c > 0);
        mma32_ss<BK>(sc, desc(q_hi_addr + at, 1, SBO, SW),
                     desc(k_lo_addr + bt, 1, SBO, SW), 1);
        mma32_ss<BK>(sc, desc(q_hi_addr + at, 1, SBO, SW),
                     desc(k_hi_addr + bt, 1, SBO, SW), 1);
      }
      wg_commit();
      wg_wait_all();
      pin(sc);
    }
    mbar_arrive(&empty[s]);  // K (hi, in place) and V of stage s are done

    if (t < my_tiles) {
      // scale into log2 units, mask the diagonal and ragged tiles
      const int k0 = t * BK;
      const bool mask = (causal && k0 + BK - 1 > row_lo) || k0 + BK > sk;
      float mx[2] = {m[0], m[1]};
#pragma unroll
      for (int i = 0; i < BK / 2; ++i) {
        const int half = (i / 2) % 2;  // row r or r + 8
        float v = sc[i] * scale_log2;
        if (mask) {
          const int key = k0 + 8 * (i / 4) + col + i % 2;
          if (key >= sk || (causal && key > r + 8 * half)) v = NEG_INF;
        }
        sc[i] = v;
        mx[half] = fmaxf(mx[half], v);
      }
      float corr[2];
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        mx[half] = fmaxf(mx[half], __shfl_xor_sync(0xffffffffu, mx[half], 1));
        mx[half] = fmaxf(mx[half], __shfl_xor_sync(0xffffffffu, mx[half], 2));
        corr[half] = ex2(m[half] - mx[half]);
        m[half] = mx[half];
      }
      // p = exp(s - m_new) in f32; l sums it; P goes to the tensor cores
      // as hi (in sc) and lo, the A operand of O += P V
      float ps[2] = {0.0f, 0.0f};
      float lo[BK / 2];
#pragma unroll
      for (int i = 0; i < BK / 2; ++i) {
        const float p = ex2(sc[i] - m[(i / 2) % 2]);
        ps[(i / 2) % 2] += p;
        sc[i] = tf32_rna(p);
        lo[i] = tf32_rna(p - sc[i]);
      }
#pragma unroll
      for (int half = 0; half < 2; ++half) l[half] = l[half] * corr[half] +
                                                     ps[half];
#pragma unroll
      for (int i = 0; i < D / 2; ++i) o[i] *= corr[(i / 2) % 2];

      // O += P V as lo.hi + hi.lo + hi.hi, BK / 8 steps of 8 keys; the
      // fragment of a step: rows r, r + 8 at positions t (key 2t) and t + 4
      // (key 2t + 1), as V^T's key order has them
      const uint32_t vt_hi_addr = smem_u32(vt_hi);
      const uint32_t vt_lo_addr = smem_u32(vt_lo);
      pin(o);
      wg_fence();
#pragma unroll
      for (int c = 0; c < BK / 8; ++c) {
        const uint32_t a_hi[4] = {
            __float_as_uint(sc[4 * c]), __float_as_uint(sc[4 * c + 2]),
            __float_as_uint(sc[4 * c + 1]), __float_as_uint(sc[4 * c + 3])};
        const uint32_t a_lo[4] = {
            __float_as_uint(lo[4 * c]), __float_as_uint(lo[4 * c + 2]),
            __float_as_uint(lo[4 * c + 1]), __float_as_uint(lo[4 * c + 3])};
        const uint32_t bt = c / 4 * D * 128 + c % 4 * 32;
        mma32_rs<D>(o, a_lo, desc(vt_hi_addr + bt, 1, SBO_T, 1));
        mma32_rs<D>(o, a_hi, desc(vt_lo_addr + bt, 1, SBO_T, 1));
        mma32_rs<D>(o, a_hi, desc(vt_hi_addr + bt, 1, SBO_T, 1));
      }
      wg_commit();
      wg_wait_all();
      pin(o);
    }
    consumers_sync(NC);  // K_lo, V^T and V^T_lo are free for the next tile
  }

  // out = acc / max(l, 1e-30), lse = m + log(l); rows past sq are not stored
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    float lt = l[half];
    lt += __shfl_xor_sync(0xffffffffu, lt, 1);
    lt += __shfl_xor_sync(0xffffffffu, lt, 2);
    const float lc = fmaxf(lt, 1e-30f);
    const int row = r + 8 * half;
    if (row >= sq) continue;
    float* orow = out + (((int64_t)b * sq + row) * heads + h) * D;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      const float* a = &o[4 * n + 2 * half];
      *reinterpret_cast<float2*>(orow + 8 * n + col) =
          make_float2(a[0] / lc, a[1] / lc);
    }
    if (lane % 4 == 0) lse[(int64_t)bh * sq + row] = m[half] * LN2 + logf(lc);
  }
}

template <int D>
cudaError_t launch32(const void* q, const void* k, const void* v, void* out,
                     void* lse, int64_t batch, int64_t heads, int64_t sq,
                     int64_t sk, Strides qs, Strides ks, Strides vs,
                     float scale, bool causal, cudaStream_t stream) {
  using C = Cfg32<D>;
  CUtensorMap tq, tk, tv;
  const CUtensorMapDataType f32 = CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
  const CUtensorMapSwizzle swz = tma_swizzle(C::ROW);
  if (!encode_map(&tq, f32, 4, D, C::PW, swz, q, batch, heads, sq, qs,
                  C::BQ) ||
      !encode_map(&tk, f32, 4, D, C::PW, swz, k, batch, heads, sk, ks,
                  C::BK) ||
      !encode_map(&tv, f32, 4, D, C::PW, swz, v, batch, heads, sk, vs, C::BK))
    return cudaErrorInvalidValue;
  static unsigned sized = 0;  // devices whose shared-memory limit is set
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= 32) return cudaErrorInvalidDevice;
  if (!(sized >> dev & 1u)) {
    err = cudaFuncSetAttribute(flash_fwd_3xtf32<D>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               C::SMEM);
    if (err != cudaSuccess) return err;
    sized |= 1u << dev;
  }
  const dim3 grid((unsigned)(batch * heads),
                  (unsigned)((sq + C::BQ - 1) / C::BQ));
  flash_fwd_3xtf32<D><<<grid, C::THREADS, C::SMEM, stream>>>(
      tq, tk, tv, static_cast<float*>(out), static_cast<float*>(lse),
      (int)heads, (int)sq, (int)sk, scale * LOG2E, causal ? 1 : 0);
  return cudaGetLastError();
}

}  // namespace tc

}  // namespace

extern "C" {

// q, k, v: (batch, sq|sk, heads, d) with element strides (b, s, h) each and
// stride 1 along d, starts and strides on 16 bytes (TMA); out: contiguous
// (batch, sq, heads, d) of their dtype;
// lse: contiguous f32 (batch * heads, sq).  dtype: 0 = float32, 1 =
// bfloat16; d is 8, 16, 32, 64 or 128; batch * heads <= 65535; sq, sk >= 1.
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
  if (dtype == 0) {
    switch (d) {
      case 8:
        return tc::launch32<8>(q, k, v, out, lse, batch, heads, sq, sk, qs,
                               ks, vs, scale, causal != 0, s);
      case 16:
        return tc::launch32<16>(q, k, v, out, lse, batch, heads, sq, sk, qs,
                                ks, vs, scale, causal != 0, s);
      case 32:
        return tc::launch32<32>(q, k, v, out, lse, batch, heads, sq, sk, qs,
                                ks, vs, scale, causal != 0, s);
      case 64:
        return tc::launch32<64>(q, k, v, out, lse, batch, heads, sq, sk, qs,
                                ks, vs, scale, causal != 0, s);
      case 128:
        return tc::launch32<128>(q, k, v, out, lse, batch, heads, sq, sk, qs,
                                 ks, vs, scale, causal != 0, s);
      default:
        return (int)cudaErrorInvalidValue;
    }
  }
  if (dtype != 1) return (int)cudaErrorInvalidValue;
  switch (d) {
    case 8:
      return tc::launch<8>(q, k, v, out, lse, batch, heads, sq, sk, qs, ks, vs,
                           scale, causal != 0, s);
    case 16:
      return tc::launch<16>(q, k, v, out, lse, batch, heads, sq, sk, qs, ks,
                            vs, scale, causal != 0, s);
    case 32:
      return tc::launch<32>(q, k, v, out, lse, batch, heads, sq, sk, qs, ks,
                            vs, scale, causal != 0, s);
    case 64:
      return tc::launch<64>(q, k, v, out, lse, batch, heads, sq, sk, qs, ks,
                            vs, scale, causal != 0, s);
    case 128:
      return tc::launch<128>(q, k, v, out, lse, batch, heads, sq, sk, qs, ks,
                             vs, scale, causal != 0, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"

DT_CUDA_ERROR_STRING
