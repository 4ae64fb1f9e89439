// Flash attention for Hopper: K1 (forward) and K2 (dq, dk/dv), the bf16
// instances behind flash_attention_fwd, flash_attention_bwd_dq and
// flash_attention_bwd_dkv (flash_attention.cu), and the bf16 K8 forward,
// dq, dk/dv and dbias behind flash_mask_fwd, flash_mask_bwd_dq,
// flash_mask_bwd_dkv and flash_mask_bwd_dbias (flash_mask.cu), in their
// two modes: kIntervals (flashmask intervals) and kBiased (an additive
// bias, intervals optional; dbias is kBiased only).  Every kernel is a
// template on the head dim D, with instances at 64, 128 and 256 (the
// head dims the reference's sdpa sends to its Pallas kernels); the
// D-128 instances are the ones the text below measures.  The float32
// instances keep the CUDA-core bodies of flash_common.cuh.
//
// Each kernel computes what its TPU kernel computes
// (paddle_tpu/ops/pallas/flash_attention.py _fwd_kernel :523,
// _bwd_dq_kernel :925, _bwd_dkv_kernel :960; flash_mask.py _fwd_kernel
// :141, _bwd_dq_kernel :748, _bwd_dkv_kernel :791, _bwd_dbias_kernel
// :843 and their streamed twins _fwd_kernel_stream :267,
// _bwd_dq_kernel_stream :336, _bwd_dkv_kernel_stream :394,
// _bwd_dbias_kernel_stream :455), with the numerics listed in
// flash_attention.cu and flash_mask.cu, and is built the
// FlashAttention-3 way (Shah et al., 2024):
//   * warp specialisation: warpgroup 0 is the producer (one thread
//     issues TMA loads; setmaxnreg gives its registers away), the other
//     warpgroups are consumers, each owning 64 rows of the CTA's tile;
//   * every tile comes in by TMA (4-D tensor maps over the [B, H, S, D]
//     strided views, 128-byte swizzle, zero fill past S) into a
//     two-stage ring guarded by full/empty mbarriers, so loads overlap
//     the products;
//   * every product is a wgmma with its f32 accumulator in registers:
//     Q.K^T and dO.V^T read both operands from shared memory (K-major);
//     P.V, dS.K, P^T.dO and dS^T.Q take P or dS as the register A
//     operand straight from the score accumulator (rounded to bf16 in
//     registers) and V, K, dO or Q as an MN-major B (the transpose bit);
//     no score or accumulator tile passes through shared memory;
//   * softmax on the accumulator registers: scale * log2(e) folded into
//     one multiply, exp2f, row max by __shfl_xor_sync over the quad;
//   * the visibility test is one function of (query row, key column),
//     visible<kMode>(), applied only to key blocks that cross the
//     bottom-right aligned diagonal or the Sk edge (and, in the K8
//     modes, to blocks that an interval crosses: FlashMask's block
//     skipping, Wang et al., 2024, below);
//   * no float atomics: each output element is written by one CTA and
//     every sum is taken in a fixed order, so runs repeat bit for bit.
//
// Head dims: tiles come in as D / 64 panels of 64 columns (128 bytes, the
// swizzle's span), the Q.K^T and dO.V^T products take D / 16 k-steps and
// the P.V, dS.K, P^T.dO and dS^T.Q products N = D (m64nDk16).  D 64 keeps
// the D-128 tiling with every buffer halved.  At D 256 the budgets break:
// the forward takes 64-key tiles (O is 128 registers a consumer thread;
// Q [128, 256] is 64 KB), kBiased reads its bias into registers; dq and
// dk/dv let both consumer warpgroups share the CTA's 64 rows (keys) and
// split the head dim, 128 columns of dq (dk and dv) each, since one
// warpgroup owning 256 columns would hold 128 (256) accumulator
// registers; each warpgroup computes the tile's S and dP itself, so the
// score tiles still never pass through shared memory, at 1.67x (dq) and
// 1.5x (dk/dv) the ideal tensor work (FlashAttention-3 computes them
// once, split by query columns, and hands P and dS to the other
// warpgroup through shared memory: not done here); the dbias kernel
// keeps one stage and plain stores.  The D-256 forward and dk/dv spill
// (ptxas: 368-900 bytes), as the D-128 dk/dv does.
//
// Kernels:
//   * forward: one CTA per (128-row query block, q head, batch), 3
//     warpgroups; Q resident, 128-key K and V tiles in the ring (160 KB
//     of shared memory); O (64 x 128 f32 per warpgroup) stays in
//     registers until the epilogue divides by l and stores it.  The K8
//     modes add FlashMask's block skipping (Wang et al., 2024): a table
//     of the per-64-key-block minimum and maximum of every interval
//     vector (written by flash_mask.cu's table kernel just before)
//     classes each key tile of the CTA's query block as skip (an
//     interval hides all of it from every row: neither loaded nor
//     computed), clean (no interval touches it: no per-element test) or
//     partial (the per-element test, with the tile's interval ends
//     staged in shared memory by the producer warp).  kBiased takes
//     64-key tiles so that a tile's bias fits the consumers' registers
//     beside O and the scores; without intervals each thread copies the
//     next tile's bias pairs to its own shared-memory slots (cp.async)
//     while it computes this one, so the bias bytes, which bound it,
//     stream behind the products;
//   * dq: one CTA per (128-row query block, q head, batch), 3
//     warpgroups; a prologue takes delta = rowsum(out * dout) in f32 and
//     writes it out for the dk/dv kernel; Q and dO resident, 64-key K
//     and V tiles in the ring; per tile S = Q.K^T, dP = dO.V^T, then
//     dQ += dS.K.  The K8 modes class the 64-key tiles from the tile
//     table as the forward does (skipped tiles are neither loaded nor
//     computed); kBiased reads each tile's bias into registers while
//     Q.K^T runs;
//   * dk/dv: one CTA per (128-key block, kv head, batch), 3
//     warpgroups, each consumer owning 64 keys; K and V resident, 64-row
//     Q and dO tiles (with their lse and delta rows) in the ring, over
//     the GQA group's q heads and each head's query blocks from the
//     causal lower bound; per tile S^T = K.Q^T, dP^T = V.dO^T, then dV +=
//     P^T.dO and dK += dS^T.Q; the group's sums stay in f32 registers and
//     are rounded once.  The K8 modes class each (query tile, 64-key
//     block of a warpgroup) per q head from the tile table: a tile
//     hidden from both blocks is not loaded, a warpgroup whose block it
//     hides skips it; kBiased stages the tile's [64 q, 128 k] bias block
//     in the ring (TMA; the producer warp copies it where TMA cannot
//     take the bias), since a thread's pairs run along q.  Its 128
//     accumulator registers plus the 64 of
//     S^T and dP^T do not fit in 240 without ptxas spilling ~400 bytes
//     and serialising some wgmma.  64-key CTAs, two per SM at 232
//     registers (so that llama3_8b's 8 kv heads give 256 CTAs for the
//     132 SMs, not 128), spilled more and ran slower at every row of
//     tools/flash_ab.py, llama3_8b's included (NVIDIA H100 80GB HBM3,
//     700 W: 1.60 against 1.20 ms at b 8, h 16, s 2048; 0.66 against
//     0.52 at llama3_8b's b 1, h 32/8, s 2048).
//   * dbias: one CTA per (128-row query block, bias head, bias batch) on
//     dq's layout, walking the (batch, head) members that broadcast onto
//     the bias in order; per 64-key tile S = Q.K^T and dP = dO.V^T by
//     wgmma, ds = p (dP - delta) in registers; the running sum of the
//     members in f32 in device memory, the last member's ds rounded to
//     the bias dtype and stored by TMA from a staging box; tiles past the
//     causal trip count written as zeros by a second producer warp.  It
//     is bound by the bytes it writes (the whole [Sq, Sk] plane per bias
//     head and batch) and the bias it reads at visible pairs.
// Causal grids launch the heaviest blocks first: the query-block
// kernels take block x from the end, the dk/dv kernel's key block 0
// (which every query sees) is first already.
//
// Bounds on the H100 (989 TFLOP/s bf16, 3.35 TB/s): operations for K1,
// K2 and the interval kernels.  At the training shape (b 8, h 16, s
// 2048, d 128, causal: 268.6 M visible pairs) the forward does 4 *
// pairs * D = 137.5 GFLOP (0.139 ms), dq 6 * pairs * D (0.209 ms),
// dk/dv 8 * pairs * D (0.278 ms); the interval forward does 4 * pairs *
// D on the pairs the mask leaves (dq 6, dk/dv 8).  The biased forward is
// bound by the bias bytes it must read, those of the visible pairs
// (ALiBi's [1, 16, 2048, 2048] f32, causal: the lower triangle, 134.3
// MB; with q, k, v, out and lse 202 MB, 0.060 ms); the biased dq and
// dk/dv read the same bias bytes beside their operations.
//
// Left for later: overlapping one warpgroup's softmax with its next
// wgmma (two score buffers; issuing S of the next key block before P.V
// of this one, as written here, spilled and ran slower) and pingpong
// scheduling between the consumer warpgroups; persistent CTAs with a
// tile scheduler; TMA stores of the outputs; fp8; the K8 dk/dv's spills
// (its consumers hold 232 registers beside the producer warp's 40).
#pragma once

#include <climits>
#include <cuda.h>   // CUtensorMap (the encoder comes from the runtime's
                    // driver entry point: no -lcuda)

#include "flash_common.cuh"

namespace flash_sm90 {

using flash::kLseInvalid;
using flash::Mode;
using flash::Params;

constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// ---------------------------------------------------------------- PTX
__device__ __forceinline__ uint32_t smem_u32(const void* ptr) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// Arrive and expect ``bytes`` more from asynchronous copies.
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar),
               "r"(bytes)
               : "memory");
}

// Expect ``bytes`` more from asynchronous copies, without arriving.
__device__ __forceinline__ void mbar_expect(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.expect_tx.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ bool mbar_try(uint32_t bar, uint32_t parity) {
  uint32_t ok;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(ok)
      : "r"(bar), "r"(parity)
      : "memory");
  return ok != 0;
}

// Wait until the phase of ``parity`` has completed.  A ring that never
// fills (a fault in this file) traps after ~2^32 cycles, so it ends as
// a launch error instead of a hung card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  if (mbar_try(bar, parity)) return;
  const long long t0 = clock64();
  while (!mbar_try(bar, parity))
    if (clock64() - t0 > (1LL << 32)) __trap();
}

// One 64-column box (128 bytes of bf16, the swizzle's span) of rows
// [row, row + box rows) of head h, batch b, columns [col, col + 64).
__device__ __forceinline__ void tma_box(uint32_t dst, const CUtensorMap* map,
                                        uint32_t bar, int col, int row, int h,
                                        int b) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(col), "r"(row),
      "r"(h), "r"(b)
      : "memory");
}

// A [rows, D] tile as D / 64 panels of 64 columns, panel c at c * rows *
// 128 bytes: every box completes on ``bar``.
template <int D>
__device__ __forceinline__ void tma_tile(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int row, int h, int b,
                                         int rows) {
#pragma unroll
  for (int c = 0; c < D / 64; ++c)
    tma_box(dst + c * rows * 128, map, bar, 64 * c, row, h, b);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keep the compiler from moving reads of an accumulator above the
// wgmma.wait_group that completes it.
template <int N>
__device__ __forceinline__ void reg_fence(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

template <int N>
__device__ __forceinline__ void reg_dealloc() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}
template <int N>
__device__ __forceinline__ void reg_alloc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

__device__ __forceinline__ void consumer_sync(int threads) {
  asm volatile("bar.sync 1, %0;\n" ::"r"(threads) : "memory");
}

// wgmma shared-memory descriptors, 128-byte swizzle (layout type 1);
// addresses and offsets in 16-byte units.  K-major: 8-row groups 1024
// bytes apart (SBO), LBO unused.  MN-major: 64-element panels
// ``panel`` bytes apart (LBO), 8-row groups along K 1024 bytes apart.
__device__ __forceinline__ uint64_t desc_k(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (1ull << 16) |
         (64ull << 32) | (1ull << 62);
}
__device__ __forceinline__ uint64_t desc_mn(uint32_t addr, uint32_t panel) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(panel >> 4) << 16) | (64ull << 32) |
         (1ull << 62);
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f32(__half x) { return __half2float(x); }

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// d[64] (+)= A . B^T, m64n128k16: A [64, 16] and B [128, 16] both in
// shared memory, K-major (128-byte swizzle); scale_d 0 overwrites d.
__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t da,
                                        uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

// d[32] (+)= A . B^T, m64n64k16: A [64, 16] and B [64, 16] both in
// shared memory, K-major (128-byte swizzle); scale_d 0 overwrites d.
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da,
                                        uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// d[64] += A . B, m64n128k16: A [64, 16] bf16 in registers (the
// accumulator layout of a score tile, packed in pairs), B [16, 128] in
// shared memory, MN-major (128-byte swizzle, the transpose bit set).
// The d[32] (n64) and d[128] (n256) overloads below are the same product
// at head_dim 64 and 256.
__device__ __forceinline__ void wgmma_rs(float (&d)[64], uint32_t a0,
                                         uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[32], uint32_t a0,
                                         uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[128], uint32_t a0,
                                         uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(db), "r"(1));
}

// Add N (16-byte units) to the address field of a wgmma descriptor, in
// program order between the steps of a product, so that a product holds
// two descriptors live.
template <int N>
__device__ __forceinline__ void advance(uint64_t& desc) {
  asm volatile("add.s64 %0, %0, %1;\n" : "+l"(desc) : "n"(N));
}

// d (+)= A . B^T over the D head-dim columns (D / 16 k16 steps; the
// first overwrites d): A and B K-major tiles of AR and BR rows (D / 64
// swizzled panels each), at shared addresses a and b.
template <int AR, int BR, int D, int N>
__device__ __forceinline__ void gemm_abt(float (&d)[N], uint32_t a,
                                         uint32_t b) {
  uint64_t da = desc_k(a), db = desc_k(b);
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    wgmma_ss(d, da, db, kk);
    if (kk == D / 16 - 1) {
    } else if (kk % 4 == 3) {    // from column 48 of a panel to the next
      advance<(AR * 128 - 96) / 16>(da);
      advance<(BR * 128 - 96) / 16>(db);
    } else {
      advance<2>(da);
      advance<2>(db);
    }
  }
}

// d += A . B: A from a score accumulator s in registers (STEPS k16
// steps, rounded to bf16 as each step is issued), B an MN-major tile of
// 16 STEPS rows by 2 N columns (d holds N) at shared address b, its
// 64-column panels ROWS rows apart.  In the m64nN accumulator layout
// thread (g = lane / 4, t = lane % 4) of warp w holds rows 16 w + g (+
// 8), columns 8 j + 2 t (+ 1) in s[4 j .. 4 j + 3], which are the rows
// and columns that the A operand of a k16 step wants of it: step kk
// packs s[8 kk .. 8 kk + 7].
template <int STEPS, int ROWS, int N>
__device__ __forceinline__ void gemm_rs(float (&d)[N],
                                        const float (&s)[8 * STEPS],
                                        uint32_t b) {
  uint64_t db = desc_mn(b, ROWS * 128);
#pragma unroll
  for (int kk = 0; kk < STEPS; ++kk) {
    const float* a = s + 8 * kk;
    wgmma_rs(d, pack_bf16(a[0], a[1]), pack_bf16(a[2], a[3]),
             pack_bf16(a[4], a[5]), pack_bf16(a[6], a[7]), db);
    if (kk < STEPS - 1) advance<16 * 128 / 16>(db);
  }
}

// ------------------------------------------------------------ visibility
// A CTA's view of its (batch, q head): kPlain needs the lengths; the K8
// modes add the flashmask interval rows and their tile table, and the
// bias rows, resolved as flash_common.cuh's vis_for resolves them
// (stride 0 on a broadcast dim).
struct Vis {
  int sk;
  int diag;          // Sk - Sq: causal row q sees keys <= q + diag
  int causal;
  int sq;
  flash::Vis m;      // the interval rows (mask, m_sv, nvec) and bias rows
  const int2* tbl;   // [nvec, nblk]: {min, max} of each 64-key block
  int nblk;
};

// ``nh`` is the q-head count (the dk/dv kernel's p.H counts kv heads):
// the table has a row set per q head where the intervals have a head
// stride.
template <Mode kMode>
__device__ __forceinline__ Vis vis_for(const Params& p, int b, int h,
                                       int nh) {
  Vis v{p.sk, p.sk - p.sq, p.causal};
  if constexpr (kMode != flash::kPlain) {
    v.sq = p.sq;
    v.m = flash::vis_for(p, b, h);
    v.nblk = (p.sk + 63) / 64;
    const int hm = p.m_s[1] ? nh : 1;
    v.tbl = p.tbl + ((long long)((p.m_s[0] ? b : 0) * hm + (p.m_s[1] ? h : 0)) *
                     v.m.nvec) * v.nblk;
  }
  return v;
}

template <Mode kMode>
__device__ __forceinline__ Vis vis_for(const Params& p, int b, int h) {
  return vis_for<kMode>(p, b, h, p.H);
}

// Whether query row q sees key k: below Sk and, causal, at or left of
// the bottom-right aligned diagonal.
template <Mode kMode>
__device__ __forceinline__ bool visible(int q, int k, const Vis& v) {
  return k < v.sk && (!v.causal || k <= q + v.diag);
}

// The same in the K8 modes, given the interval ends e[0 .. nvec) of
// key k's column: also outside each masked row interval [e[2 i],
// e[2 i + 1]).  (An array reference, not a pointer, so that the ends
// stay in registers.)
template <Mode kMode>
__device__ __forceinline__ bool visible(int q, int k, const Vis& v,
                                        const int (&e)[4]) {
  static_assert(kMode != flash::kPlain, "intervals are a K8 mode's");
  bool vis = visible<kMode>(q, k, v);
#pragma unroll
  for (int i = 0; i < 4; i += 2)
    if (i < v.m.nvec && q >= e[i] && q < e[i + 1]) vis = false;
  return vis;
}

// Whether every key of [k0, k0 + n) is visible to every row from q0 on
// (row q0 sees the fewest), so the block needs no test.
__device__ __forceinline__ bool all_visible(int q0, int k0, int n,
                                            const Vis& v) {
  return k0 + n <= v.sk && (!v.causal || k0 + n - 1 <= q0 + v.diag);
}

// Key blocks of width n that rows [q0, q0 + rows) reach.
__device__ __forceinline__ int key_blocks(int q0, int rows, int n,
                                          const Vis& v) {
  const int nblk = (v.sk + n - 1) / n;
  if (!v.causal) return nblk;
  const int last = q0 + rows - 1 + v.diag;
  return last < 0 ? 0 : min(last / n + 1, nblk);
}

// The class of the BN-key tile kb for query rows [q0, qe), from the
// per-64-key-block minima and maxima of the interval ends (FlashMask's
// block skipping, Wang et al., 2024): kSkip when one interval hides
// every key of the tile from every row (start <= q0 and end >= qe in
// each column), kClean when none can touch it (start >= qe, end <= q0,
// or start >= end in every column), kPartial otherwise.  Keys past Sk
// are not in the table; the causal/Sk test masks them.
enum TileClass { kSkip, kPartial, kClean };

template <int BN>
__device__ __forceinline__ int tile_class(int kb, int q0, int qe,
                                          const Vis& v) {
  int cls = kClean;
  const int c0 = kb * (BN / 64), c1 = min(c0 + BN / 64, v.nblk);
#pragma unroll
  for (int i = 0; i < 4; i += 2) {
    if (i >= v.m.nvec) break;
    int smin = INT_MAX, smax = INT_MIN, emin = INT_MAX, emax = INT_MIN;
    for (int c = c0; c < c1; ++c) {
      const int2 st = v.tbl[i * v.nblk + c];
      const int2 en = v.tbl[(i + 1) * v.nblk + c];
      smin = min(smin, st.x);
      smax = max(smax, st.y);
      emin = min(emin, en.x);
      emax = max(emax, en.y);
    }
    if (smax <= q0 && emin >= qe) return kSkip;
    if (smin < qe && emax > q0 && smin < emax) cls = kPartial;
  }
  return cls;
}

// The producer warp's copy of the interval ends of keys [k0, k0 + BN)
// into a stage's [4, BN] area (its 32 lanes, plain loads: a row of Sk
// int32 need not be 16-byte aligned for TMA); keys past Sk read as 0.
template <int BN>
__device__ __forceinline__ void stage_ends(int* es, const Vis& v, int k0,
                                           int lane) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int u = 0; u < BN / 32; ++u) {
      const int k = k0 + lane + 32 * u;
      if (i < v.m.nvec)
        es[i * BN + lane + 32 * u] = k < v.sk ? v.m.mask[i * v.m.m_sv + k] : 0;
    }
}

// The elements of a thread's 64 x (4 J) score tile (query rows row and
// row + 8, key columns k0 + 8 j + 2 t (+ 1)) that a K8 mode hides, as
// bits (element 4 j + 2 r + c): with the interval ends of a partial
// tile's keys in ``ends`` ([nvec, 8 J] from key k0), else the causal/Sk
// test alone.  Each column's ends are read once for both rows; the
// rolled loops keep them out of the registers that the scores hold.
template <Mode kMode, int J>
__device__ __forceinline__ uint64_t hidden_keys(int row, int t, int k0,
                                                const Vis& vis,
                                                const int* ends) {
  uint64_t hide = 0;
  if (ends) {
#pragma unroll 1
    for (int j = 0; j < J; ++j)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int col = 8 * j + 2 * t + c;
        int e[4] = {0, 0, 0, 0};
#pragma unroll
        for (int i = 0; i < 4; ++i)
          if (i < vis.m.nvec) e[i] = ends[i * 8 * J + col];
#pragma unroll
        for (int r = 0; r < 2; ++r)
          if (!visible<kMode>(row + 8 * r, k0 + col, vis, e))
            hide |= 1ull << (4 * j + 2 * r + c);
      }
  } else {
#pragma unroll 1
    for (int j = 0; j < J; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (!visible<kMode>(row + 8 * (e >> 1), k0 + 8 * j + 2 * t + (e & 1),
                            vis))
          hide |= 1ull << (4 * j + e);
  }
  return hide;
}

__device__ __forceinline__ unsigned char* align_smem(unsigned char* raw,
                                                     uint32_t* base) {
  const uint32_t r = smem_u32(raw);
  *base = (r + 1023u) & ~1023u;
  return raw + (*base - r);
}

// Store the thread's two rows of a 64 x (N / 2) f32 accumulator (times
// ``mul``), as bf16, to rows row and row + 8 of ``dst`` (row stride
// ``rs``), skipping rows >= n.
template <int N>
__device__ __forceinline__ void store_rows(const float (&acc)[N],
                                           __nv_bfloat16* dst, long long rs,
                                           int row, int n, int t,
                                           const float (&mul)[2]) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (row + 8 * r >= n) continue;
    __nv_bfloat16* d = dst + (long long)(row + 8 * r) * rs + 2 * t;
#pragma unroll
    for (int j = 0; j < N / 4; ++j)
      *reinterpret_cast<uint32_t*>(d + 8 * j) =
          pack_bf16(acc[4 * j + 2 * r] * mul[r], acc[4 * j + 2 * r + 1] * mul[r]);
  }
}

// ------------------------------------------------------------- forward
// One CTA per (128-row query block, q head, batch), BN-key K and V tiles
// in the ring.  K1 and kIntervals take 128-key tiles; kBiased takes
// 64-key tiles, so that a tile's bias (read into registers while its
// Q.K^T runs) fits the consumers' registers beside O and the scores.  At
// head_dim 256 every mode takes 64-key tiles (Q [128, 256] is 64 KB, so
// two stages of 128-key K and V would need 320 KB; O is 128 registers a
// consumer thread, the scores 32) and kBiased reads the bias into
// registers (two staging areas of 32 KB would not fit beside the ring).
template <Mode kMode, int D>
struct FwdCfg {
  static constexpr int BM = 128;
  static constexpr int BN = kMode == flash::kBiased || D == 256 ? 64 : 128;
  static constexpr int NS = 2, NT = 384;
  // registers after setmaxnreg (168 x 384 at launch): K1's producer is
  // one thread, the K8 producer warp classes tiles and loads ends
  static constexpr int kProducerRegs = kMode == flash::kPlain ? 24 : 40;
  static constexpr int kConsumerRegs = kMode == flash::kPlain ? 240 : 232;
  static constexpr bool kBatchFirst = kMode == flash::kBiased;
  // kBiased stages each block's bias in shared memory (not at D 256)
  static constexpr bool kStaging = kMode == flash::kBiased && D != 256;
  static constexpr uint32_t kQTile = BM * D * 2;     // Q [128, D]
  static constexpr uint32_t kTile = BN * D * 2;      // K or V [BN, D]
  static constexpr uint32_t kQ = 0, kK = kQTile, kV = kK + NS * kTile;
  static constexpr uint32_t kBar = kV + NS * kTile;  // full_q, full_k, full_v, empty
  // the K8 modes add, per stage, the tile's interval ends [4, BN] and its
  // key block (2 kb + partial, or -1: no more blocks)
  static constexpr uint32_t kEnds = kBar + 64;
  static constexpr uint32_t kMeta = kEnds + NS * 4 * BN * 4;
  // kBiased: two bias staging areas, 8 bytes per (pair, consumer thread)
  static constexpr uint32_t kStage = kMeta + 64;
  static constexpr uint32_t kStageBytes = BN / 4 * 256 * 8;
  static constexpr size_t kSmem =
      (kMode == flash::kPlain ? kBar + 8 * (1 + 3 * NS)
       : kStaging             ? kStage + 2 * kStageBytes
                              : kMeta + NS * 4) +
      1024;
  static_assert(kSmem <= 232448, "a CTA has 227 KB of shared memory");
};

// Fold one key block (first key k0) of a 64 x (N / 2) score tile into
// the online softmax of rows ``row`` and ``row`` + 8: mask it where
// ``masked`` (with the block's interval ends from ``ends`` where it is
// partial), update m (log2 units) and l, turn the scores into p in
// place and return each row's rescale factor in alpha.  The logit is
// sc * sl2 (kBiased passes sl2 = 1: its scores are biased logits in
// log2 units already).  A row that has seen no visible key keeps m =
// -inf, takes alpha = 1 and m as 0 (its p are all 0).
template <Mode kMode, int N>
__device__ __forceinline__ void softmax_block(float (&sc)[N], int row, int t,
                                              int k0, bool masked,
                                              const Vis& vis, float sl2,
                                              float (&m)[2], float (&l)[2],
                                              float (&alpha)[2],
                                              const int* ends = nullptr) {
  constexpr int J = N / 4;              // 8-column groups of the block
  if (masked) {
    if constexpr (kMode == flash::kPlain) {
#pragma unroll
      for (int j = 0; j < J; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (!visible<kMode>(row + 8 * (e >> 1),
                              k0 + 8 * j + 2 * t + (e & 1), vis))
            sc[4 * j + e] = -INFINITY;
    } else {
      const uint64_t hide = hidden_keys<kMode, J>(row, t, k0, vis, ends);
#pragma unroll
      for (int e = 0; e < N; ++e)
        if ((hide >> e) & 1) sc[e] = -INFINITY;
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float mx = -INFINITY;
#pragma unroll
    for (int j = 0; j < J; ++j)
      mx = fmaxf(mx, fmaxf(sc[4 * j + 2 * r], sc[4 * j + 2 * r + 1]));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(m[r], mx * sl2);
    const bool dead = m_new == -INFINITY;
    alpha[r] = dead ? 1.f : exp2f(m[r] - m_new);
    const float ms = dead ? 0.f : m_new;
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < J; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float pe = exp2f(fmaf(sc[4 * j + 2 * r + e], sl2, -ms));
        sc[4 * j + 2 * r + e] = pe;
        sum += pe;
      }
    l[r] = l[r] * alpha[r] + sum;
    m[r] = m_new;
  }
}

// The bias of query rows row and row + 8 at key columns k0 + 8 j + 2 t
// (+ 1), in the accumulator layout of a 64 x (N / 2) score tile, as
// f32.  Rows past Sq read as 0 (the bias has no row there; they are not
// stored) and so do columns past Sk (their scores are masked).
// ``pair``: both columns of every pair are below Sk and each pair is
// aligned for one 8-byte (f32) or 4-byte (bf16, f16) load.
template <typename T, int N>
__device__ __forceinline__ void load_bias_t(float (&bz)[N], const Vis& v,
                                            int row, int k0, int t,
                                            bool pair) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int q = row + 8 * r;
    const T* src = static_cast<const T*>(v.m.bias) +
                   (long long)min(q, v.sq - 1) * v.m.b_ss + k0 + 2 * t;
#pragma unroll
    for (int j = 0; j < N / 4; ++j) {
      float2 x = make_float2(0.f, 0.f);
      if (q < v.sq) {
        if (pair) {
          if constexpr (std::is_same<T, float>::value) {
            x = *reinterpret_cast<const float2*>(src + 8 * j);
          } else if constexpr (std::is_same<T, __nv_bfloat16>::value) {
            x = __bfloat1622float2(
                *reinterpret_cast<const __nv_bfloat162*>(src + 8 * j));
          } else {
            x = __half22float2(*reinterpret_cast<const __half2*>(src + 8 * j));
          }
        } else {
          const int k = k0 + 8 * j + 2 * t;
          if (k < v.sk) x.x = to_f32(src[8 * j]);
          if (k + 1 < v.sk) x.y = to_f32(src[8 * j + 1]);
        }
      }
      bz[4 * j + 2 * r] = x.x;
      bz[4 * j + 2 * r + 1] = x.y;
    }
  }
}

template <int N>
__device__ __forceinline__ void load_bias(float (&bz)[N], const Vis& v,
                                          int row, int k0, int t, bool pair) {
  if (v.m.bias_dt == 0) {
    load_bias_t<float>(bz, v, row, k0, t, pair);
  } else if (v.m.bias_dt == 1) {
    load_bias_t<__nv_bfloat16>(bz, v, row, k0, t, pair);
  } else {
    load_bias_t<__half>(bz, v, row, k0, t, pair);
  }
}

// cp.async of one bias pair (``w`` = 8 or 4 bytes) into shared memory,
// zero-filling past ``valid`` bytes; commit and wait by group.
template <int W>
__device__ __forceinline__ void cp_pair(uint32_t dst, const void* src,
                                        int valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(dst),
               "l"(src), "n"(W), "r"(valid)
               : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Copy the thread's bias pairs of the block at key k0 (rows row and row +
// 8, columns k0 + 8 j + 2 t (+ 1)) to its slots of a staging area at
// shared address dst: pair (j, r) in slot (2 j + r) * 256 + ci, 8 bytes
// a slot for f32, 4 for bf16 and f16 (so that a warp reads 32 slots
// side by side).  Rows past Sq and columns past Sk fill with zeros.
// Needs aligned pairs.
template <int BN>
__device__ __forceinline__ void stage_bias(uint32_t dst, const Vis& v,
                                           int row, int k0, int t, int ci) {
  const int es = v.m.bias_dt == 0 ? 4 : 2;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int q = row + 8 * r;
    const char* src = static_cast<const char*>(v.m.bias) +
                      ((long long)min(q, v.sq - 1) * v.m.b_ss + k0 + 2 * t) * es;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int k = k0 + 8 * j + 2 * t;
      const int valid = q < v.sq ? max(0, min(2, v.sk - k)) * es : 0;
      const uint32_t slot = (2 * j + r) * 256 + ci;
      if (es == 4) {
        cp_pair<8>(dst + slot * 8, src + 8 * j * es, valid);
      } else {
        cp_pair<4>(dst + slot * 4, src + 8 * j * es, valid);
      }
    }
  }
}

// The thread's staged bias pairs as f32, in the accumulator layout.
template <int N>
__device__ __forceinline__ void read_staged(float (&bz)[N],
                                            const unsigned char* stage,
                                            int dt, int ci) {
#pragma unroll
  for (int j = 0; j < N / 4; ++j)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int slot = (2 * j + r) * 256 + ci;
      float2 x;
      if (dt == 0) {
        x = *reinterpret_cast<const float2*>(stage + slot * 8);
      } else if (dt == 1) {
        x = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(stage + slot * 4));
      } else {
        x = __half22float2(*reinterpret_cast<const __half2*>(stage + slot * 4));
      }
      bz[4 * j + 2 * r] = x.x;
      bz[4 * j + 2 * r + 1] = x.y;
    }
}

// One key block of a K8 consumer warpgroup, its K tile already in
// (stage at ka, va): S = Q.K^T by wgmma, the mask and online softmax,
// then O += P.V with p rounded to bf16 in registers.  K1 runs the same
// steps inline in fwd_kernel.  kBiased adds the bias in log2 units:
// with kStaged (no intervals, so the blocks come in order up to key
// kend, and aligned bias pairs) this block's bias is in the thread's
// slots of the staging area at ``stage`` and the next block's is copied
// to ``next_stage`` while this one runs; else it is read into registers
// while Q.K^T runs.
template <Mode kMode, int D, bool kStaged>
__device__ __forceinline__ void fwd_block(float (&o)[D / 2], float (&m)[2],
                                          float (&l)[2], uint32_t qa,
                                          uint32_t ka, uint32_t va,
                                          uint32_t full_v, uint32_t ph,
                                          int row, int t, int q0, int k0,
                                          const int* ends, const Vis& vis,
                                          float sl2, bool bias_pair,
                                          const unsigned char* stage,
                                          uint32_t next_stage, int ci,
                                          int kend) {
  using C = FwdCfg<kMode, D>;
  float sc[C::BN / 2], alpha[2];
  // the per-element test: blocks across the diagonal or Sk, and partial
  // blocks (whose interval ends are in ``ends``)
  const bool masked = ends || !all_visible(q0, k0, C::BN, vis);
  wg_fence();
  gemm_abt<C::BM, C::BN, D>(sc, qa, ka);
  wg_commit();
  if constexpr (kMode == flash::kBiased) {
    float bz[C::BN / 2];
    if constexpr (kStaged) {
      if (k0 + C::BN < kend)
        stage_bias<C::BN>(next_stage, vis, row, k0 + C::BN, t, ci);
      cp_commit();
      cp_wait<1>();                // this block's copies (the older group)
      read_staged(bz, stage, vis.m.bias_dt, ci);
    } else {
      load_bias(bz, vis, row, k0, t, bias_pair && k0 + C::BN <= vis.sk);
    }
    wg_wait<0>();
    reg_fence(sc);
#pragma unroll
    for (int i = 0; i < C::BN / 2; ++i)
      sc[i] = fmaf(sc[i], sl2, bz[i] * kLog2e);
    softmax_block<kMode>(sc, row, t, k0, masked, vis, 1.f, m, l, alpha, ends);
  } else {
    wg_wait<0>();
    reg_fence(sc);
    softmax_block<kMode>(sc, row, t, k0, masked, vis, sl2, m, l, alpha, ends);
  }
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    o[4 * j + 0] *= alpha[0];
    o[4 * j + 1] *= alpha[0];
    o[4 * j + 2] *= alpha[1];
    o[4 * j + 3] *= alpha[1];
  }

  // O += P.V: p rounded to bf16 in registers
  mbar_wait(full_v, ph);
  wg_fence();
  gemm_rs<C::BN / 16, C::BN>(o, sc, va);
  wg_commit();
  wg_wait<0>();
  reg_fence(o);
}

// kPlain (K1) walks every key block up to the causal bound.  The K8
// modes (kIntervals; kBiased, intervals optional) let the producer warp
// class the key blocks 32 at a time from the tile table (tile_class):
// it loads K and V only for the blocks that are not skipped, and then
// the interval ends of partial blocks (its 32 lanes, plain loads: a row
// of Sk int32 need not be 16-byte aligned for TMA) and the block index
// into the stage, and ends with an empty stage marked -1; the consumers
// walk the stages it fills.  A skipped block leaves m, l and O as they
// were, as one whose p are all 0 would.
template <Mode kMode, int D>
__global__ void __launch_bounds__(FwdCfg<kMode, D>::NT, 1)
    fwd_kernel(const __grid_constant__ CUtensorMap tq,
               const __grid_constant__ CUtensorMap tk,
               const __grid_constant__ CUtensorMap tv, const Params p) {
  using C = FwdCfg<kMode, D>;
  constexpr int BM = C::BM, BN = C::BN, NS = C::NS;
  constexpr uint32_t kQ = C::kQ, kK = C::kK, kV = C::kV, kBar = C::kBar;
  constexpr uint32_t kTile = C::kTile;
  extern __shared__ unsigned char smem_sm90[];
  uint32_t base;
  unsigned char* smem = align_smem(smem_sm90, &base);
  const uint32_t full_q = base + kBar;
  const auto full_k = [&](int s) { return base + kBar + 8 * (1 + s); };
  const auto full_v = [&](int s) { return base + kBar + 8 * (1 + NS + s); };
  const auto empty = [&](int s) { return base + kBar + 8 * (1 + 2 * NS + s); };

  // grid (query blocks, heads, batch); kBiased's is (batch, query
  // blocks, heads), so that one (query block, head) of every batch runs
  // side by side and a bias broadcast over the batch is read from L2
  // after the first
  int qb, h, b;
  if constexpr (C::kBatchFirst) {
    qb = p.causal ? gridDim.y - 1 - blockIdx.y : blockIdx.y;
    h = blockIdx.z;
    b = blockIdx.x;
  } else {
    qb = p.causal ? gridDim.x - 1 - blockIdx.x : blockIdx.x;
    h = blockIdx.y;
    b = blockIdx.z;
  }
  const int q0 = qb * BM;
  const Vis vis = vis_for<kMode>(p, b, h);
  const int upper = key_blocks(q0, BM, BN, vis);

  if (threadIdx.x == 0) {
    mbar_init(full_q, 1);
    for (int s = 0; s < NS; ++s) {
      // K8: all 32 lanes of the producer warp arrive on full_k
      mbar_init(full_k(s), kMode == flash::kPlain ? 1 : 32);
      mbar_init(full_v(s), 1);
      mbar_init(empty(s), 8);     // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // ---- producer
    reg_dealloc<C::kProducerRegs>();
    if constexpr (kMode == flash::kPlain) {
      if (threadIdx.x == 0) {
        const int hk = h / p.group;
        mbar_expect_tx(full_q, C::kQTile);
        tma_tile<D>(base + kQ, &tq, full_q, q0, h, b, BM);
        for (int kb = 0; kb < upper; ++kb) {
          const int s = kb % NS;
          mbar_wait(empty(s), ((kb / NS) & 1) ^ 1);
          mbar_expect_tx(full_k(s), kTile);
          tma_tile<D>(base + kK + s * kTile, &tk, full_k(s), kb * BN, hk, b, BN);
          mbar_expect_tx(full_v(s), kTile);
          tma_tile<D>(base + kV + s * kTile, &tv, full_v(s), kb * BN, hk, b, BN);
        }
      }
    } else if (threadIdx.x < 32) {
      int* ends_s = reinterpret_cast<int*>(smem + C::kEnds);
      int* meta_s = reinterpret_cast<int*>(smem + C::kMeta);
      const int lane = threadIdx.x;
      const int hk = h / p.group;
      if (lane == 0) {
        mbar_expect_tx(full_q, C::kQTile);
        tma_tile<D>(base + kQ, &tq, full_q, q0, h, b, BM);
      }
      const int qe = min(q0 + BM, p.sq);
      int it = 0;                       // stages filled
      for (int c = 0; c < upper; c += 32) {
        const int cls = c + lane < upper
                            ? tile_class<BN>(c + lane, q0, qe, vis)
                            : kSkip;
        unsigned live = __ballot_sync(0xffffffffu, cls != kSkip);
        const unsigned part = __ballot_sync(0xffffffffu, cls == kPartial);
        for (; live; live &= live - 1, ++it) {
          const int kb = c + __ffs(live) - 1;
          const int ivl = (part >> (kb - c)) & 1;
          const int s = it % NS;
          mbar_wait(empty(s), ((it / NS) & 1) ^ 1);
          if (lane == 0) {
            // the copies first; the lanes' arrivals complete full_k
            meta_s[s] = 2 * kb + ivl;
            mbar_expect(full_k(s), kTile);
            tma_tile<D>(base + kK + s * kTile, &tk, full_k(s), kb * BN, hk, b, BN);
            mbar_expect_tx(full_v(s), kTile);
            tma_tile<D>(base + kV + s * kTile, &tv, full_v(s), kb * BN, hk, b, BN);
          }
          if (ivl) stage_ends<BN>(ends_s + s * 4 * BN, vis, kb * BN, lane);
          mbar_arrive(full_k(s));
        }
      }
      const int s = it % NS;
      mbar_wait(empty(s), ((it / NS) & 1) ^ 1);
      if (lane == 0) meta_s[s] = -1;
      mbar_arrive(full_k(s));
    }
  } else {
    // ---- consumers: warpgroup cw owns tile rows [64 cw, 64 cw + 64)
    reg_alloc<C::kConsumerRegs>();
    const int ci = threadIdx.x - 128;
    const int cw = ci >> 7;
    const int warp = (ci >> 5) & 3;
    const int lane = ci & 31;
    const int g = lane >> 2;
    const int t = lane & 3;
    const int row = q0 + cw * 64 + warp * 16 + g;   // and row + 8
    const float sl2 = p.scale * kLog2e;
    const uint32_t qa = base + kQ + cw * 64 * 128;

    float o[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
    float m[2] = {-INFINITY, -INFINITY};
    float l[2] = {0.f, 0.f};
    mbar_wait(full_q, 0);

    if constexpr (kMode == flash::kPlain) {
      for (int kb = 0; kb < upper; ++kb) {
        const int s = kb % NS;
        const uint32_t ph = (kb / NS) & 1;
        const uint32_t ka = base + kK + s * kTile;
        const uint32_t va = base + kV + s * kTile;
        const int k0 = kb * BN;

        float sc[BN / 2], alpha[2];
        mbar_wait(full_k(s), ph);
        wg_fence();
        gemm_abt<BM, BN, D>(sc, qa, ka);
        wg_commit();
        wg_wait<0>();
        reg_fence(sc);
        softmax_block<kMode>(sc, row, t, k0, !all_visible(q0, k0, BN, vis),
                             vis, sl2, m, l, alpha);
#pragma unroll
        for (int j = 0; j < D / 8; ++j) {
          o[4 * j + 0] *= alpha[0];
          o[4 * j + 1] *= alpha[0];
          o[4 * j + 2] *= alpha[1];
          o[4 * j + 3] *= alpha[1];
        }

        // O += P.V: p rounded to bf16 in registers
        mbar_wait(full_v(s), ph);
        wg_fence();
        gemm_rs<BN / 16, BN>(o, sc, va);
        wg_commit();
        wg_wait<0>();
        reg_fence(o);
        if (lane == 0) mbar_arrive(empty(s));
      }
    } else {
      const int* ends_s = reinterpret_cast<const int*>(smem + C::kEnds);
      const int* meta_s = reinterpret_cast<const int*>(smem + C::kMeta);
      // kBiased: bias pairs load as one word where every row is aligned
      const bool bias_pair =
          vis.m.b_ss % 2 == 0 &&
          reinterpret_cast<uintptr_t>(vis.m.bias) % (vis.m.bias_dt ? 4 : 8) == 0;
      bool staged = false;
      if constexpr (C::kStaging) {
        staged = vis.m.nvec == 0 && bias_pair;
        if (staged) {
          // no intervals: every block up to the causal bound comes, in
          // order, so each block's bias is copied to shared memory during
          // the block before (the stages' meta is not read)
          const int kend = upper * BN;
          const uint32_t sa = base + C::kStage;
          if (upper > 0) stage_bias<BN>(sa, vis, row, 0, t, ci);
          cp_commit();
          for (int kb = 0; kb < upper; ++kb) {
            const int s = kb % NS;
            const uint32_t ph = (kb / NS) & 1;
            const int sb = kb & 1;
            mbar_wait(full_k(s), ph);
            fwd_block<kMode, D, true>(
                o, m, l, qa, base + kK + s * kTile, base + kV + s * kTile,
                full_v(s), ph, row, t, q0, kb * BN, nullptr, vis, sl2,
                bias_pair, smem + C::kStage + sb * C::kStageBytes,
                sa + (sb ^ 1) * C::kStageBytes, ci, kend);
            if (lane == 0) mbar_arrive(empty(s));
          }
        }
      }
      if (!staged) {
        for (int it = 0;; ++it) {
          const int s = it % NS;
          const uint32_t ph = (it / NS) & 1;
          mbar_wait(full_k(s), ph);
          const int meta = meta_s[s];
          if (meta < 0) break;
          fwd_block<kMode, D, false>(
              o, m, l, qa, base + kK + s * kTile, base + kV + s * kTile,
              full_v(s), ph, row, t, q0, (meta >> 1) * BN,
              (meta & 1) ? ends_s + s * 4 * BN : nullptr, vis, sl2,
              bias_pair, nullptr, 0, ci, 0);
          if (lane == 0) mbar_arrive(empty(s));
        }
      }
    }

    // epilogue: o / l, and lse = m + log(l) in natural-log units
    float inv[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float lt = l[r];
      lt += __shfl_xor_sync(0xffffffffu, lt, 1);
      lt += __shfl_xor_sync(0xffffffffu, lt, 2);
      inv[r] = lt > 0.f ? 1.f / lt : 0.f;
      if (p.lse && t == 0 && row + 8 * r < p.sq)
        p.lse[((long long)b * p.H + h) * p.sq + row + 8 * r] =
            lt > 0.f ? m[r] * kLn2 + logf(lt) : kLseInvalid;
    }
    __nv_bfloat16* og = static_cast<__nv_bfloat16*>(p.out) + b * p.o_s[0] +
                        h * p.o_s[1];
    store_rows(o, og, p.o_s[2], row, p.sq, t, inv);
  }
}

// ---------------------------------------------------------- backward dq
// One CTA per (BM-row query block, q head, batch), 64-key K and V tiles in
// the ring.  At head_dim 64 and 128 each consumer warpgroup owns 64 of
// the 128 rows.  At head_dim 256 (kSplit) the two warpgroups share the
// CTA's 64 rows and each owns 128 columns of dq: a warpgroup owning all
// 256 would hold 128 accumulator registers beside the 64 of S and dP.
// Each warpgroup then computes the tile's S and dP itself (twice the
// work of those two products; the dS.K product is split, not repeated).
template <int D>
struct DqCfg {
  static constexpr bool kSplit = D == 256;
  static constexpr int BM = kSplit ? 64 : 128, BN = 64, NS = 2, NT = 384;
  static constexpr int kAcc = kSplit ? 64 : D / 2;   // dq registers a thread
  static constexpr uint32_t kRes = BM * D * 2;       // Q or dO [BM, D]
  static constexpr uint32_t kTile = 64 * D * 2;      // K or V [64, D]
  static constexpr uint32_t kQ = 0, kDO = kRes, kK = 2 * kRes,
                            kV = kK + NS * kTile;
  static constexpr uint32_t kRows = kV + NS * kTile; // lse, delta [BM] f32
  static constexpr uint32_t kBar = kRows + 2 * BM * 4;  // full_q, full_k, full_v, empty
  static constexpr size_t kSmem = kBar + 8 * (1 + 3 * NS) + 1024;
  // the K8 modes add, per stage, the tile's interval ends [4, BN] and its
  // key block (2 kb + partial, or -1: no more blocks)
  static constexpr uint32_t kEnds = kBar + 64;
  static constexpr uint32_t kMeta = kEnds + NS * 4 * BN * 4;
  static constexpr size_t kSmemK8 = kMeta + NS * 4 + 1024;
  static_assert(kSmemK8 <= 232448, "a CTA has 227 KB of shared memory");
};

// log2 of the lanes that share a row of D bf16 columns, 8 columns a lane
template <int D>
constexpr int kRowLanesLog2 = D == 64 ? 3 : D == 128 ? 4 : 5;

__device__ __forceinline__ float dot8(uint4 a, uint4 b) {
  const __nv_bfloat162* x = reinterpret_cast<const __nv_bfloat162*>(&a);
  const __nv_bfloat162* y = reinterpret_cast<const __nv_bfloat162*>(&b);
  float acc = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 u = __bfloat1622float2(x[i]);
    const float2 w = __bfloat1622float2(y[i]);
    acc = fmaf(u.x, w.x, acc);
    acc = fmaf(u.y, w.y, acc);
  }
  return acc;
}

// The dq prologue of a consumer thread (ci of 256): delta = rowsum(out *
// dout) in f32 (written out for the dk/dv and dbias kernels) and lse,
// for the CTA's BM rows, into shared memory; rows past Sq take lse =
// LSE_INVALID, so their p are 0.
template <int D, int BM>
__device__ __forceinline__ void dq_rows(const Params& p, int b, int h,
                                        int q0, int ci, float* lse_s,
                                        float* delta_s) {
  constexpr int kL2 = kRowLanesLog2<D>, LPR = 1 << kL2;   // lanes a row
  const int lane = ci & 31;
  const long long row_base = ((long long)b * p.H + h) * p.sq;
  const __nv_bfloat16* og = static_cast<const __nv_bfloat16*>(p.o) +
                            b * p.o_s[0] + h * p.o_s[1];
  const __nv_bfloat16* dog = static_cast<const __nv_bfloat16*>(p.dout) +
                             b * p.do_s[0] + h * p.do_s[1];
  const int c = (lane & (LPR - 1)) * 8;
#pragma unroll 2
  for (int it = 0; it < BM / 8 / (32 / LPR); ++it) {
    const int r = (ci >> 5) * (BM / 8) + it * (32 / LPR) + (lane >> kL2);
    const int qi = q0 + r;
    float acc = 0.f;
    if (qi < p.sq)
      acc = dot8(*reinterpret_cast<const uint4*>(og + (long long)qi * p.o_s[2] + c),
                 *reinterpret_cast<const uint4*>(dog + (long long)qi * p.do_s[2] + c));
#pragma unroll
    for (int o = LPR / 2; o > 0; o >>= 1)
      acc += __shfl_xor_sync(0xffffffffu, acc, o);
    if ((lane & (LPR - 1)) == 0) {
      delta_s[r] = acc;
      lse_s[r] = qi < p.sq ? p.lse[row_base + qi] : kLseInvalid;
      if (qi < p.sq) p.delta[row_base + qi] = acc;
    }
  }
  consumer_sync(256);
}

// The K8 modes of the dq kernel (kIntervals; kBiased, intervals
// optional).  The producer warp classes the CTA's 64-key tiles 32 at a
// time from the tile table (tile_class<64>, a lane each, a ballot), as
// the K8 forward's does: it loads K and V only for the tiles that are
// not skipped, stages the interval ends of partial tiles and the tile's
// index (2 kb + partial) and ends the walk with an empty stage marked
// -1.  A skipped tile leaves dq as it was (all its p are 0).  The
// per-element test runs on partial tiles (interval ends from the stage)
// and on tiles that cross the causal diagonal or Sk.  kBiased adds the
// bias in log2 units to the recomputed logit, its 64 x 64 block per
// warpgroup read into registers while Q.K^T runs; its grid is (batch,
// query blocks, heads), so that a bias broadcast over the batch is read
// from L2 after the first.
template <Mode kMode, int D>
__device__ __forceinline__ void dq_k8(const CUtensorMap& tq,
                                      const CUtensorMap& tdo,
                                      const CUtensorMap& tk,
                                      const CUtensorMap& tv, const Params& p) {
  using C = DqCfg<D>;
  constexpr int BM = C::BM, BN = C::BN, NS = C::NS;
  constexpr uint32_t kRes = C::kRes, kTile = C::kTile, kQ = C::kQ,
                     kDO = C::kDO, kK = C::kK, kV = C::kV, kRows = C::kRows,
                     kBar = C::kBar, kEnds = C::kEnds, kMeta = C::kMeta;
  extern __shared__ unsigned char smem_sm90[];
  uint32_t base;
  unsigned char* smem = align_smem(smem_sm90, &base);
  float* lse_s = reinterpret_cast<float*>(smem + kRows);
  float* delta_s = lse_s + BM;
  int* ends_s = reinterpret_cast<int*>(smem + kEnds);
  int* meta_s = reinterpret_cast<int*>(smem + kMeta);
  const uint32_t full_q = base + kBar;
  const auto full_k = [&](int s) { return base + kBar + 8 * (1 + s); };
  const auto full_v = [&](int s) { return base + kBar + 8 * (1 + NS + s); };
  const auto empty = [&](int s) { return base + kBar + 8 * (1 + 2 * NS + s); };

  int qb, h, b;
  if constexpr (kMode == flash::kBiased) {
    qb = p.causal ? gridDim.y - 1 - blockIdx.y : blockIdx.y;
    h = blockIdx.z;
    b = blockIdx.x;
  } else {
    qb = p.causal ? gridDim.x - 1 - blockIdx.x : blockIdx.x;
    h = blockIdx.y;
    b = blockIdx.z;
  }
  const int q0 = qb * BM;
  const Vis vis = vis_for<kMode>(p, b, h);
  const int upper = key_blocks(q0, BM, BN, vis);

  if (threadIdx.x == 0) {
    mbar_init(full_q, 1);
    for (int s = 0; s < NS; ++s) {
      mbar_init(full_k(s), 32);         // the producer warp's lanes
      mbar_init(full_v(s), 1);
      mbar_init(empty(s), 8);           // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // ---- producer: one warp classes the tiles and fills the stages
    reg_dealloc<40>();
    if (threadIdx.x < 32) {
      const int lane = threadIdx.x;
      const int hk = h / p.group;
      if (lane == 0) {
        mbar_expect_tx(full_q, 2 * kRes);
        tma_tile<D>(base + kQ, &tq, full_q, q0, h, b, BM);
        tma_tile<D>(base + kDO, &tdo, full_q, q0, h, b, BM);
      }
      const int qe = min(q0 + BM, p.sq);
      int it = 0;                       // stages filled
      for (int c = 0; c < upper; c += 32) {
        const int cls = c + lane < upper
                            ? tile_class<BN>(c + lane, q0, qe, vis)
                            : kSkip;
        unsigned live = __ballot_sync(0xffffffffu, cls != kSkip);
        const unsigned part = __ballot_sync(0xffffffffu, cls == kPartial);
        for (; live; live &= live - 1, ++it) {
          const int kb = c + __ffs(live) - 1;
          const int ivl = (part >> (kb - c)) & 1;
          const int s = it % NS;
          mbar_wait(empty(s), ((it / NS) & 1) ^ 1);
          if (lane == 0) {
            // the copies first; the lanes' arrivals complete full_k
            meta_s[s] = 2 * kb + ivl;
            mbar_expect(full_k(s), kTile);
            tma_tile<D>(base + kK + s * kTile, &tk, full_k(s), kb * BN, hk, b, BN);
            mbar_expect_tx(full_v(s), kTile);
            tma_tile<D>(base + kV + s * kTile, &tv, full_v(s), kb * BN, hk, b, BN);
          }
          if (ivl) stage_ends<BN>(ends_s + s * 4 * BN, vis, kb * BN, lane);
          mbar_arrive(full_k(s));
        }
      }
      const int s = it % NS;
      mbar_wait(empty(s), ((it / NS) & 1) ^ 1);
      if (lane == 0) meta_s[s] = -1;
      mbar_arrive(full_k(s));
    }
  } else {
    // ---- consumers: warpgroup cw owns tile rows [64 cw, 64 cw + 64)
    reg_alloc<232>();
    const int ci = threadIdx.x - 128;
    const int cw = ci >> 7;
    const int warp = (ci >> 5) & 3;
    const int lane = ci & 31;
    const int g = lane >> 2;
    const int t = lane & 3;
    dq_rows<D, BM>(p, b, h, q0, ci, lse_s, delta_s);
    // kSplit: both warpgroups take rows [0, 64), warpgroup cw dq's columns
    // [128 cw, 128 cw + 128)
    const int rw = C::kSplit ? 0 : cw * 64;       // the warpgroup's rows
    const int tr = rw + warp * 16 + g;            // tile rows tr, tr + 8
    const int row = q0 + tr;
    const float sl2 = p.scale * kLog2e;
    const float lse2[2] = {lse_s[tr] * kLog2e, lse_s[tr + 8] * kLog2e};
    const float dlt[2] = {delta_s[tr], delta_s[tr + 8]};
    const uint32_t qa = base + kQ + rw * 128;
    const uint32_t doa = base + kDO + rw * 128;
    const int dcol = C::kSplit ? cw * 128 : 0;    // the warpgroup's dq columns
    // kBiased: bias pairs load as one word where every row is aligned
    const bool bias_pair =
        kMode == flash::kBiased && vis.m.b_ss % 2 == 0 &&
        reinterpret_cast<uintptr_t>(vis.m.bias) % (vis.m.bias_dt ? 4 : 8) == 0;

    float dq[C::kAcc];
#pragma unroll
    for (int i = 0; i < C::kAcc; ++i) dq[i] = 0.f;
    mbar_wait(full_q, 0);

    for (int it = 0;; ++it) {
      const int s = it % NS;
      const uint32_t ph = (it / NS) & 1;
      mbar_wait(full_k(s), ph);
      const int meta = meta_s[s];
      if (meta < 0) break;
      const uint32_t ka = base + kK + s * kTile;
      const uint32_t va = base + kV + s * kTile;
      const int k0 = (meta >> 1) * BN;
      const int* ends = (meta & 1) ? ends_s + s * 4 * BN : nullptr;

      float sc[32], dp[32];
      wg_fence();
      gemm_abt<BM, BN, D>(sc, qa, ka);
      wg_commit();
      // the logit in log2 units less lse, s * scale * log2 e (+ bias *
      // log2 e) - lse * log2 e, as the forward took it
      float off[32];
      if constexpr (kMode == flash::kBiased) {
        load_bias(off, vis, row, k0, t, bias_pair && k0 + BN <= vis.sk);
#pragma unroll
        for (int i = 0; i < 32; ++i)
          off[i] = fmaf(off[i], kLog2e, -lse2[(i >> 1) & 1]);
      } else {
#pragma unroll
        for (int i = 0; i < 32; ++i) off[i] = -lse2[(i >> 1) & 1];
      }
      mbar_wait(full_v(s), ph);
      gemm_abt<BM, BN, D>(dp, doa, va);
      wg_commit();

      // p = exp2(logit - lse), 0 where invisible
      wg_wait<1>();
      reg_fence(sc);
      uint64_t hide = 0;
      if (ends || !all_visible(q0, k0, BN, vis))
        hide = hidden_keys<kMode, 8>(row, t, k0, vis, ends);
#pragma unroll
      for (int e = 0; e < 32; ++e) {
        const float pe = exp2f(fmaf(sc[e], sl2, off[e]));
        sc[e] = (hide >> e) & 1 ? 0.f : pe;
      }
      // ds = p (dp - delta) scale, rounded to bf16 for dq += ds K
      wg_wait<0>();
      reg_fence(dp);
#pragma unroll
      for (int e = 0; e < 32; ++e)
        dp[e] = sc[e] * (dp[e] - dlt[(e >> 1) & 1]) * p.scale;
      wg_fence();
      gemm_rs<BN / 16, BN>(dq, dp, ka + dcol / 64 * BN * 128);
      wg_commit();
      wg_wait<0>();
      reg_fence(dq);
      if (lane == 0) mbar_arrive(empty(s));
    }

    __nv_bfloat16* dqg = static_cast<__nv_bfloat16*>(p.dq) + b * p.dq_s[0] +
                         h * p.dq_s[1] + dcol;
    const float one[2] = {1.f, 1.f};
    store_rows(dq, dqg, p.dq_s[2], row, p.sq, t, one);
  }
}

// kPlain (K2) walks every key tile up to the causal bound; the K8 modes
// are dq_k8.  K2's body is written out here, apart from dq_k8's, so that
// K2 compiles to the same SASS as before the K8 modes came
// (tools/flash_ab.py prints each kernel's digest).
template <Mode kMode, int D>
__global__ void __launch_bounds__(DqCfg<D>::NT, 1)
    dq_kernel(const __grid_constant__ CUtensorMap tq,
              const __grid_constant__ CUtensorMap tdo,
              const __grid_constant__ CUtensorMap tk,
              const __grid_constant__ CUtensorMap tv, const Params p) {
  if constexpr (kMode != flash::kPlain) {
    dq_k8<kMode, D>(tq, tdo, tk, tv, p);
  } else {
    using C = DqCfg<D>;
    constexpr int BM = C::BM, BN = C::BN, NS = C::NS;
    constexpr uint32_t kRes = C::kRes, kTile = C::kTile, kQ = C::kQ,
                       kDO = C::kDO, kK = C::kK, kV = C::kV,
                       kRows = C::kRows, kBar = C::kBar;
    constexpr int kL2 = kRowLanesLog2<D>, LPR = 1 << kL2;  // lanes a row
    extern __shared__ unsigned char smem_sm90[];
    uint32_t base;
    unsigned char* smem = align_smem(smem_sm90, &base);
    float* lse_s = reinterpret_cast<float*>(smem + kRows);
    float* delta_s = lse_s + BM;
    const uint32_t full_q = base + kBar;
    const auto full_k = [&](int s) { return base + kBar + 8 * (1 + s); };
    const auto full_v = [&](int s) { return base + kBar + 8 * (1 + NS + s); };
    const auto empty = [&](int s) { return base + kBar + 8 * (1 + 2 * NS + s); };

    const int qb = p.causal ? gridDim.x - 1 - blockIdx.x : blockIdx.x;
    const int q0 = qb * BM;
    const int h = blockIdx.y;
    const int b = blockIdx.z;
    const Vis vis{p.sk, p.sk - p.sq, p.causal};
    const int upper = key_blocks(q0, BM, BN, vis);

    if (threadIdx.x == 0) {
      mbar_init(full_q, 1);
      for (int s = 0; s < NS; ++s) {
        mbar_init(full_k(s), 1);
        mbar_init(full_v(s), 1);
        mbar_init(empty(s), 8);
      }
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();

    if (threadIdx.x < 128) {
      reg_dealloc<24>();
      if (threadIdx.x == 0) {
        const int hk = h / p.group;
        mbar_expect_tx(full_q, 2 * kRes);
        tma_tile<D>(base + kQ, &tq, full_q, q0, h, b, BM);
        tma_tile<D>(base + kDO, &tdo, full_q, q0, h, b, BM);
        for (int kb = 0; kb < upper; ++kb) {
          const int s = kb % NS;
          mbar_wait(empty(s), ((kb / NS) & 1) ^ 1);
          mbar_expect_tx(full_k(s), kTile);
          tma_tile<D>(base + kK + s * kTile, &tk, full_k(s), kb * BN, hk, b, BN);
          mbar_expect_tx(full_v(s), kTile);
          tma_tile<D>(base + kV + s * kTile, &tv, full_v(s), kb * BN, hk, b, BN);
        }
      }
    } else {
      reg_alloc<240>();
      const int ci = threadIdx.x - 128;
      const int cw = ci >> 7;
      const int warp = (ci >> 5) & 3;
      const int lane = ci & 31;
      const int g = lane >> 2;
      const int t = lane & 3;
      const long long row_base = ((long long)b * p.H + h) * p.sq;

      // prologue: delta = rowsum(out * dout) in f32 (written out for the
      // dk/dv kernel) and lse, for the CTA's BM rows; rows past Sq take
      // lse = LSE_INVALID, so their p are 0
      {
        const __nv_bfloat16* og = static_cast<const __nv_bfloat16*>(p.o) +
                                  b * p.o_s[0] + h * p.o_s[1];
        const __nv_bfloat16* dog = static_cast<const __nv_bfloat16*>(p.dout) +
                                   b * p.do_s[0] + h * p.do_s[1];
        const int c = (lane & (LPR - 1)) * 8;
  #pragma unroll 2
        for (int it = 0; it < BM / 8 / (32 / LPR); ++it) {
          const int r = (ci >> 5) * (BM / 8) + it * (32 / LPR) + (lane >> kL2);
          const int qi = q0 + r;
          float acc = 0.f;
          if (qi < p.sq)
            acc = dot8(*reinterpret_cast<const uint4*>(
                           og + (long long)qi * p.o_s[2] + c),
                       *reinterpret_cast<const uint4*>(
                           dog + (long long)qi * p.do_s[2] + c));
  #pragma unroll
          for (int o = LPR / 2; o > 0; o >>= 1)
            acc += __shfl_xor_sync(0xffffffffu, acc, o);
          if ((lane & (LPR - 1)) == 0) {
            delta_s[r] = acc;
            lse_s[r] = qi < p.sq ? p.lse[row_base + qi] : kLseInvalid;
            if (qi < p.sq) p.delta[row_base + qi] = acc;
          }
        }
        consumer_sync(256);
      }
      // kSplit: both warpgroups take rows [0, 64), warpgroup cw dq's
      // columns [128 cw, 128 cw + 128)
      const int rw = C::kSplit ? 0 : cw * 64;       // the warpgroup's rows
      const int tr = rw + warp * 16 + g;            // tile rows tr, tr + 8
      const int row = q0 + tr;
      const float sl2 = p.scale * kLog2e;
      const float lse2[2] = {lse_s[tr] * kLog2e, lse_s[tr + 8] * kLog2e};
      const float dlt[2] = {delta_s[tr], delta_s[tr + 8]};
      const uint32_t qa = base + kQ + rw * 128;
      const uint32_t doa = base + kDO + rw * 128;
      const int dcol = C::kSplit ? cw * 128 : 0;    // its dq columns

      float dq[C::kAcc];
  #pragma unroll
      for (int i = 0; i < C::kAcc; ++i) dq[i] = 0.f;
      mbar_wait(full_q, 0);

      for (int kb = 0; kb < upper; ++kb) {
        const int s = kb % NS;
        const uint32_t ph = (kb / NS) & 1;
        const uint32_t ka = base + kK + s * kTile;
        const uint32_t va = base + kV + s * kTile;
        const int k0 = kb * BN;

        float sc[32], dp[32];
        mbar_wait(full_k(s), ph);
        wg_fence();
        gemm_abt<BM, BN, D>(sc, qa, ka);
        wg_commit();
        mbar_wait(full_v(s), ph);
        gemm_abt<BM, BN, D>(dp, doa, va);
        wg_commit();

        // p = exp(s * scale - lse), 0 where invisible
        wg_wait<1>();
        reg_fence(sc);
        const bool full = all_visible(q0, k0, BN, vis);
  #pragma unroll
        for (int j = 0; j < 8; ++j)
  #pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int r = e >> 1;
            const float pe = exp2f(fmaf(sc[4 * j + e], sl2, -lse2[r]));
            sc[4 * j + e] =
                full || visible<kMode>(row + 8 * r, k0 + 8 * j + 2 * t + (e & 1),
                                       vis)
                    ? pe
                    : 0.f;
          }
        // ds = p (dp - delta) scale, rounded to bf16 for dq += ds K
        wg_wait<0>();
        reg_fence(dp);
  #pragma unroll
        for (int j = 0; j < 8; ++j)
  #pragma unroll
          for (int e = 0; e < 4; ++e)
            dp[4 * j + e] = sc[4 * j + e] * (dp[4 * j + e] - dlt[e >> 1]) * p.scale;
        wg_fence();
        gemm_rs<BN / 16, BN>(dq, dp, ka + dcol / 64 * BN * 128);
        wg_commit();
        wg_wait<0>();
        reg_fence(dq);
        if (lane == 0) mbar_arrive(empty(s));
      }

      __nv_bfloat16* dqg = static_cast<__nv_bfloat16*>(p.dq) + b * p.dq_s[0] +
                           h * p.dq_s[1] + dcol;
      const float one[2] = {1.f, 1.f};
      store_rows(dq, dqg, p.dq_s[2], row, p.sq, t, one);
    }
  }
}

// --------------------------------------------------------- backward dkv
// One CTA per (BN-key block, kv head, batch), 64-row Q and dO tiles in
// the ring.  At head_dim 64 and 128 each consumer warpgroup owns 64 of
// the 128 keys.  At head_dim 256 (kSplit) the two warpgroups share the
// CTA's 64 keys and each owns 128 columns of dk and dv: a warpgroup
// owning all 256 would need 2 x 128 accumulator registers.  Each then
// computes the tile's S^T and dP^T itself (the dV and dK products are
// split, not repeated), and kBiased keeps one stage (two would pass 227
// KB beside the bias blocks).
template <Mode kMode, int D>
struct DkvCfg {
  static constexpr bool kSplit = D == 256;
  static constexpr int BN = kSplit ? 64 : 128, BM = 64, NT = 384;
  static constexpr int NS = kSplit && kMode == flash::kBiased ? 1 : 2;
  static constexpr int kAcc = kSplit ? 64 : D / 2;  // dk, dv registers
  static constexpr uint32_t kKV = BN * D * 2;        // K or V [BN, D]
  static constexpr uint32_t kQT = BM * D * 2;        // Q or dO [BM, D]
  static constexpr uint32_t kK = 0, kV = kKV, kQ = 2 * kKV,
                            kDO = kQ + NS * kQT;
  static constexpr uint32_t kRows = kDO + NS * kQT;  // per stage: lse (log2
                                                     // units), delta [BM]
  static constexpr uint32_t kBar = kRows + NS * 2 * BM * 4;  // full_kv, full, empty
  static constexpr size_t kSmem = kBar + 8 * (1 + 2 * NS) + 1024;
  // the K8 modes add, per stage, the interval ends of the CTA's keys [4,
  // BN], the tile's meta (query block, or -1: no more tiles; q head of
  // the group; both warpgroups' tile classes) and, kBiased, the tile's
  // [BM, BN] bias block (by TMA in the bias dtype, or copied as f32)
  static constexpr uint32_t kEnds = kBar + 64;
  static constexpr uint32_t kMeta = kEnds + NS * 4 * BN * 4;
  static constexpr uint32_t kBias = (kMeta + NS * 16 + 1023) / 1024 * 1024;
  static constexpr uint32_t kBiasTile = BM * BN * 4;
  static constexpr size_t kSmemIntervals = kMeta + NS * 16 + 1024;
  static constexpr size_t kSmemBiased = kBias + NS * kBiasTile + 1024;
  static constexpr size_t kSmemMode = kMode == flash::kPlain ? kSmem
                                      : kMode == flash::kIntervals
                                          ? kSmemIntervals
                                          : kSmemBiased;
  static_assert(kSmemMode <= 232448, "a CTA has 227 KB of shared memory");
};

// Whether the dk/dv kernel stages the bias by TMA: a 16-byte aligned
// base, row, head and batch strides (a broadcast dim's is 0) and rows
// that do not overlap; else its producer warp copies it.
__host__ __device__ __forceinline__ bool bias_by_tma(const Params& p) {
  const long long es = p.bias_dt == 0 ? 4 : 2;
  return reinterpret_cast<uintptr_t>(p.bias) % 16 == 0 && p.b_s[2] >= p.sk &&
         p.b_s[2] * es % 16 == 0 && p.b_s[1] * es % 16 == 0 &&
         p.b_s[0] * es % 16 == 0;
}

// The producer warp's copy of the [BM, BN] bias block at (q0, k0) into
// a stage as f32 (its 32 lanes along the keys, plain loads), where TMA
// cannot take the bias; rows past Sq and keys past Sk read as 0.
template <int BM, int BN>
__device__ __forceinline__ void stage_bias_rows(float* dst, const Vis& v,
                                                int q0, int k0, int lane) {
#pragma unroll 1
  for (int r = 0; r < BM; ++r) {
    const int q = q0 + r;
#pragma unroll
    for (int u = 0; u < BN / 32; ++u) {
      const int k = k0 + lane + 32 * u;
      dst[r * BN + lane + 32 * u] =
          q < v.sq && k < v.sk
              ? flash::load_any(v.m.bias, (long long)q * v.m.b_ss + k,
                                v.m.bias_dt)
              : 0.f;
    }
  }
}

// sc = sc * sl2 + bias * log2 e over a thread's S^T elements (key rows kr
// and kr + 8 of the CTA's block, query columns 8 j + 2 t (+ 1) of the
// tile) from a staged [BM, BN] bias block of element type T.
template <typename T, int BN>
__device__ __forceinline__ void add_staged_bias(float (&sc)[32],
                                                const unsigned char* stage,
                                                int kr, int t, float sl2) {
  const T* bz = reinterpret_cast<const T*>(stage);
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int qc = 8 * j + 2 * t + (e & 1);
      sc[4 * j + e] = fmaf(sc[4 * j + e], sl2,
                           to_f32(bz[qc * BN + kr + 8 * (e >> 1)]) *
                               kLog2e);
    }
}

// The K8 modes of the dk/dv kernel (kIntervals; kBiased, intervals
// optional).  The producer warp classes each (64-row query tile, 64-key
// block of a consumer warpgroup) 32 query tiles at a time, a lane each,
// from the tile table (tile_class<64> with the tile's rows and the
// block's keys), for each q head of the GQA group with that head's
// intervals (the table has a row set per q head where the intervals
// have a head stride: p.H counts kv heads here, so the head count is
// p.H * p.group).  A query tile hidden from both blocks is skipped: its
// Q and dO are not loaded.  Otherwise the stage gets the tile's meta,
// its lse and delta rows, the interval ends of the CTA's keys where a
// block is partial, and, kBiased, the tile's bias block ([BM q, BN k]:
// a thread's pairs run along q, which is not contiguous, so the block
// goes through shared memory).  A warpgroup whose own block is hidden
// (by the intervals, or the causal diagonal) arrives and goes on.  The
// per-element test runs on partial blocks and on blocks that cross the
// causal diagonal or Sk.  kBiased's grid is (batch, key blocks, kv
// heads), so that a bias broadcast over the batch is read from L2 after
// the first.
template <Mode kMode, int D>
__device__ __forceinline__ void dkv_k8(const CUtensorMap& tq,
                                       const CUtensorMap& tdo,
                                       const CUtensorMap& tk,
                                       const CUtensorMap& tv,
                                       const CUtensorMap& tb,
                                       const Params& p) {
  using C = DkvCfg<kMode, D>;
  constexpr int BN = C::BN, BM = C::BM, NS = C::NS;
  constexpr uint32_t kKV = C::kKV, kQT = C::kQT, kK = C::kK, kV = C::kV,
                     kQ = C::kQ, kDO = C::kDO, kRows = C::kRows,
                     kBar = C::kBar, kEnds = C::kEnds, kMeta = C::kMeta,
                     kBias = C::kBias, kBiasTile = C::kBiasTile;
  extern __shared__ unsigned char smem_sm90[];
  uint32_t base;
  unsigned char* smem = align_smem(smem_sm90, &base);
  float* rows_s = reinterpret_cast<float*>(smem + kRows);
  int* ends_s = reinterpret_cast<int*>(smem + kEnds);
  int* meta_s = reinterpret_cast<int*>(smem + kMeta);
  const uint32_t full_kv = base + kBar;
  const auto full = [&](int s) { return base + kBar + 8 * (1 + s); };
  const auto empty = [&](int s) { return base + kBar + 8 * (1 + NS + s); };

  int kb, hk, b;
  if constexpr (kMode == flash::kBiased) {
    kb = blockIdx.y;
    hk = blockIdx.z;
    b = blockIdx.x;
  } else {
    kb = blockIdx.x;
    hk = blockIdx.y;
    b = blockIdx.z;
  }
  const int k0 = kb * BN;
  const int nh = p.H * p.group;         // q heads
  // the lengths and the causal diagonal (the same for every head)
  const Vis len = vis_for<kMode>(p, b, hk * p.group, nh);
  const int nq = (p.sq + BM - 1) / BM;
  int lower = 0;                        // causal lower bound (_k_trip_bounds)
  if (p.causal) {
    const int x = k0 - len.diag;
    lower = x <= 0 ? 0 : min(x / BM, nq);
  }
  const bool tma_bias = kMode == flash::kBiased && bias_by_tma(p);

  if (threadIdx.x == 0) {
    mbar_init(full_kv, 1);
    for (int s = 0; s < NS; ++s) {
      mbar_init(full(s), 32);           // the producer warp's lanes
      mbar_init(empty(s), 8);           // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // ---- producer: one warp classes the tiles and fills the stages
    reg_dealloc<40>();
    if (threadIdx.x < 32) {
      const int lane = threadIdx.x;
      if (lane == 0) {
        mbar_expect_tx(full_kv, 2 * kKV);
        tma_tile<D>(base + kK, &tk, full_kv, k0, hk, b, BN);
        tma_tile<D>(base + kV, &tv, full_kv, k0, hk, b, BN);
      }
      const uint32_t tile_bytes =
          2 * kQT + (tma_bias ? BM * BN * (p.bias_dt == 0 ? 4 : 2) : 0);
      const int kb0 = k0 / 64;          // the first warpgroup's table block
      int it = 0;                       // stages filled
      for (int j = 0; j < p.group; ++j) {
        const int h = hk * p.group + j;
        const Vis vis = vis_for<kMode>(p, b, h, nh);
        const long long row_base = ((long long)b * nh + h) * p.sq;
        for (int c = lower; c < nq; c += 32) {
          // both blocks' classes, two bits each
          int cls = kSkip;
          const int q0 = (c + lane) * BM, qe = min(q0 + BM, p.sq);
          if (c + lane < nq) {
            cls = tile_class<64>(kb0, q0, qe, vis);
            if (C::kSplit)          // one block, both warpgroups'
              cls |= cls << 2;
            else if (kb0 + 1 < len.nblk &&
                     !(p.causal && q0 + BM - 1 + len.diag < k0 + 64))
              cls |= tile_class<64>(kb0 + 1, q0, qe, vis) << 2;
          }
          unsigned live = __ballot_sync(0xffffffffu, cls != kSkip);
          for (; live; live &= live - 1, ++it) {
            const int bit = __ffs(live) - 1;
            const int qb = c + bit;
            const int tcls = __shfl_sync(0xffffffffu, cls, bit);
            const int s = it % NS;
            mbar_wait(empty(s), ((it / NS) & 1) ^ 1);
            if (lane == 0) {
              // the copies first; the lanes' arrivals complete full
              meta_s[4 * s] = qb;
              meta_s[4 * s + 1] = j;
              meta_s[4 * s + 2] = tcls;
              mbar_expect(full(s), tile_bytes);
              tma_tile<D>(base + kQ + s * kQT, &tq, full(s), qb * BM, h, b, BM);
              tma_tile<D>(base + kDO + s * kQT, &tdo, full(s), qb * BM, h, b, BM);
              if (tma_bias)
                tma_box(base + kBias + s * kBiasTile, &tb, full(s), k0,
                        qb * BM, p.b_s[1] ? h : 0, p.b_s[0] ? b : 0);
            }
            float* rs = rows_s + s * 2 * BM;
            for (int i = lane; i < BM; i += 32) {
              const int qi = qb * BM + i;
              rs[i] = (qi < p.sq ? p.lse[row_base + qi] : kLseInvalid) * kLog2e;
              rs[BM + i] = qi < p.sq ? p.delta[row_base + qi] : 0.f;
            }
            if ((tcls & 3) == kPartial || (tcls >> 2) == kPartial)
              stage_ends<BN>(ends_s + s * 4 * BN, vis, k0, lane);
            if (kMode == flash::kBiased && !tma_bias)
              stage_bias_rows<BM, BN>(reinterpret_cast<float*>(
                                          smem + kBias + s * kBiasTile),
                                      vis, qb * BM, k0, lane);
            mbar_arrive(full(s));
          }
        }
      }
      const int s = it % NS;
      mbar_wait(empty(s), ((it / NS) & 1) ^ 1);
      if (lane == 0) meta_s[4 * s] = -1;
      mbar_arrive(full(s));
    }
  } else {
    // ---- consumers: warpgroup cw owns keys [k0 + 64 cw, k0 + 64 cw + 64)
    // (kSplit: both own keys [k0, k0 + 64), warpgroup cw columns [128 cw,
    // 128 cw + 128) of dk and dv)
    reg_alloc<232>();
    const int ci = threadIdx.x - 128;
    const int cw = ci >> 7;
    const int warp = (ci >> 5) & 3;
    const int lane = ci & 31;
    const int g = lane >> 2;
    const int t = lane & 3;
    const int rw = C::kSplit ? 0 : cw * 64;      // the warpgroup's key rows
    const int kw = k0 + rw;                       // the warpgroup's first key
    const int kr = rw + warp * 16 + g;            // key rows kr, kr + 8
    const int key = k0 + kr;
    const int dcol = C::kSplit ? cw * 128 : 0;    // its dk, dv columns
    const float sl2 = p.scale * kLog2e;
    // the staged bias's element type: the bias's by TMA, else f32
    const int bdt = tma_bias ? p.bias_dt : 0;

    float dk[C::kAcc], dv[C::kAcc];
#pragma unroll
    for (int i = 0; i < C::kAcc; ++i) {
      dk[i] = 0.f;
      dv[i] = 0.f;
    }
    mbar_wait(full_kv, 0);

    for (int it = 0;; ++it) {
      const int s = it % NS;
      mbar_wait(full(s), (it / NS) & 1);
      const int qb = meta_s[4 * s];
      if (qb < 0) break;
      const int cls = (meta_s[4 * s + 2] >> (2 * cw)) & 3;
      if (cls == kSkip) {
        // no row of this tile sees the warpgroup's keys
        if (lane == 0) mbar_arrive(empty(s));
        continue;
      }
      const uint32_t qa = base + kQ + s * kQT;
      const uint32_t doa = base + kDO + s * kQT;
      const float* rs = rows_s + s * 2 * BM;
      const int q0 = qb * BM;

      float sc[BM / 2], dp[BM / 2];
      wg_fence();
      gemm_abt<BN, BM, D>(sc, base + kK + rw * 128, qa);
      wg_commit();
      gemm_abt<BN, BM, D>(dp, base + kV + rw * 128, doa);
      wg_commit();

      // p^T = exp2(logit - lse) per query column, 0 where invisible; dv
      // += p^T dO (p rounded to bf16) runs while ds^T is made
      wg_wait<1>();
      reg_fence(sc);
      float sl = sl2;
      if constexpr (kMode == flash::kBiased) {
        const unsigned char* bs = smem + kBias + s * kBiasTile;
        if (bdt == 0) {
          add_staged_bias<float, BN>(sc, bs, kr, t, sl2);
        } else if (bdt == 1) {
          add_staged_bias<__nv_bfloat16, BN>(sc, bs, kr, t, sl2);
        } else {
          add_staged_bias<__half, BN>(sc, bs, kr, t, sl2);
        }
        sl = 1.f;
      }
      uint32_t hide = 0;
      if (cls == kPartial) {
        // the thread's two keys' interval ends, from the stage
        const int* es = ends_s + s * 4 * BN;
        int e0[4] = {0, 0, 0, 0}, e1[4] = {0, 0, 0, 0};
#pragma unroll
        for (int i = 0; i < 4; ++i)
          if (i < len.m.nvec) {
            e0[i] = es[i * BN + kr];
            e1[i] = es[i * BN + kr + 8];
          }
#pragma unroll
        for (int e = 0; e < 32; ++e) {
          const int q = q0 + 8 * (e >> 2) + 2 * t + (e & 1);
          if (!visible<kMode>(q, key + 8 * ((e >> 1) & 1), len,
                              (e >> 1) & 1 ? e1 : e0))
            hide |= 1u << e;
        }
      } else if (!all_visible(q0, kw, 64, len)) {
#pragma unroll
        for (int e = 0; e < 32; ++e)
          if (!visible<kMode>(q0 + 8 * (e >> 2) + 2 * t + (e & 1),
                              key + 8 * ((e >> 1) & 1), len))
            hide |= 1u << e;
      }
#pragma unroll
      for (int jj = 0; jj < BM / 8; ++jj) {
        const float2 lse = *reinterpret_cast<const float2*>(rs + 8 * jj + 2 * t);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float v = exp2f(fmaf(sc[4 * jj + e], sl,
                                     -((e & 1) ? lse.y : lse.x)));
          sc[4 * jj + e] = (hide >> (4 * jj + e)) & 1 ? 0.f : v;
        }
      }
      wg_fence();
      gemm_rs<BM / 16, BM>(dv, sc, doa + dcol / 64 * BM * 128);
      wg_commit();

      // ds^T = p^T (dp^T - delta) scale (f32 p), rounded to bf16 for
      // dk += ds^T Q
      wg_wait<1>();
      reg_fence(dp);
#pragma unroll
      for (int jj = 0; jj < BM / 8; ++jj) {
        const float2 dlt =
            *reinterpret_cast<const float2*>(rs + BM + 8 * jj + 2 * t);
#pragma unroll
        for (int e = 0; e < 4; ++e)
          dp[4 * jj + e] = sc[4 * jj + e] *
                           (dp[4 * jj + e] - ((e & 1) ? dlt.y : dlt.x)) *
                           p.scale;
      }
      wg_fence();
      gemm_rs<BM / 16, BM>(dk, dp, qa + dcol / 64 * BM * 128);
      wg_commit();
      wg_wait<0>();
      reg_fence(dv);
      reg_fence(dk);
      if (lane == 0) mbar_arrive(empty(s));
    }

    const float one[2] = {1.f, 1.f};
    store_rows(dk, static_cast<__nv_bfloat16*>(p.dk) + b * p.dk_s[0] +
                       hk * p.dk_s[1] + dcol,
               p.dk_s[2], key, p.sk, t, one);
    store_rows(dv, static_cast<__nv_bfloat16*>(p.dv) + b * p.dv_s[0] +
                       hk * p.dv_s[1] + dcol,
               p.dv_s[2], key, p.sk, t, one);
  }
}

// kPlain (K2) walks every query tile from the causal lower bound, its
// body written out apart from dkv_k8's so that K2's SASS stays; the K8
// modes are dkv_k8, with the bias's tensor map ``tb`` (kBiased, where
// bias_by_tma; unused otherwise), after p so that K2's parameters keep
// their offsets.
template <Mode kMode, int D>
__global__ void __launch_bounds__(DkvCfg<kMode, D>::NT, 1)
    dkv_kernel(const __grid_constant__ CUtensorMap tq,
               const __grid_constant__ CUtensorMap tdo,
               const __grid_constant__ CUtensorMap tk,
               const __grid_constant__ CUtensorMap tv, const Params p,
               const __grid_constant__ CUtensorMap tb) {
  if constexpr (kMode != flash::kPlain) {
    dkv_k8<kMode, D>(tq, tdo, tk, tv, tb, p);
  } else {
    using C = DkvCfg<kMode, D>;
    constexpr int BN = C::BN, BM = C::BM, NS = C::NS;
    constexpr uint32_t kKV = C::kKV, kQT = C::kQT, kK = C::kK, kV = C::kV,
                       kQ = C::kQ, kDO = C::kDO, kRows = C::kRows,
                       kBar = C::kBar;
    extern __shared__ unsigned char smem_sm90[];
    uint32_t base;
    unsigned char* smem = align_smem(smem_sm90, &base);
    float* rows_s = reinterpret_cast<float*>(smem + kRows);
    const uint32_t full_kv = base + kBar;
    const auto full = [&](int s) { return base + kBar + 8 * (1 + s); };
    const auto empty = [&](int s) { return base + kBar + 8 * (1 + NS + s); };

    const int k0 = blockIdx.x * BN;
    const int hk = blockIdx.y;            // p.H is kvH here
    const int b = blockIdx.z;
    const Vis vis{p.sk, p.sk - p.sq, p.causal};
    const int nq = (p.sq + BM - 1) / BM;
    int lower = 0;                        // causal lower bound (_k_trip_bounds)
    if (p.causal) {
      const int x = k0 - vis.diag;
      lower = x <= 0 ? 0 : min(x / BM, nq);
    }

    if (threadIdx.x == 0) {
      mbar_init(full_kv, 1);
      for (int s = 0; s < NS; ++s) {
        mbar_init(full(s), 32);           // the producer warp's lanes
        mbar_init(empty(s), 8);           // one arrival per consumer warp
      }
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();

    if (threadIdx.x < 128) {
      // ---- producer: lane 0 issues the TMA loads, all 32 lanes stage the
      // tile's lse and delta rows
      reg_dealloc<24>();
      if (threadIdx.x < 32) {
        const int lane = threadIdx.x;
        if (lane == 0) {
          mbar_expect_tx(full_kv, 2 * kKV);
          tma_tile<D>(base + kK, &tk, full_kv, k0, hk, b, BN);
          tma_tile<D>(base + kV, &tv, full_kv, k0, hk, b, BN);
        }
        int it = 0;
        for (int j = 0; j < p.group; ++j) {
          const int h = hk * p.group + j;
          const long long row_base = ((long long)b * p.H * p.group + h) * p.sq;
          for (int qb = lower; qb < nq; ++qb, ++it) {
            const int s = it % NS;
            mbar_wait(empty(s), ((it / NS) & 1) ^ 1);
            float* rs = rows_s + s * 2 * BM;
            for (int i = lane; i < BM; i += 32) {
              const int qi = qb * BM + i;
              rs[i] = (qi < p.sq ? p.lse[row_base + qi] : kLseInvalid) * kLog2e;
              rs[BM + i] = qi < p.sq ? p.delta[row_base + qi] : 0.f;
            }
            if (lane == 0) {
              mbar_expect_tx(full(s), 2 * kQT);
              tma_tile<D>(base + kQ + s * kQT, &tq, full(s), qb * BM, h, b, BM);
              tma_tile<D>(base + kDO + s * kQT, &tdo, full(s), qb * BM, h, b, BM);
            } else {
              mbar_arrive(full(s));
            }
          }
        }
      }
    } else {
      // ---- consumers: warpgroup cw owns keys [k0 + 64 cw, k0 + 64 cw + 64)
      // (kSplit: both own keys [k0, k0 + 64), warpgroup cw columns [128
      // cw, 128 cw + 128) of dk and dv)
      reg_alloc<240>();
      const int ci = threadIdx.x - 128;
      const int cw = ci >> 7;
      const int warp = (ci >> 5) & 3;
      const int lane = ci & 31;
      const int g = lane >> 2;
      const int t = lane & 3;
      const int rw = C::kSplit ? 0 : cw * 64;      // the warpgroup's key rows
      const int kw = k0 + rw;                       // the warpgroup's first key
      const int key = kw + warp * 16 + g;           // and key + 8
      const int dcol = C::kSplit ? cw * 128 : 0;    // its dk, dv columns
      const float sl2 = p.scale * kLog2e;

      float dk[C::kAcc], dv[C::kAcc];
  #pragma unroll
      for (int i = 0; i < C::kAcc; ++i) {
        dk[i] = 0.f;
        dv[i] = 0.f;
      }
      mbar_wait(full_kv, 0);

      int it = 0;
      for (int j = 0; j < p.group; ++j) {
        for (int qb = lower; qb < nq; ++qb, ++it) {
          const int s = it % NS;
          const uint32_t qa = base + kQ + s * kQT;
          const uint32_t doa = base + kDO + s * kQT;
          const float* rs = rows_s + s * 2 * BM;
          const int q0 = qb * BM;
          mbar_wait(full(s), (it / NS) & 1);
          if (p.causal && q0 + BM - 1 + vis.diag < kw) {
            // no row of this tile sees the warpgroup's keys (the CTA's
            // lower bound is its first warpgroup's)
            if (lane == 0) mbar_arrive(empty(s));
            continue;
          }

          float sc[BM / 2], dp[BM / 2];
          wg_fence();
          gemm_abt<BN, BM, D>(sc, base + kK + rw * 128, qa);
          wg_commit();
          gemm_abt<BN, BM, D>(dp, base + kV + rw * 128, doa);
          wg_commit();

          // p^T = exp(s * scale - lse) per query column, 0 where invisible;
          // dv += p^T dO (p rounded to bf16) runs while ds^T is made
          wg_wait<1>();
          reg_fence(sc);
          const bool all = all_visible(q0, kw, 64, vis);
  #pragma unroll
          for (int jj = 0; jj < BM / 8; ++jj) {
            const int col = 8 * jj + 2 * t;
            const float2 lse = *reinterpret_cast<const float2*>(rs + col);
  #pragma unroll
            for (int e = 0; e < 4; ++e) {
              const float v = exp2f(fmaf(sc[4 * jj + e], sl2,
                                         -((e & 1) ? lse.y : lse.x)));
              sc[4 * jj + e] =
                  all || visible<kMode>(q0 + col + (e & 1), key + 8 * (e >> 1),
                                        vis)
                      ? v
                      : 0.f;
            }
          }
          wg_fence();
          gemm_rs<BM / 16, BM>(dv, sc, doa + dcol / 64 * BM * 128);
          wg_commit();

          // ds^T = p^T (dp^T - delta) scale (f32 p), rounded to bf16 for
          // dk += ds^T Q
          wg_wait<1>();
          reg_fence(dp);
  #pragma unroll
          for (int jj = 0; jj < BM / 8; ++jj) {
            const float2 dlt =
                *reinterpret_cast<const float2*>(rs + BM + 8 * jj + 2 * t);
  #pragma unroll
            for (int e = 0; e < 4; ++e)
              dp[4 * jj + e] = sc[4 * jj + e] *
                               (dp[4 * jj + e] - ((e & 1) ? dlt.y : dlt.x)) *
                               p.scale;
          }
          wg_fence();
          gemm_rs<BM / 16, BM>(dk, dp, qa + dcol / 64 * BM * 128);
          wg_commit();
          wg_wait<0>();
          reg_fence(dv);
          reg_fence(dk);
          if (lane == 0) mbar_arrive(empty(s));
        }
      }

      const float one[2] = {1.f, 1.f};
      store_rows(dk, static_cast<__nv_bfloat16*>(p.dk) + b * p.dk_s[0] +
                         hk * p.dk_s[1] + dcol,
                 p.dk_s[2], key, p.sk, t, one);
      store_rows(dv, static_cast<__nv_bfloat16*>(p.dv) + b * p.dv_s[0] +
                         hk * p.dv_s[1] + dcol,
                 p.dv_s[2], key, p.sk, t, one);
    }
  }
}

// ------------------------------------------------------------- dbias
// The bf16 K8 dbias: dbias = p (dP - delta) at visible pairs (no scale),
// zero at hidden ones, summed over the bias's broadcast batch and head
// dims in a fixed order, in the bias dtype.  One CTA per (128-row query
// block, bias head, bias batch) walks the (batch, head) members that
// broadcast onto it in order, on the dq kernel's layout (DqCfg): Q and
// dO of the member resident by TMA, 64-key K and V tiles in the ring,
// the producer warp classing the tiles from the tile table as dq_k8's
// does.  Per tile each consumer warpgroup takes S = Q.K^T and dP = dO.V^T
// by wgmma into registers; with dP in, K and V are released (there is no
// dS.K product and no dq accumulator).  The bias block is read into
// registers while the products run, as dq_k8 reads it.  A tile that the
// intervals hide from the member is neither loaded nor computed (its ds
// is 0).  The running sum of the earlier members lives in f32 in device
// memory (the output itself for an f32 bias, else dbias_acc), written
// and read back by the thread that owns each element, so no atomics and
// no cross-thread ordering are needed; with one member nothing is read
// back.  The last member's ds, rounded to the bias dtype, goes through a
// [64, 64] staging box per warpgroup and a TMA store (where the output's
// rows are 16-byte multiples; else plain stores).  Key tiles past the
// causal trip count are written as zeros once per CTA by a second
// producer warp (TMA stores of a zero box, or plain stores).
template <int D>
struct DbiasCfg {
  static constexpr int BM = 128, BN = 64, NT = 384;
  // head_dim 256: one stage, and plain stores for ds and the zeros (Q and
  // dO are 128 KB; two stages or the staging boxes would pass 227 KB)
  static constexpr int NS = D == 256 ? 1 : 2;
  static constexpr bool kTmaStore = D != 256;
  static constexpr uint32_t kRes = BM * D * 2;       // Q or dO [128, D]
  static constexpr uint32_t kTile = BN * D * 2;      // K or V [64, D]
  static constexpr uint32_t kQ = 0, kDO = kRes, kK = 2 * kRes,
                            kV = kK + NS * kTile;
  static constexpr uint32_t kRows = kV + NS * kTile; // lse, delta [128] f32
  static constexpr uint32_t kBar = kRows + 2 * BM * 4;
  static constexpr uint32_t kEmptyQ = kBar + 8 * (1 + 3 * NS);  // consumers free Q, dO
  static constexpr uint32_t kEnds = kBar + 64;
  static constexpr uint32_t kMeta = kEnds + NS * 4 * BN * 4;
  static constexpr uint32_t kBox = 64 * 64 * 4;      // [64 q, 64 k] f32
  static constexpr uint32_t kStore = (kMeta + NS * 4 + 1023) / 1024 * 1024;
  static constexpr uint32_t kZero = kStore + 2 * kBox;  // a box of zeros
  static constexpr size_t kSmem =
      (kTmaStore ? kZero + kBox : kMeta + NS * 4) + 1024;
  static_assert(kSmem <= 232448, "a CTA has 227 KB of shared memory");
};

__device__ __forceinline__ void tma_store(const CUtensorMap* map, uint32_t src,
                                          int k0, int row, int h, int b) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group [%0, {%2, %3, "
      "%4, %5}], [%1];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(k0), "r"(row), "r"(h), "r"(b)
      : "memory");
}
__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
// Wait until the committed stores have read their shared-memory source.
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}
// Make this thread's shared-memory writes visible to the TMA (async
// proxy), and its earlier global writes ordered before the TMA's.
__device__ __forceinline__ void fence_async() {
  asm volatile("fence.proxy.async;\n" ::: "memory");
}
__device__ __forceinline__ void warpgroup_sync(int cw) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(2 + cw) : "memory");
}

// The thread's 32 elements of a 64 x 64 tile (rows row and row + 8,
// columns k0 + 8 j + 2 t (+ 1)) in an f32 [Sq, Sk] plane at ``plane``,
// read or written as pairs where Sk is even; rows past Sq and columns
// past Sk are left alone (read as 0).
__device__ __forceinline__ void acc_rw(float (&x)[32], float* plane, int row,
                                       int k0, int t, int sq, int sk,
                                       bool write) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int q = row + 8 * r;
    if (q >= sq) continue;
    float* src = plane + (long long)q * sk;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int k = k0 + 8 * j + 2 * t;
      float& e0 = x[4 * j + 2 * r];
      float& e1 = x[4 * j + 2 * r + 1];
      if (sk % 2 == 0 && k + 1 < sk) {
        if (write) {
          __stcg(reinterpret_cast<float2*>(src + k), make_float2(e0, e1));
        } else {
          const float2 v = __ldcg(reinterpret_cast<const float2*>(src + k));
          e0 = v.x;
          e1 = v.y;
        }
      } else {
        if (write) {
          if (k < sk) __stcg(src + k, e0);
          if (k + 1 < sk) __stcg(src + k + 1, e1);
        } else {
          e0 = k < sk ? __ldcg(src + k) : 0.f;
          e1 = k + 1 < sk ? __ldcg(src + k + 1) : 0.f;
        }
      }
    }
  }
}

// The thread's 32 elements as the bias dtype ``dt``: into the staging box
// ([64 rows, 64 keys], ``tr`` the warpgroup-local row), or, without TMA,
// straight to the [Sq, Sk] output plane at ``plane``.
__device__ __forceinline__ void put_pair(void* base, long long i, float x,
                                         float y, int dt) {
  if (dt == 0) {
    *reinterpret_cast<float2*>(static_cast<float*>(base) + i) =
        make_float2(x, y);
  } else if (dt == 1) {
    *reinterpret_cast<__nv_bfloat162*>(static_cast<__nv_bfloat16*>(base) +
                                       i) = __floats2bfloat162_rn(x, y);
  } else {
    *reinterpret_cast<__half2*>(static_cast<__half*>(base) + i) =
        __floats2half2_rn(x, y);
  }
}

__device__ __forceinline__ void stage_box(const float (&x)[32], void* box,
                                          int tr, int t, int dt) {
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int r = 0; r < 2; ++r)
      put_pair(box, (tr + 8 * r) * 64 + 8 * j + 2 * t, x[4 * j + 2 * r],
               x[4 * j + 2 * r + 1], dt);
}

__device__ __forceinline__ void store_plane(const float (&x)[32], void* plane,
                                            int row, int k0, int t, int sq,
                                            int sk, int dt) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int q = row + 8 * r;
    if (q >= sq) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int k = k0 + 8 * j + 2 * t;
      const long long i = (long long)q * sk + k;
      if (sk % 2 == 0 && k + 1 < sk) {
        put_pair(plane, i, x[4 * j + 2 * r], x[4 * j + 2 * r + 1], dt);
      } else {
        if (k < sk) flash::store_any(plane, i, x[4 * j + 2 * r], dt);
        if (k + 1 < sk) flash::store_any(plane, i + 1, x[4 * j + 2 * r + 1], dt);
      }
    }
  }
}

// Grid (ceil(Sq / 128), Hb, Bb), 384 threads; Hb/Bb are the bias's head
// and batch dims (1 = broadcast over p.H / p.B).  tdb: the output's
// tensor map (dbias_map), used where ``tma``.  A template (kBiased
// only), so that only the source that launches it compiles it.
template <Mode kMode, int D>
__global__ void __launch_bounds__(DbiasCfg<D>::NT, 1)
    dbias_kernel(const __grid_constant__ CUtensorMap tq,
                 const __grid_constant__ CUtensorMap tdo,
                 const __grid_constant__ CUtensorMap tk,
                 const __grid_constant__ CUtensorMap tv, const Params p,
                 const __grid_constant__ CUtensorMap tdb, const int tma) {
  using C = DbiasCfg<D>;
  constexpr int BM = C::BM, BN = C::BN, NS = C::NS, NT = C::NT;
  constexpr uint32_t kRes = C::kRes, kTile = C::kTile, kQ = C::kQ,
                     kDO = C::kDO, kK = C::kK, kV = C::kV, kRows = C::kRows,
                     kBar = C::kBar, kEmptyQ = C::kEmptyQ, kEnds = C::kEnds,
                     kMeta = C::kMeta, kBox = C::kBox, kStore = C::kStore,
                     kZero = C::kZero;
  static_assert(kMode == flash::kBiased, "dbias needs a bias");
  extern __shared__ unsigned char smem_sm90[];
  uint32_t base;
  unsigned char* smem = align_smem(smem_sm90, &base);
  float* lse_s = reinterpret_cast<float*>(smem + kRows);
  float* delta_s = lse_s + BM;
  int* ends_s = reinterpret_cast<int*>(smem + kEnds);
  int* meta_s = reinterpret_cast<int*>(smem + kMeta);
  const uint32_t full_q = base + kBar;
  const uint32_t empty_q = base + kEmptyQ;
  const auto full_k = [&](int s) { return base + kBar + 8 * (1 + s); };
  const auto full_v = [&](int s) { return base + kBar + 8 * (1 + NS + s); };
  const auto empty = [&](int s) { return base + kBar + 8 * (1 + 2 * NS + s); };

  const int qb = p.causal ? gridDim.x - 1 - blockIdx.x : blockIdx.x;
  const int q0 = qb * BM;
  const int hb = blockIdx.y, bb = blockIdx.z;
  const int n_h = gridDim.y == 1 ? p.H : 1;
  const int h_first = gridDim.y == 1 ? 0 : hb;
  const int n_b = gridDim.z == 1 ? p.B : 1;
  const int b_first = gridDim.z == 1 ? 0 : bb;
  const int members = n_b * n_h;
  const Vis plain{p.sk, p.sk - p.sq, p.causal};
  const int upper = key_blocks(q0, BM, BN, plain);
  const long long out_base = ((long long)bb * gridDim.y + hb) * p.sq * p.sk;
  // the running sum: an f32 output is its own accumulator
  float* acc = (p.bias_dt == 0 ? static_cast<float*>(p.dbias) : p.dbias_acc) +
               out_base;
  void* plane = static_cast<char*>(p.dbias) +
                out_base * (p.bias_dt == 0 ? 4 : 2);

  if constexpr (C::kTmaStore) {
    for (int i = threadIdx.x; i < (int)(kBox / 16); i += NT)
      reinterpret_cast<uint4*>(smem + kZero)[i] = make_uint4(0u, 0u, 0u, 0u);
    fence_async();
  }
  if (threadIdx.x == 0) {
    mbar_init(full_q, 1);
    mbar_init(empty_q, 8);              // one arrival per consumer warp
    for (int s = 0; s < NS; ++s) {
      mbar_init(full_k(s), 32);         // the producer warp's lanes
      mbar_init(full_v(s), 1);
      mbar_init(empty(s), 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    reg_dealloc<40>();
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    if (warp == 0) {
      // ---- the walk: per member, Q and dO, then the live key tiles
      int it = 0;                       // stages filled
      const int qe = min(q0 + BM, p.sq);
      for (int mi = 0; mi < members; ++mi) {
        const int b = b_first + mi / n_h, h = h_first + mi % n_h;
        const int hk = h / p.group;
        const Vis vis = vis_for<kMode>(p, b, h);
        if (lane == 0) {
          mbar_wait(empty_q, (mi & 1) ^ 1);
          mbar_expect_tx(full_q, 2 * kRes);
          tma_tile<D>(base + kQ, &tq, full_q, q0, h, b, BM);
          tma_tile<D>(base + kDO, &tdo, full_q, q0, h, b, BM);
        }
        for (int c = 0; c < upper; c += 32) {
          const int cls = c + lane < upper
                              ? tile_class<BN>(c + lane, q0, qe, vis)
                              : kClean;
          const unsigned part = __ballot_sync(0xffffffffu, cls == kPartial);
          const unsigned skip = __ballot_sync(0xffffffffu, cls == kSkip);
          for (int u = 0; u < min(32, upper - c); ++u, ++it) {
            const int kb = c + u;
            const int ivl = (part >> u) & 1, skp = (skip >> u) & 1;
            const int s = it % NS;
            mbar_wait(empty(s), ((it / NS) & 1) ^ 1);
            if (lane == 0) {
              // the copies first; the lanes' arrivals complete full_k
              meta_s[s] = 4 * kb + 2 * ivl + skp;
              if (skp) {
                mbar_arrive(full_v(s));
              } else {
                mbar_expect(full_k(s), kTile);
                tma_tile<D>(base + kK + s * kTile, &tk, full_k(s), kb * BN, hk, b,
                         BN);
                mbar_expect_tx(full_v(s), kTile);
                tma_tile<D>(base + kV + s * kTile, &tv, full_v(s), kb * BN, hk, b,
                         BN);
              }
            }
            if (ivl) stage_ends<BN>(ends_s + s * 4 * BN, vis, kb * BN, lane);
            mbar_arrive(full_k(s));
          }
        }
        const int s = it % NS;          // the member's end: a -1 stage
        mbar_wait(empty(s), ((it / NS) & 1) ^ 1);
        if (lane == 0) {
          meta_s[s] = -1;
          mbar_arrive(full_v(s));
        }
        mbar_arrive(full_k(s));
        ++it;
      }
    } else {
      // ---- zeros past the causal trip count, once per CTA
      const int nblk = (p.sk + BN - 1) / BN;
      if (tma) {
        if (threadIdx.x == 32) {
          for (int kb = upper; kb < nblk; ++kb)
            for (int r = q0; r < min(q0 + BM, p.sq); r += 64)
              tma_store(&tdb, base + kZero, kb * BN, r, hb, bb);
          bulk_commit();
          bulk_wait_read();
        }
      } else {
        const int k_lo = upper * BN, width = p.sk - min(k_lo, p.sk);
        const int rows = max(0, min(BM, p.sq - q0));
        for (long long e = threadIdx.x - 32; e < (long long)rows * width;
             e += 96)
          flash::store_any(plane, (long long)(q0 + e / width) * p.sk + k_lo +
                                      e % width,
                           0.f, p.bias_dt);
      }
    }
  } else {
    // ---- consumers: warpgroup cw owns tile rows [64 cw, 64 cw + 64)
    reg_alloc<232>();
    const int ci = threadIdx.x - 128;
    const int cw = ci >> 7;
    const int warp = (ci >> 5) & 3;
    const int lane = ci & 31;
    const int g = lane >> 2;
    const int t = lane & 3;
    const int tr = cw * 64 + warp * 16 + g;       // tile rows tr, tr + 8
    const int row = q0 + tr;
    const float sl2 = p.scale * kLog2e;
    const uint32_t qa = base + kQ + cw * 64 * 128;
    const uint32_t doa = base + kDO + cw * 64 * 128;
    const bool elect = (ci & 127) == 0;
    unsigned char* box = smem + kStore + cw * kBox;
    int it = 0;
    for (int mi = 0; mi < members; ++mi) {
      const int b = b_first + mi / n_h, h = h_first + mi % n_h;
      const bool last = mi == members - 1;
      const Vis vis = vis_for<kMode>(p, b, h);
      const bool bias_pair =
          vis.m.b_ss % 2 == 0 &&
          reinterpret_cast<uintptr_t>(vis.m.bias) % (vis.m.bias_dt ? 4 : 8) == 0;
      const long long row_base = ((long long)b * p.H + h) * p.sq;
      consumer_sync(256);               // the last member's rows are read
      if (ci < BM) {
        const int qi = q0 + ci;
        lse_s[ci] = qi < p.sq ? p.lse[row_base + qi] : kLseInvalid;
        delta_s[ci] = qi < p.sq ? p.delta[row_base + qi] : 0.f;
      }
      consumer_sync(256);
      const float lse2[2] = {lse_s[tr] * kLog2e, lse_s[tr + 8] * kLog2e};
      const float dlt[2] = {delta_s[tr], delta_s[tr + 8]};
      mbar_wait(full_q, mi & 1);

      for (;; ++it) {
        const int s = it % NS;
        const uint32_t ph = (it / NS) & 1;
        mbar_wait(full_k(s), ph);
        const int meta = meta_s[s];
        if (meta < 0) {
          if (lane == 0) mbar_arrive(empty(s));
          ++it;
          break;
        }
        const int k0 = (meta >> 2) * BN;
        const int* ends = (meta & 2) ? ends_s + s * 4 * BN : nullptr;
        float ds[32], prev[32];
        if (mi > 0) acc_rw(prev, acc, row, k0, t, p.sq, p.sk, false);
        if (meta & 1) {                 // hidden from this member: ds = 0
          if (lane == 0) mbar_arrive(empty(s));
#pragma unroll
          for (int e = 0; e < 32; ++e) ds[e] = 0.f;
        } else {
          const uint32_t ka = base + kK + s * kTile;
          const uint32_t va = base + kV + s * kTile;
          float sc[32], off[32];
          wg_fence();
          gemm_abt<BM, BN, D>(sc, qa, ka);
          wg_commit();
          // the logit in log2 units less lse, as the forward took it
          load_bias(off, vis, row, k0, t, bias_pair && k0 + BN <= vis.sk);
#pragma unroll
          for (int i = 0; i < 32; ++i)
            off[i] = fmaf(off[i], kLog2e, -lse2[(i >> 1) & 1]);
          mbar_wait(full_v(s), ph);
          gemm_abt<BM, BN, D>(ds, doa, va);
          wg_commit();
          wg_wait<1>();
          reg_fence(sc);
          uint64_t hide = 0;
          if (ends || !all_visible(q0, k0, BN, vis))
            hide = hidden_keys<kMode, 8>(row, t, k0, vis, ends);
#pragma unroll
          for (int e = 0; e < 32; ++e) {
            const float pe = exp2f(fmaf(sc[e], sl2, off[e]));
            sc[e] = (hide >> e) & 1 ? 0.f : pe;
          }
          wg_wait<0>();
          reg_fence(ds);
          if (lane == 0) mbar_arrive(empty(s));   // K and V are done
          // ds = p (dp - delta), without the scale
#pragma unroll
          for (int e = 0; e < 32; ++e)
            ds[e] = sc[e] * (ds[e] - dlt[(e >> 1) & 1]);
        }
        if (mi > 0)
#pragma unroll
          for (int e = 0; e < 32; ++e) ds[e] += prev[e];
        if (!last) {
          acc_rw(ds, acc, row, k0, t, p.sq, p.sk, true);
        } else if (tma) {
          if (elect) bulk_wait_read();  // the last box has left the stage
          warpgroup_sync(cw);
          stage_box(ds, box, tr - cw * 64, t, p.bias_dt);
          fence_async();
          warpgroup_sync(cw);
          if (elect && q0 + cw * 64 < p.sq) {
            tma_store(&tdb, base + kStore + cw * kBox, k0, q0 + cw * 64, hb,
                      bb);
            bulk_commit();
          }
        } else {
          store_plane(ds, plane, row, k0, t, p.sq, p.sk, p.bias_dt);
        }
      }
      if (lane == 0) mbar_arrive(empty_q);  // done with this Q and dO
    }
    if (elect && tma) bulk_wait_read();
  }
}

// ------------------------------------------------------------ host side
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

inline EncodeTiled encoder() {
  static EncodeTiled fn = [] {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr,
                                cudaEnableDefault, &found) != cudaSuccess ||
        found != cudaDriverEntryPointSuccess)
      return static_cast<EncodeTiled>(nullptr);
    return reinterpret_cast<EncodeTiled>(ptr);
  }();
  return fn;
}

// The tensor map of a [B, H, S, D] bf16 view with element strides
// st = (batch, head, sequence): dims (D, S, H, B), boxes of 64 columns x
// ``rows`` rows, 128-byte swizzle, zero fill past S.
inline bool tile_map(CUtensorMap* map, const void* ptr, const long long* st,
                     int B, int H, int S, int rows, int D) {
  const EncodeTiled enc = encoder();
  if (!enc) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)S, (cuuint64_t)H,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)st[2] * 2, (cuuint64_t)st[1] * 2,
                                 (cuuint64_t)st[0] * 2};
  const cuuint32_t box[4] = {64, (cuuint32_t)rows, 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr),
             dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <typename Kern, typename... Maps>
int launch(Kern kern, size_t smem, dim3 grid, int threads, cudaStream_t s,
           const Params& p, const Maps&... maps) {
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kern<<<grid, threads, smem, s>>>(maps..., p);
  return (int)cudaGetLastError();
}

// p as the C entries fill it (for dk/dv, p.H is kvH).  The forward's
// K8 modes read p.mask, p.bias and, with intervals, the tile table p.tbl
// (flash_mask.cu writes it first).  D is the head dim (64, 128 or 256).
template <Mode kMode, int D>
inline int launch_fwd(const Params& p, cudaStream_t s) {
  using C = FwdCfg<kMode, D>;
  const int kvh = p.H / p.group;
  CUtensorMap tq, tk, tv;
  if (!tile_map(&tq, p.q, p.q_s, p.B, p.H, p.sq, C::BM, D) ||
      !tile_map(&tk, p.k, p.k_s, p.B, kvh, p.sk, C::BN, D) ||
      !tile_map(&tv, p.v, p.v_s, p.B, kvh, p.sk, C::BN, D))
    return (int)cudaErrorInvalidValue;
  const int nqb = (p.sq + C::BM - 1) / C::BM;
  return launch(fwd_kernel<kMode, D>, C::kSmem,
                C::kBatchFirst ? dim3(p.B, nqb, p.H) : dim3(nqb, p.H, p.B),
                C::NT, s, p, tq, tk, tv);
}

template <Mode kMode, int D>
inline int launch_dq(const Params& p, cudaStream_t s) {
  using C = DqCfg<D>;
  const int kvh = p.H / p.group;
  CUtensorMap tq, tdo, tk, tv;
  if (!tile_map(&tq, p.q, p.q_s, p.B, p.H, p.sq, C::BM, D) ||
      !tile_map(&tdo, p.dout, p.do_s, p.B, p.H, p.sq, C::BM, D) ||
      !tile_map(&tk, p.k, p.k_s, p.B, kvh, p.sk, C::BN, D) ||
      !tile_map(&tv, p.v, p.v_s, p.B, kvh, p.sk, C::BN, D))
    return (int)cudaErrorInvalidValue;
  const int nqb = (p.sq + C::BM - 1) / C::BM;
  if constexpr (kMode == flash::kPlain) {
    return launch(dq_kernel<kMode, D>, C::kSmem, dim3(nqb, p.H, p.B), C::NT,
                  s, p, tq, tdo, tk, tv);
  } else {
    return launch(dq_kernel<kMode, D>, C::kSmemK8,
                  kMode == flash::kBiased ? dim3(p.B, nqb, p.H)
                                          : dim3(nqb, p.H, p.B),
                  C::NT, s, p, tq, tdo, tk, tv);
  }
}

// The tensor map of the bias [Bb, Hb, Sq, Sk] (element strides p.b_s, 0
// on a broadcast dim, which the map gives size 1) for the dk/dv kernel:
// dims (Sk, Sq, Hb, Bb), boxes of BN keys x BM rows in the bias dtype,
// no swizzle, zero fill past Sq and Sk.  Needs bias_by_tma(p).
inline bool bias_map(CUtensorMap* map, const Params& p, int nh, int BN,
                     int BM) {
  const EncodeTiled enc = encoder();
  if (!enc) return false;
  const cuuint64_t es = p.bias_dt == 0 ? 4 : 2;
  const cuuint64_t hb = p.b_s[1] ? nh : 1, bb = p.b_s[0] ? p.B : 1;
  const cuuint64_t dims[4] = {(cuuint64_t)p.sk, (cuuint64_t)p.sq, hb, bb};
  const cuuint64_t rs = p.b_s[2] * es;
  const cuuint64_t hs = p.b_s[1] ? p.b_s[1] * es : rs * p.sq;
  const cuuint64_t strides[3] = {rs, hs, p.b_s[0] ? p.b_s[0] * es : hs * hb};
  const cuuint32_t box[4] = {(cuuint32_t)BN, (cuuint32_t)BM, 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUtensorMapDataType dt = p.bias_dt == 0 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                                 : p.bias_dt == 1
                                     ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                                     : CU_TENSOR_MAP_DATA_TYPE_FLOAT16;
  return enc(map, dt, 4, const_cast<void*>(p.bias), dims, strides, box, unit,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// For dk/dv, p.H counts kv heads.  The K8 modes read p.mask, p.bias and,
// with intervals, the tile table p.tbl of the q heads (p.H * p.group).
template <Mode kMode, int D>
inline int launch_dkv(const Params& p, cudaStream_t s) {
  using C = DkvCfg<kMode, D>;
  const int h = p.H * p.group;
  CUtensorMap tq, tdo, tk, tv, tb = {};
  if (!tile_map(&tq, p.q, p.q_s, p.B, h, p.sq, C::BM, D) ||
      !tile_map(&tdo, p.dout, p.do_s, p.B, h, p.sq, C::BM, D) ||
      !tile_map(&tk, p.k, p.k_s, p.B, p.H, p.sk, C::BN, D) ||
      !tile_map(&tv, p.v, p.v_s, p.B, p.H, p.sk, C::BN, D) ||
      (kMode == flash::kBiased && bias_by_tma(p) &&
       !bias_map(&tb, p, h, C::BN, C::BM)))
    return (int)cudaErrorInvalidValue;
  const int nkb = (p.sk + C::BN - 1) / C::BN;
  const dim3 grid = kMode == flash::kBiased ? dim3(p.B, nkb, p.H)
                                            : dim3(nkb, p.H, p.B);
  cudaError_t err = cudaFuncSetAttribute(
      dkv_kernel<kMode, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)C::kSmemMode);
  if (err != cudaSuccess) return (int)err;
  dkv_kernel<kMode, D><<<grid, C::NT, C::kSmemMode, s>>>(tq, tdo, tk, tv, p,
                                                         tb);
  return (int)cudaGetLastError();
}

// The tensor map of the dbias output, a contiguous [Bb, Hb, Sq, Sk] of
// the bias dtype: dims (Sk, Sq, Hb, Bb), boxes of 64 keys x 64 rows, no
// swizzle; stores past Sq and Sk are dropped.  Needs rows of a 16-byte
// multiple.
inline bool dbias_map(CUtensorMap* map, const Params& p, int hb, int bb) {
  const EncodeTiled enc = encoder();
  if (!enc) return false;
  const cuuint64_t es = p.bias_dt == 0 ? 4 : 2;
  const cuuint64_t dims[4] = {(cuuint64_t)p.sk, (cuuint64_t)p.sq,
                              (cuuint64_t)hb, (cuuint64_t)bb};
  const cuuint64_t rs = p.sk * es;
  const cuuint64_t strides[3] = {rs, rs * p.sq, rs * p.sq * hb};
  const cuuint32_t box[4] = {64, 64, 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUtensorMapDataType dt = p.bias_dt == 0 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                                 : p.bias_dt == 1
                                     ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                                     : CU_TENSOR_MAP_DATA_TYPE_FLOAT16;
  return enc(map, dt, 4, p.dbias, dims, strides, box, unit,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
             CU_TENSOR_MAP_L2_PROMOTION_NONE,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The bf16 dbias (p.H q heads; Hb, Bb the bias's head and batch dims).
// With intervals it reads the tile table p.tbl (flash_mask.cu writes it
// first).  A template, as the kernel is, so that a source that does not
// call it does not compile the kernel.
template <Mode kMode, int D>
inline int launch_dbias(const Params& p, int hb, int bb, cudaStream_t s) {
  using C = DbiasCfg<D>;
  const int kvh = p.H / p.group;
  CUtensorMap tq, tdo, tk, tv, tdb = {};
  if (!tile_map(&tq, p.q, p.q_s, p.B, p.H, p.sq, C::BM, D) ||
      !tile_map(&tdo, p.dout, p.do_s, p.B, p.H, p.sq, C::BM, D) ||
      !tile_map(&tk, p.k, p.k_s, p.B, kvh, p.sk, C::BN, D) ||
      !tile_map(&tv, p.v, p.v_s, p.B, kvh, p.sk, C::BN, D))
    return (int)cudaErrorInvalidValue;
  const long long es = p.bias_dt == 0 ? 4 : 2;
  const int tma = C::kTmaStore && p.sk * es % 16 == 0 &&
                  reinterpret_cast<uintptr_t>(p.dbias) % 16 == 0 &&
                  dbias_map(&tdb, p, hb, bb);
  const int nqb = (p.sq + C::BM - 1) / C::BM;
  const auto kern = dbias_kernel<kMode, D>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)C::kSmem);
  if (err != cudaSuccess) return (int)err;
  kern<<<dim3(nqb, hb, bb), C::NT, C::kSmem, s>>>(tq, tdo, tk, tv, p, tdb,
                                                  tma);
  return (int)cudaGetLastError();
}

}  // namespace flash_sm90
