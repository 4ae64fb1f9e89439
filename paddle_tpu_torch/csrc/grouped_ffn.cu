// Grouped expert FFN (dropless MoE) for Hopper (sm_90a).
//
// Replaces: paddle_tpu/ops/pallas/grouped_ffn.py:_call_fwd (body
// _fwd_kernel) and :_call_bwd (body _bwd_kernel), the K9 TPU kernels.
// A token buffer x [R, D] is sorted by expert with each expert's run
// padded to 128-row tiles (R % 128 == 0); tile t belongs to expert
// emap[t] (int32, non-decreasing).  Per tile:
//     s   = x_t @ w1[e] + b1[e]                      (f32)
//     h   = silu(s), or gated: silu(s[:, :F]) * s[:, F:]
//     out = T(h) @ w2[e] + b2[e]                     (f32, cast to T)
// and the backward (the reference's numerics, _bwd_kernel :53-94):
//     dh  = dy @ w2[e]^T (f32); ds = dh * silu'(s) (gated: both halves)
//     dx  = T(ds) @ w1[e]^T;  dw1[e] = sum_t x_t^T T(ds_t)
//     dw2[e] = sum_t T(h_t)^T dy_t;  db1[e] = sum ds (f32, unrounded);
//     db2[e] = sum dy (f32)
// with x, w1, w2, dy in T (float32 or bfloat16), biases float32 or T,
// and every gradient written in its primal's dtype.  Experts that own no
// tile get zero gradients (their reduction loops over no tile), and the
// trailing padding tiles clipped to expert E-1 are computed like any
// other, as the reference computes them.
//
// What bounds it on the H100: operations.  The forward is 2 products of
// 2*R*D*F(2) flops; the backward 5 (4*R*D*F2 + 6*R*F*D' in all).  At the
// bench's MoE layer (R 17,408, D 1024, F 1408) that is 1.0e11 flops
// forward (0.10 ms at 989 TFLOP/s bf16) against 0.2 GB of bytes, so the
// bf16 products must run on wgmma, the only way to the tensor cores'
// full rate.
//
// The bf16 design (namespace sm90 below): every product is one
// warp-specialised, persistent wgmma GEMM over 128-row output tiles, so
// that a tile of the token buffer has one expert:
//   * warpgroup 0 is the producer: one thread keeps a 4-stage ring of
//     64-wide K steps full by TMA (128-byte swizzle, zero fill past each
//     edge), reading emap to index the [E, ., .] tensor map of the
//     weights by expert; the two consumer warpgroups own 64 rows each,
//     with their f32 accumulators in registers (setmaxnreg 40 / 232);
//   * one CTA per SM walks work items (row tile, N block) with a stride
//     of the grid, the ring running on through them, so the next item's
//     loads overlap this item's epilogue;
//   * operand layouts: x . w1, h . w2, dy . w2^T and ds . w1^T take A
//     K-major (token rows); B is w1[e] or w2[e] as stored, MN-major for
//     x . w1 and h . w2, K-major for the transposed products; the weight
//     gradients read both x^T (h^T) and ds (dy) MN-major, their K being
//     the token rows (the transpose bits of wgmma);
//   * N blocks of 256 columns (m64n256k16), 48 KB a stage: 128 for the
//     gated forward pass 1, which holds both halves in two accumulators,
//     and for backward pass 1, which recomputes s, as the reference's
//     _bwd_kernel does, beside dh = dy . w2^T (64 for the gated one,
//     three accumulators);
//   * epilogues: + b1 and the activation (h in T), + b2, or plain; the
//     output goes through a per-warp staging area in shared memory and
//     leaves as 16-byte row stores (the accumulator layout's 4-byte
//     stores, half a sector each, took up to 40 % of a pass); backward
//     pass 1 writes ds and h in T the same way and the f32 per-tile db1
//     partials;
//   * dw1 and dw2: one item per (expert, 128 x 256 output tile) loops
//     over the expert's tiles in order (lists that a small kernel builds
//     from emap, so no CTA scans it), accumulates in f32 and writes once:
//     no atomics, a fixed order, so reruns are bit-equal; an expert that
//     owns no tile writes zeros.  db1 and db2 are column sums over the
//     expert's tiles in order of per-tile partials (CUDA cores);
//   * every tile is computed, the trailing padding tiles too, as the
//     reference computes them.
// The TPU kernel keeps the [tile, F] intermediate on chip; here the
// forward is two passes through an [R, F] scratch h in T, which is
// bit-faithful because the reference rounds h to T right there.
//
// The float32 instances keep CUDA-core FMA bodies (no TF32), so card and
// CPU agree to f32 rounding: block GEMMs of 128 x BN output tiles, K in
// steps of 16 staged by 16-byte cp.async copies, two stages deep; 8
// warps, each a 32 x BN/2 strip.  The TPU grid runs in order, so
// _bwd_kernel accumulates dw1, dw2, db1 and db2 across an expert's
// consecutive tiles; CUDA blocks run in no order, so both paths rebuild
// that reduction without float atomics, in a fixed order, one CTA per
// (expert, output block).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "flash_sm90.cuh"   // mbarriers, TMA maps and boxes, wgmma
                            // descriptors, setmaxnreg

namespace {

constexpr int TILE = 128;  // rows of an emap tile: the buffer's contract
constexpr int BM = 128;    // rows of a CTA's output tile (one emap tile)
constexpr int NT = 256;    // 8 warps: 4 along M (32 rows) x 2 along N

template <typename T>
constexpr bool kIsBf16 = std::is_same<T, __nv_bfloat16>::value;
template <typename T>
constexpr int kBK = kIsBf16<T> ? 32 : 16;  // K per shared-memory stage
template <typename T>
constexpr int kPad = 16 / (int)sizeof(T);  // 16 bytes per tile row

__host__ __device__ constexpr size_t align128(size_t n) {
  return (n + 127) / 128 * 128;
}
__host__ __device__ constexpr size_t cmax(size_t a, size_t b) {
  return a > b ? a : b;
}

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }

// Element i of a float32 (dt 0) or bfloat16 (dt 1) tensor, and the store.
__device__ __forceinline__ float load_any(const void* p, long long i,
                                          int dt) {
  if (dt == 0) return static_cast<const float*>(p)[i];
  return __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i]);
}
__device__ __forceinline__ void store_any(void* p, long long i, float v,
                                          int dt) {
  if (dt == 0)
    static_cast<float*>(p)[i] = v;
  else
    static_cast<__nv_bfloat16*>(p)[i] = __float2bfloat16(v);
}

__device__ __forceinline__ float sigmoid(float s) {
  return 1.f / (1.f + expf(-s));
}

// ------------------------------------------------------------- tiles
// A is [BM, BK] (AT: read from a [K, M] row-major source and stored
// [BK, BM]); B is [BK, BN] (BT: from an [N, K] source, stored [BN, BK]).
template <typename T, bool AT>
struct ATile {
  static constexpr int LD = AT ? BM + kPad<T> : kBK<T> + kPad<T>;
  static constexpr int ROWS = AT ? kBK<T> : BM;
  static constexpr size_t bytes = align128((size_t)ROWS * LD * sizeof(T));
};
template <typename T, bool BT, int BN>
struct BTile {
  static constexpr int LD = BT ? kBK<T> + kPad<T> : BN + kPad<T>;
  static constexpr int ROWS = BT ? BN : kBK<T>;
  static constexpr size_t bytes = align128((size_t)ROWS * LD * sizeof(T));
};

// 16 bytes global -> shared without a register round trip; src_bytes 0
// writes zeros (and reads nothing).
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Start copying dst[r * ldd + c] = src[(r0 + r) * lds + c0 + c] for
// r < ROWS, c < COLS; zeros where r0 + r >= rlim, c0 + c >= clim (clim
// is a multiple of the 16-byte vector, so a vector is all in or all out)
// or, with remap, where row r0 + r lies in a tile remap[row / TILE] that
// is not expert re (the dw passes, whose K rows are token rows).
template <typename T, int ROWS, int COLS>
__device__ __forceinline__ void load_tile(T* dst, int ldd, const T* src,
                                          long long lds, int r0, int rlim,
                                          int c0, int clim,
                                          const int* remap, int re) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kPerRow = COLS / kVec;
  for (int i = threadIdx.x; i < ROWS * kPerRow; i += NT) {
    const int r = i / kPerRow;
    const int c = (i % kPerRow) * kVec;
    const bool ok = r0 + r < rlim && c0 + c < clim &&
                    (remap == nullptr || remap[(r0 + r) / TILE] == re);
    cp_async16(dst + r * ldd + c,
               ok ? src + (long long)(r0 + r) * lds + c0 + c : src, ok);
  }
}

// ------------------------------------------------------- accumulators
// A warp owns a 32 x BN/2 strip of the output tile as 2 x BN/32 pieces
// of 16 x 16.  Lane l holds (or reads back) row l / 2 and columns
// (l % 2) * 8 .. + 8 of each piece.
template <typename T, int BN>
struct Acc {  // CUDA-core FMA (the float32 instances)
  static constexpr int PJ = BN / 32;
  float c[2][PJ][8];

  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < PJ; ++j)
#pragma unroll
        for (int q = 0; q < 8; ++q) c[i][j][q] = 0.f;
  }

  template <bool AT, bool BT>
  __device__ __forceinline__ void mma(const T* a_s, const T* b_s) {
    constexpr int LA = ATile<T, AT>::LD;
    constexpr int LB = BTile<T, BT, BN>::LD;
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int wm = warp & 3, wn = warp >> 2;
    const int pr = lane >> 1, pc = (lane & 1) * 8;
#pragma unroll 4
    for (int k = 0; k < kBK<T>; ++k) {
      float a[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int m = wm * 32 + i * 16 + pr;
        a[i] = to_f(AT ? a_s[k * LA + m] : a_s[m * LA + k]);
      }
#pragma unroll
      for (int j = 0; j < PJ; ++j)
#pragma unroll
        for (int q = 0; q < 8; ++q) {
          const int n = wn * (BN / 2) + j * 16 + pc + q;
          const float b = to_f(BT ? b_s[n * LB + k] : b_s[k * LB + n]);
#pragma unroll
          for (int i = 0; i < 2; ++i) c[i][j][q] = fmaf(a[i], b, c[i][j][q]);
        }
    }
  }

  // The lane's 8 values of piece (i, j).
  __device__ __forceinline__ void piece(int i, int j, float* v) {
#pragma unroll
    for (int q = 0; q < 8; ++q) v[q] = c[i][j][q];
  }
};

template <typename T, int NB>
struct Ptrs {
  const T* p[NB];
};

// Shared bytes of one pipeline stage: the A tile and NB B tiles.
template <typename T, bool AT, bool BT, int BN, int NB>
__host__ __device__ constexpr size_t stage_bytes() {
  return ATile<T, AT>::bytes + NB * BTile<T, BT, BN>::bytes;
}

template <typename T, bool AT, bool BT, int BN, int NB>
__device__ __forceinline__ void load_stage(unsigned char* stage, const T* a,
                                           long long lda, int m0, int mlim,
                                           Ptrs<T, NB> b, long long ldb,
                                           int n0, int nlim, int k0,
                                           int kend, const int* remap,
                                           int re) {
  using TA = ATile<T, AT>;
  using TB = BTile<T, BT, BN>;
  constexpr int BK = kBK<T>;
  T* a_s = reinterpret_cast<T*>(stage);
  if constexpr (AT)
    load_tile<T, BK, BM>(a_s, TA::LD, a, lda, k0, kend, m0, mlim, remap, re);
  else
    load_tile<T, BM, BK>(a_s, TA::LD, a, lda, m0, mlim, k0, kend, nullptr,
                         0);
#pragma unroll
  for (int n = 0; n < NB; ++n) {
    T* b_s = reinterpret_cast<T*>(stage + TA::bytes + n * TB::bytes);
    if constexpr (BT)
      load_tile<T, BN, BK>(b_s, TB::LD, b.p[n], ldb, n0, nlim, k0, kend,
                           nullptr, 0);
    else
      load_tile<T, BK, BN>(b_s, TB::LD, b.p[n], ldb, k0, kend, n0, nlim,
                           remap, re);
  }
  cp_async_commit();
}

// acc[n] += A[m0 : m0 + BM, kbeg : kend] @ B_n[kbeg : kend, n0 : n0 + BN]
// for each of NB B operands (sharing the A tile).  Rows of A past mlim,
// columns of B past nlim, K past kend and (with remap) K rows outside
// expert re's tiles read as zeros.  lda / ldb are the sources' row
// strides.  smem holds two stages: step i + 1's tiles load while step
// i's multiply runs.
template <typename T, bool AT, bool BT, int BN, int NB>
__device__ __forceinline__ void gemm(Acc<T, BN>* acc, unsigned char* smem,
                                     const T* a, long long lda, int m0,
                                     int mlim, Ptrs<T, NB> b, long long ldb,
                                     int n0, int nlim, int kbeg, int kend,
                                     const int* remap = nullptr,
                                     int re = 0) {
  using TA = ATile<T, AT>;
  using TB = BTile<T, BT, BN>;
  constexpr int BK = kBK<T>;
  constexpr size_t kStage = stage_bytes<T, AT, BT, BN, NB>();
  const int nk = (kend - kbeg + BK - 1) / BK;
  if (nk <= 0) return;
  load_stage<T, AT, BT, BN, NB>(smem, a, lda, m0, mlim, b, ldb, n0, nlim,
                                kbeg, kend, remap, re);
  for (int it = 0; it < nk; ++it) {
    if (it + 1 < nk) {
      load_stage<T, AT, BT, BN, NB>(smem + ((it + 1) & 1) * kStage, a, lda,
                                    m0, mlim, b, ldb, n0, nlim,
                                    kbeg + (it + 1) * BK, kend, remap, re);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const unsigned char* stage = smem + (it & 1) * kStage;
    const T* a_s = reinterpret_cast<const T*>(stage);
#pragma unroll
    for (int n = 0; n < NB; ++n)
      acc[n].template mma<AT, BT>(
          a_s, reinterpret_cast<const T*>(stage + TA::bytes + n * TB::bytes));
    __syncthreads();
  }
}

// Where lane's 8 values of piece (i, j) of a BN-wide tile sit in it.
template <int BN>
__device__ __forceinline__ void piece_pos(int i, int j, int* row, int* col) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  *row = (warp & 3) * 32 + i * 16 + (lane >> 1);
  *col = (warp >> 2) * (BN / 2) + j * 16 + (lane & 1) * 8;
}

// ------------------------------------------------------------ forward
// Pass 1, grid (ceil(F / 128), R / 128): h = act(x_t @ w1[e] + b1[e]),
// rounded to T.
template <typename T, bool GATED>
__global__ void __launch_bounds__(NT)
    fwd_act_kernel(const T* __restrict__ x, const T* __restrict__ w1,
                   const void* __restrict__ b1, int b1dt,
                   const int* __restrict__ emap, T* __restrict__ h, int R,
                   int D, int F) {
  constexpr int BN = 128;
  constexpr int NB = GATED ? 2 : 1;
  extern __shared__ __align__(128) unsigned char smem[];
  const int tile = blockIdx.y, m0 = tile * BM, n0 = blockIdx.x * BN;
  const int e = emap[tile];
  const int F2 = GATED ? 2 * F : F;
  const T* w = w1 + (size_t)e * D * F2;
  Ptrs<T, NB> bp;
  bp.p[0] = w;
  if constexpr (GATED) bp.p[NB - 1] = w + F;
  Acc<T, BN> acc[NB];
#pragma unroll
  for (int n = 0; n < NB; ++n) acc[n].zero();
  gemm<T, false, false, BN, NB>(acc, smem, x, D, m0, R, bp, F2, n0, F, 0,
                                D);

#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < Acc<T, BN>::PJ; ++j) {
      float v[8], g[8];
      acc[0].piece(i, j, v);
      if constexpr (GATED) acc[NB - 1].piece(i, j, g);
      int row, col;
      piece_pos<BN>(i, j, &row, &col);
      row += m0;
      col += n0;
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        const int c = col + q;
        if (c >= F) continue;
        const float s = v[q] + load_any(b1, (long long)e * F2 + c, b1dt);
        float hv = s * sigmoid(s);
        if constexpr (GATED)
          hv *= g[q] + load_any(b1, (long long)e * F2 + F + c, b1dt);
        h[(long long)row * F + c] = from_f<T>(hv);
      }
    }
}

// Pass 2, grid (ceil(D' / 128), R / 128): out = h_t @ w2[e] + b2[e].
template <typename T>
__global__ void __launch_bounds__(NT)
    fwd_out_kernel(const T* __restrict__ h, const T* __restrict__ w2,
                   const void* __restrict__ b2, int b2dt,
                   const int* __restrict__ emap, T* __restrict__ out, int R,
                   int F, int Dout) {
  constexpr int BN = 128;
  extern __shared__ __align__(128) unsigned char smem[];
  const int tile = blockIdx.y, m0 = tile * BM, n0 = blockIdx.x * BN;
  const int e = emap[tile];
  Ptrs<T, 1> bp;
  bp.p[0] = w2 + (size_t)e * F * Dout;
  Acc<T, BN> acc;
  acc.zero();
  gemm<T, false, false, BN, 1>(&acc, smem, h, F, m0, R, bp, Dout, n0, Dout,
                               0, F);

#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < Acc<T, BN>::PJ; ++j) {
      float v[8];
      acc.piece(i, j, v);
      int row, col;
      piece_pos<BN>(i, j, &row, &col);
      row += m0;
      col += n0;
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        const int c = col + q;
        if (c < Dout)
          out[(long long)row * Dout + c] = from_f<T>(
              v[q] + load_any(b2, (long long)e * Dout + c, b2dt));
      }
    }
}

// ----------------------------------------------------------- backward
// Pass 1, grid (ceil(F / 64), R / 128): recompute s = x_t @ w1[e] + b1[e]
// and dh = dy_t @ w2[e]^T, then write dsx = T(ds), hx = T(h) and the
// tile's column sums of the unrounded ds (db1_part [R / 128, F2]).
template <typename T, bool GATED>
__global__ void __launch_bounds__(NT)
    bwd_act_kernel(const T* __restrict__ x, const T* __restrict__ dy,
                   const T* __restrict__ w1, const void* __restrict__ b1,
                   int b1dt, const T* __restrict__ w2,
                   const int* __restrict__ emap, T* __restrict__ dsx,
                   T* __restrict__ hx, float* __restrict__ db1_part, int R,
                   int D, int F, int Dout) {
  constexpr int BN = 64;
  constexpr int NB = GATED ? 2 : 1;
  constexpr int PJ = Acc<T, BN>::PJ;
  extern __shared__ __align__(128) unsigned char smem[];
  const int tile = blockIdx.y, m0 = tile * BM, n0 = blockIdx.x * BN;
  const int e = emap[tile];
  const int F2 = GATED ? 2 * F : F;
  const T* w = w1 + (size_t)e * D * F2;
  Ptrs<T, NB> bp;
  bp.p[0] = w;
  if constexpr (GATED) bp.p[NB - 1] = w + F;
  Acc<T, BN> acc_s[NB], acc_dh;
#pragma unroll
  for (int n = 0; n < NB; ++n) acc_s[n].zero();
  acc_dh.zero();
  gemm<T, false, false, BN, NB>(acc_s, smem, x, D, m0, R, bp, F2, n0, F, 0,
                                D);
  Ptrs<T, 1> wp;
  wp.p[0] = w2 + (size_t)e * F * Dout;  // [F, D']: B^T of dh = dy w2^T
  gemm<T, false, true, BN, 1>(&acc_dh, smem, dy, Dout, m0, R, wp, Dout, n0,
                              F, 0, Dout);

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float* colsum = reinterpret_cast<float*>(smem);  // [4][NB*BN]
  float part[NB][PJ][8];
#pragma unroll
  for (int n = 0; n < NB; ++n)
#pragma unroll
    for (int j = 0; j < PJ; ++j)
#pragma unroll
      for (int q = 0; q < 8; ++q) part[n][j][q] = 0.f;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < PJ; ++j) {
      float sv[8], gv[8], dh[8];
      acc_s[0].piece(i, j, sv);
      if constexpr (GATED) acc_s[NB - 1].piece(i, j, gv);
      acc_dh.piece(i, j, dh);
      int row, col;
      piece_pos<BN>(i, j, &row, &col);
      row += m0;
      col += n0;
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        const int c = col + q;
        float ds0 = 0.f, ds1 = 0.f;
        if (c < F) {
          const float s = sv[q] + load_any(b1, (long long)e * F2 + c, b1dt);
          const float sig = sigmoid(s);
          const float su = s * sig;
          const float du = sig * (1.f + s * (1.f - sig));
          float hv;
          if constexpr (GATED) {
            const float g =
                gv[q] + load_any(b1, (long long)e * F2 + F + c, b1dt);
            hv = su * g;
            ds0 = dh[q] * g * du;
            ds1 = dh[q] * su;
            dsx[(long long)row * F2 + F + c] = from_f<T>(ds1);
          } else {
            hv = su;
            ds0 = dh[q] * du;
          }
          dsx[(long long)row * F2 + c] = from_f<T>(ds0);
          hx[(long long)row * F + c] = from_f<T>(hv);
        }
        // column sums over the piece's 16 rows: lanes of one column
        // parity, in a fixed butterfly order
#pragma unroll
        for (int o = 2; o < 32; o <<= 1) {
          ds0 += __shfl_xor_sync(0xffffffffu, ds0, o);
          if constexpr (GATED) ds1 += __shfl_xor_sync(0xffffffffu, ds1, o);
        }
        part[0][j][q] += ds0;
        if constexpr (GATED) part[NB - 1][j][q] += ds1;
      }
    }
  __syncthreads();  // the shared tiles are done with
  if (lane < 2) {
    const int wm = warp & 3, wn = warp >> 2;
#pragma unroll
    for (int n = 0; n < NB; ++n)
#pragma unroll
      for (int j = 0; j < PJ; ++j)
#pragma unroll
        for (int q = 0; q < 8; ++q)
          colsum[wm * NB * BN + n * BN + wn * (BN / 2) + j * 16 + lane * 8 +
                 q] = part[n][j][q];
  }
  __syncthreads();
  for (int t = threadIdx.x; t < NB * BN; t += NT) {
    const int n = t / BN, c = n0 + t % BN;
    if (c >= F) continue;
    float s = 0.f;
#pragma unroll
    for (int wm = 0; wm < 4; ++wm) s += colsum[wm * NB * BN + t];
    db1_part[(long long)tile * F2 + n * F + c] = s;
  }
}

// Pass 2, grid (ceil(D / 128), R / 128): dx = dsx_t @ w1[e]^T.
template <typename T>
__global__ void __launch_bounds__(NT)
    bwd_dx_kernel(const T* __restrict__ dsx, const T* __restrict__ w1,
                  const int* __restrict__ emap, T* __restrict__ dx, int R,
                  int D, int F2) {
  constexpr int BN = 128;
  extern __shared__ __align__(128) unsigned char smem[];
  const int tile = blockIdx.y, m0 = tile * BM, n0 = blockIdx.x * BN;
  const int e = emap[tile];
  Ptrs<T, 1> bp;
  bp.p[0] = w1 + (size_t)e * D * F2;  // [D, F2]: B^T of dx = dsx w1^T
  Acc<T, BN> acc;
  acc.zero();
  gemm<T, false, true, BN, 1>(&acc, smem, dsx, F2, m0, R, bp, F2, n0, D, 0,
                              F2);

#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < Acc<T, BN>::PJ; ++j) {
      float v[8];
      acc.piece(i, j, v);
      int row, col;
      piece_pos<BN>(i, j, &row, &col);
      row += m0;
      col += n0;
#pragma unroll
      for (int q = 0; q < 8; ++q)
        if (col + q < D) dx[(long long)row * D + col + q] = from_f<T>(v[q]);
    }
}

// Passes 3 and 4, grid (ceil(M / 128), ceil(N / 128), E): dw[e] = sum over
// expert e's tiles t of a_t^T @ b_t, with a [R, M] and b [R, N] (dw1: x
// and dsx; dw2: hx and dy).  One CTA per (expert, output block) walks
// the expert's tiles in order: a fixed-order reduction with no atomics;
// an expert with no tile writes zeros.  dw is [E, M, N] in dtype wdt.
template <typename T>
__global__ void __launch_bounds__(NT)
    bwd_dw_kernel(const T* __restrict__ a, const T* __restrict__ b,
                  const int* __restrict__ emap, int ntiles,
                  void* __restrict__ dw, int wdt, int M, int N) {
  constexpr int BN = 128;
  extern __shared__ __align__(128) unsigned char smem[];
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN, e = blockIdx.z;
  // the expert's tile run: its first and last tile (a tile between them
  // of another expert, which a non-decreasing emap never has, reads as
  // zeros through the remap test)
  int first = ntiles, last = -1;
  for (int t = 0; t < ntiles; ++t)
    if (emap[t] == e) {
      first = min(first, t);
      last = t;
    }
  Ptrs<T, 1> bp;
  bp.p[0] = b;
  Acc<T, BN> acc;
  acc.zero();
  gemm<T, true, false, BN, 1>(&acc, smem, a, M, m0, M, bp, N, n0, N,
                              first * TILE, (last + 1) * TILE, emap, e);

#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < Acc<T, BN>::PJ; ++j) {
      float v[8];
      acc.piece(i, j, v);
      int row, col;
      piece_pos<BN>(i, j, &row, &col);
      row += m0;
      col += n0;
      if (row >= M) continue;
#pragma unroll
      for (int q = 0; q < 8; ++q)
        if (col + q < N)
          store_any(dw, ((long long)e * M + row) * N + col + q, v[q], wdt);
    }
}

// grid (ceil(C / 256), R / 128): part[t, c] = sum over tile t's 128
// rows, in order, of src[row, c] (db2's per-tile partials, from dy).
template <typename TS>
__global__ void __launch_bounds__(256)
    tile_sums_kernel(const TS* __restrict__ src, int C,
                     float* __restrict__ part) {
  const int c = blockIdx.x * 256 + threadIdx.x;
  const int t = blockIdx.y;
  if (c >= C) return;
  const TS* p = src + (long long)t * TILE * C + c;
  float s = 0.f;
#pragma unroll 16
  for (int r = 0; r < TILE; ++r) s += to_f(p[(long long)r * C]);
  part[(long long)t * C + c] = s;
}

// grid (ceil(C / 256), E): out[e, c] = sum over expert e's tiles t, in
// order, of part[t, c] (db1 and db2 from their per-tile partials).
__global__ void __launch_bounds__(256)
    colsum_kernel(const float* __restrict__ part, int C,
                  const int* __restrict__ emap, int ntiles,
                  void* __restrict__ out, int odt) {
  const int c = blockIdx.x * 256 + threadIdx.x;
  const int e = blockIdx.y;
  if (c >= C) return;
  float s = 0.f;
  for (int t = 0; t < ntiles; ++t)
    if (emap[t] == e) s += part[(long long)t * C + c];
  store_any(out, (long long)e * C + c, s, odt);
}

// db1 and db2 from their per-tile partials (db2's summed from dy first).
template <typename T>
cudaError_t bias_grads(const float* db1_part, const T* dy, float* db2_part,
                       const int* emap, void* db1, void* db2, int b1dt,
                       int b2dt, int F2, int Dout, int E, int nt,
                       cudaStream_t st) {
  colsum_kernel<<<dim3((F2 + 255) / 256, E), 256, 0, st>>>(db1_part, F2, emap,
                                                          nt, db1, b1dt);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  tile_sums_kernel<T><<<dim3((Dout + 255) / 256, nt), 256, 0, st>>>(
      dy, Dout, db2_part);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  colsum_kernel<<<dim3((Dout + 255) / 256, E), 256, 0, st>>>(
      db2_part, Dout, emap, nt, db2, b2dt);
  return cudaGetLastError();
}

// Dynamic shared bytes of each kernel: two pipeline stages (and, in
// backward pass 1, the column sums after them).
template <typename T, bool GATED>
constexpr size_t fwd_act_smem() {
  return 2 * stage_bytes<T, false, false, 128, GATED ? 2 : 1>();
}
template <typename T>
constexpr size_t fwd_out_smem() {
  return 2 * stage_bytes<T, false, false, 128, 1>();
}
template <typename T, bool GATED>
constexpr size_t bwd_act_smem() {
  constexpr int NB = GATED ? 2 : 1;
  return cmax(cmax(2 * stage_bytes<T, false, false, 64, NB>(),
                   2 * stage_bytes<T, false, true, 64, 1>()),
              (size_t)4 * NB * 64 * 4);
}
template <typename T>
constexpr size_t bwd_dx_smem() {
  return 2 * stage_bytes<T, false, true, 128, 1>();
}
template <typename T>
constexpr size_t bwd_dw_smem() {
  return 2 * stage_bytes<T, true, false, 128, 1>();
}

// Allow a kernel its dynamic shared bytes (past the 48 KB default).
template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

template <typename T>
cudaError_t fwd(int b1dt, int b2dt, int gated, const void* x, const void* w1,
                const void* b1, const void* w2, const void* b2,
                const int* emap, void* h, void* out, int R, int D, int F,
                int Dout, cudaStream_t st) {
  const int nt = R / TILE;
  const dim3 g1((F + 127) / 128, nt);
  cudaError_t err;
  if (gated) {
    constexpr size_t kSmem = fwd_act_smem<T, true>();
    if ((err = allow_smem(fwd_act_kernel<T, true>, kSmem)) != cudaSuccess)
      return err;
    fwd_act_kernel<T, true><<<g1, NT, kSmem, st>>>(
        static_cast<const T*>(x), static_cast<const T*>(w1), b1, b1dt, emap,
        static_cast<T*>(h), R, D, F);
  } else {
    constexpr size_t kSmem = fwd_act_smem<T, false>();
    if ((err = allow_smem(fwd_act_kernel<T, false>, kSmem)) != cudaSuccess)
      return err;
    fwd_act_kernel<T, false><<<g1, NT, kSmem, st>>>(
        static_cast<const T*>(x), static_cast<const T*>(w1), b1, b1dt, emap,
        static_cast<T*>(h), R, D, F);
  }
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  constexpr size_t kOut = fwd_out_smem<T>();
  if ((err = allow_smem(fwd_out_kernel<T>, kOut)) != cudaSuccess) return err;
  fwd_out_kernel<T><<<dim3((Dout + 127) / 128, nt), NT, kOut, st>>>(
      static_cast<const T*>(h), static_cast<const T*>(w2), b2, b2dt, emap,
      static_cast<T*>(out), R, F, Dout);
  return cudaGetLastError();
}

template <typename T>
cudaError_t bwd(int b1dt, int b2dt, int gated, const void* x, const void* dy,
                const void* w1, const void* b1, const void* w2,
                const int* emap, void* dsx, void* hx, float* db1_part,
                float* db2_part, void* dx, void* dw1, void* dw2, void* db1,
                void* db2, int R, int D, int F, int Dout, int E,
                cudaStream_t st) {
  constexpr int wdt = kIsBf16<T> ? 1 : 0;
  const int nt = R / TILE;
  const int F2 = gated ? 2 * F : F;
  const T* xt = static_cast<const T*>(x);
  const T* dyt = static_cast<const T*>(dy);
  const dim3 g1((F + 63) / 64, nt);
  cudaError_t err;
  if (gated) {
    constexpr size_t kSmem = bwd_act_smem<T, true>();
    if ((err = allow_smem(bwd_act_kernel<T, true>, kSmem)) != cudaSuccess)
      return err;
    bwd_act_kernel<T, true><<<g1, NT, kSmem, st>>>(
        xt, dyt, static_cast<const T*>(w1), b1, b1dt,
        static_cast<const T*>(w2), emap, static_cast<T*>(dsx),
        static_cast<T*>(hx), db1_part, R, D, F, Dout);
  } else {
    constexpr size_t kSmem = bwd_act_smem<T, false>();
    if ((err = allow_smem(bwd_act_kernel<T, false>, kSmem)) != cudaSuccess)
      return err;
    bwd_act_kernel<T, false><<<g1, NT, kSmem, st>>>(
        xt, dyt, static_cast<const T*>(w1), b1, b1dt,
        static_cast<const T*>(w2), emap, static_cast<T*>(dsx),
        static_cast<T*>(hx), db1_part, R, D, F, Dout);
  }
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  constexpr size_t kDx = bwd_dx_smem<T>();
  if ((err = allow_smem(bwd_dx_kernel<T>, kDx)) != cudaSuccess) return err;
  bwd_dx_kernel<T><<<dim3((D + 127) / 128, nt), NT, kDx, st>>>(
      static_cast<const T*>(dsx), static_cast<const T*>(w1), emap,
      static_cast<T*>(dx), R, D, F2);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  constexpr size_t kDw = bwd_dw_smem<T>();
  if ((err = allow_smem(bwd_dw_kernel<T>, kDw)) != cudaSuccess) return err;
  bwd_dw_kernel<T><<<dim3((D + 127) / 128, (F2 + 127) / 128, E), NT, kDw,
                     st>>>(xt, static_cast<const T*>(dsx), emap, nt, dw1,
                           wdt, D, F2);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  bwd_dw_kernel<T><<<dim3((F + 127) / 128, (Dout + 127) / 128, E), NT, kDw,
                     st>>>(static_cast<const T*>(hx), dyt, emap, nt, dw2,
                           wdt, F, Dout);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  return bias_grads(db1_part, dyt, db2_part, emap, db1, db2, b1dt, b2dt, F2,
                    Dout, E, nt, st);
}

// ------------------------------------------------------- bf16, Hopper
// Every bf16 product is one warp-specialised wgmma GEMM: warpgroup 0 is
// the producer (one thread keeps an NS-stage TMA ring full, 64-wide K
// steps; setmaxnreg gives its registers away), warpgroups 1 and 2 are
// consumers, each owning 64 rows of the CTA's 128-row tile with its f32
// accumulators in registers.  The mbarrier, TMA, descriptor and register
// helpers are flash_sm90.cuh's.
namespace sm90 {

using flash_sm90::advance;
using flash_sm90::align_smem;
using flash_sm90::consumer_sync;
using flash_sm90::desc_k;
using flash_sm90::desc_mn;
using flash_sm90::mbar_arrive;
using flash_sm90::mbar_expect_tx;
using flash_sm90::mbar_init;
using flash_sm90::mbar_wait;
using flash_sm90::pack_bf16;
using flash_sm90::reg_alloc;
using flash_sm90::reg_dealloc;
using flash_sm90::reg_fence;
using flash_sm90::tma_box;
using flash_sm90::wg_commit;
using flash_sm90::wg_fence;
using flash_sm90::wg_wait;
typedef __nv_bfloat16 bf16;

// The logistic of the bf16 kernels' activations, 1 / (1 + exp(-s)) by
// the MUFU unit: ex2.approx and rcp.approx, within a few ulp of f32 where
// expf and the IEEE division of sigmoid() took a quarter of forward pass
// 1's time (NVIDIA H100, PERF.md).  Every use rounds the result to bf16
// (h, ds) or multiplies an f32 sum by it once, so these ulp only move a
// rounding that lies within them of a bf16 boundary; the float32
// instances keep sigmoid(), to agree with the CPU to f32 rounding.
__device__ __forceinline__ float sigmoid_fast(float s) {
  return __fdividef(1.f, 1.f + __expf(-s));
}

constexpr int NT = 384;              // producer + two consumer warpgroups
constexpr int BK = 64;               // K per stage: 128 bytes of bf16
constexpr int NS = 4;                // ring stages
constexpr uint32_t kPanel = 64 * 128;   // a [64, 64] bf16 box: 8 KB
constexpr uint32_t kATile = 2 * kPanel; // A [128 rows, 64] (or 2 panels)
constexpr int kProducerRegs = 40, kConsumerRegs = 232;

// d[128] += A . B, m64n256k16, both operands in shared memory; TA / TB
// the transpose bits (0: K-major, 1: MN-major).
template <int TA, int TB>
__device__ __forceinline__ void wgmma(float (&d)[128], uint64_t da,
                                      uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, "
      "%128, %129, p, 1, 1, %131, %132;\n}\n"
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
      : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB));
}

// d[64] += A . B, m64n128k16, both operands in shared memory; TA / TB
// the transpose bits (0: K-major, 1: MN-major).
template <int TA, int TB>
__device__ __forceinline__ void wgmma(float (&d)[64], uint64_t da,
                                      uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, %67, %68;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB));
}

// d[32] += A . B, m64n64k16, both operands in shared memory; TA / TB
// the transpose bits (0: K-major, 1: MN-major).
template <int TA, int TB>
__device__ __forceinline__ void wgmma(float (&d)[32], uint64_t da,
                                      uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, %35, %36;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB));
}

// acc += A . B over one BK step: A the warpgroup's 64 rows at shared
// address a, B [BK, N] at b; K-major operands (TA / TB 0) are rows of
// 128 swizzled bytes of K, MN-major ones (1) rows of 64 M (N) values per
// K index in 64-column panels kPanel bytes apart.  A k16 step moves 32
// bytes along a K-major row, 16 rows (2 KB) down an MN-major panel.
template <int TA, int TB, int AN>
__device__ __forceinline__ void mma_step(float (&acc)[AN], uint32_t a,
                                         uint32_t b) {
  uint64_t da = TA ? desc_mn(a, kPanel) : desc_k(a);
  uint64_t db = TB ? desc_mn(b, kPanel) : desc_k(b);
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk) {
    wgmma<TA, TB>(acc, da, db);
    if (kk < BK / 16 - 1) {
      advance<(TA ? 128 : 2)>(da);
      advance<(TB ? 128 : 2)>(db);
    }
  }
}

// The ring: NS stages of ``stage`` bytes from a 1024-byte aligned base,
// then a full and an empty mbarrier per stage, then ``extra``.
struct Ring {
  uint32_t base, stage;
  __device__ uint32_t at(int s) const { return base + s * stage; }
  __device__ uint32_t full(int s) const { return base + NS * stage + 8 * s; }
  __device__ uint32_t empty(int s) const {
    return base + NS * stage + 8 * (NS + s);
  }
};

__host__ __device__ constexpr size_t ring_smem(uint32_t stage, size_t extra) {
  return 1024 + NS * (size_t)stage + 16 * NS + extra;
}

// Set up the barriers (full: the producer's arrival plus the TMA bytes;
// empty: one arrival per consumer warp); returns the ring and, in
// *extra, the shared memory after it.
__device__ __forceinline__ Ring ring_init(unsigned char* raw, uint32_t stage,
                                          unsigned char** extra) {
  uint32_t base;
  unsigned char* smem = align_smem(raw, &base);
  const Ring r{base, stage};
  if (threadIdx.x == 0) {
    for (int s = 0; s < NS; ++s) {
      mbar_init(r.full(s), 1);
      mbar_init(r.empty(s), 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  *extra = smem + NS * stage + 16 * NS;
  return r;
}

// Producer: wait until step i's stage is free, then let ``load`` arm its
// full barrier and issue the copies.
template <class Load>
__device__ __forceinline__ void produce(const Ring& r, int i, Load load) {
  const int s = i % NS;
  mbar_wait(r.empty(s), ((i / NS) & 1) ^ 1);
  load(r.at(s), r.full(s));
}

// Consumers: steps i0 .. i0 + n - 1 of ``mma`` (issue wgmmas on the
// stage at the given address; the step counted from i0); a stage is
// released once the wgmmas of the next step are issued and its own have
// completed, the last one when all have.
template <class Mma>
__device__ __forceinline__ void consume(const Ring& r, int i0, int n,
                                        Mma mma) {
  const int lane = threadIdx.x & 31;
  for (int k = 0; k < n; ++k) {
    const int i = i0 + k, s = i % NS;
    mbar_wait(r.full(s), (i / NS) & 1);
    wg_fence();
    mma(k, r.at(s));
    wg_commit();
    wg_wait<1>();
    if (k > 0 && lane == 0) mbar_arrive(r.empty((i + NS - 1) % NS));
  }
  wg_wait<0>();
  if (n > 0 && lane == 0) mbar_arrive(r.empty((i0 + n - 1) % NS));
}

template <int AN>
__device__ __forceinline__ void zero(float (&acc)[AN]) {
#pragma unroll
  for (int i = 0; i < AN; ++i) acc[i] = 0.f;
}

// A consumer warp's staging area for its 16 rows x 64 columns of bf16
// output: rows 36 words (144 bytes) apart, so that neither the pairs
// written in the accumulator layout nor the 16-byte row reads meet a
// bank conflict.  stage_of(extra) is the calling warp's.
constexpr int kStageWords = 16 * 36;
constexpr size_t kStagingBytes = 8 * kStageWords * 4;
__device__ __forceinline__ uint32_t* stage_of(unsigned char* extra) {
  return reinterpret_cast<uint32_t*>(extra) +
         ((threadIdx.x - 128) >> 5) * kStageWords;
}

// Store 64 columns (col0 ..) of the warp's 16 rows of a [128, .] output
// tile: pk[jj][rr] holds the thread's bf16 pair of row row0 + 8 rr,
// columns col0 + 8 jj + 2 t (+ 1).  The pairs go through the warp's
// staging area, then each lane stores 16 bytes, 8 lanes a 128-byte row
// segment, instead of 4-byte stores that fill half sectors.  Row r of
// the tile lands at dst + r * ld; only rows r < rows and columns < N are
// written (N a multiple of 8).
__device__ __forceinline__ void store_chunk(const uint32_t (&pk)[8][2],
                                            uint32_t* stage, bf16* dst,
                                            long long ld, int col0, int N,
                                            int rows) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int wr =
      ((threadIdx.x - 128) >> 7) * 64 + ((threadIdx.x >> 5) & 3) * 16;
#pragma unroll
  for (int jj = 0; jj < 8; ++jj) {
    stage[g * 36 + 4 * jj + t] = pk[jj][0];
    stage[(g + 8) * 36 + 4 * jj + t] = pk[jj][1];
  }
  __syncwarp();
#pragma unroll
  for (int pass = 0; pass < 4; ++pass) {
    const int r = 4 * pass + (lane >> 3), cv = lane & 7;
    const int c = col0 + 8 * cv;
    const uint4 v = *reinterpret_cast<const uint4*>(stage + r * 36 + 4 * cv);
    if (wr + r < rows && c < N)
      *reinterpret_cast<uint4*>(dst + (long long)(wr + r) * ld + c) = v;
  }
  __syncwarp();
}

__device__ __forceinline__ float2 load2_any(const void* p, long long i,
                                            int dt) {
  return make_float2(load_any(p, i, dt), load_any(p, i + 1, dt));
}

struct Args {
  const int* emap;
  int ntiles;
  const void* b1;
  const void* b2;
  int b1dt, b2dt;
  bf16* out;      // h, out, dx or dw
  bf16* hx;       // backward pass 1: h and ds in T
  bf16* dsx;
  float* db1_part;
  const int* tiles;   // expert e's tiles at [e * ntiles, ...), the counts
                      // at [E * ntiles + e]
  int D, F, Dout, E;
  int M, N;       // the weight-gradient pass's output [M, N] per expert
};

// Every kernel below is persistent: CTA b takes work items b, b +
// gridDim.x, ... (a row tile and an N block; the producer runs ahead into
// the next item while the consumers store this one), and one ring runs
// through all of them, its steps counted across items.

// Forward pass 1, items (row tile, BN-column block of F): h =
// act(x_t . w1[e] + b1[e]) in T.  A = x (K-major), B = w1[e] (MN-major:
// [D, F2] rows), the gated variant's second accumulator the same column
// block of the gate half.  BN = 256, 128 for the gated variant (two
// accumulators): 32 KB of B a step either way.
template <bool GATED>
constexpr int kFwdBN = GATED ? 128 : 256;

template <bool GATED>
__global__ void __launch_bounds__(NT, 1)
    fwd_act_kernel(const __grid_constant__ CUtensorMap tx,
                   const __grid_constant__ CUtensorMap tw1, const Args p) {
  constexpr int NB = GATED ? 2 : 1;
  constexpr int BN = kFwdBN<GATED>;
  constexpr uint32_t kB = BN * 128;     // [BK, BN]
  constexpr uint32_t kStage = kATile + NB * kB;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* extra;
  const Ring r = ring_init(smem_raw, kStage, &extra);
  const int nblk = (p.F + BN - 1) / BN, items = p.ntiles * nblk;
  const int nk = (p.D + BK - 1) / BK;
  if (threadIdx.x < 128) {
    reg_dealloc<kProducerRegs>();
    if (threadIdx.x == 0)
      for (int w = blockIdx.x, i = 0; w < items; w += gridDim.x) {
        const int tile = w / nblk, m0 = tile * 128, n0 = w % nblk * BN;
        const int e = p.emap[tile];
        for (int k = 0; k < nk; ++k, ++i)
          produce(r, i, [&](uint32_t st, uint32_t bar) {
            mbar_expect_tx(bar, kStage);
            tma_box(st, &tx, bar, k * BK, m0, 0, 0);
#pragma unroll
            for (int nb = 0; nb < NB; ++nb)
#pragma unroll
              for (int c = 0; c < BN / 64; ++c)
                tma_box(st + kATile + nb * kB + c * kPanel, &tw1, bar,
                        (nb ? p.F : 0) + n0 + 64 * c, k * BK, e, 0);
          });
      }
    return;
  }
  reg_alloc<kConsumerRegs>();
  const int cw = (threadIdx.x - 128) >> 7;
  const int t = threadIdx.x & 3;   // columns 8 j + 2 t (+ 1)
  uint32_t* stage = stage_of(extra);
  const int F2 = GATED ? 2 * p.F : p.F;
  for (int w = blockIdx.x, i = 0; w < items; w += gridDim.x, i += nk) {
    const int tile = w / nblk, m0 = tile * 128, n0 = w % nblk * BN;
    const int e = p.emap[tile];
    float acc[NB][BN / 2];
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) zero(acc[nb]);
    consume(r, i, nk, [&](int, uint32_t st) {
#pragma unroll
      for (int nb = 0; nb < NB; ++nb)
        mma_step<0, 1>(acc[nb], st + cw * kPanel, st + kATile + nb * kB);
    });
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) reg_fence(acc[nb]);
#pragma unroll
    for (int ch = 0; ch < BN / 64; ++ch) {
      uint32_t pk[8][2];
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        const int j = 8 * ch + jj, c = n0 + 8 * j + 2 * t;
        pk[jj][0] = pk[jj][1] = 0;
        if (c >= p.F) continue;
        const float2 bu = load2_any(p.b1, (long long)e * F2 + c, p.b1dt);
        float2 bg = make_float2(0.f, 0.f);
        if constexpr (GATED)
          bg = load2_any(p.b1, (long long)e * F2 + p.F + c, p.b1dt);
#pragma unroll
        for (int rr = 0; rr < 2; ++rr) {
          const float s0 = acc[0][4 * j + 2 * rr] + bu.x;
          const float s1 = acc[0][4 * j + 2 * rr + 1] + bu.y;
          float h0 = s0 * sigmoid_fast(s0), h1 = s1 * sigmoid_fast(s1);
          if constexpr (GATED) {
            h0 *= acc[NB - 1][4 * j + 2 * rr] + bg.x;
            h1 *= acc[NB - 1][4 * j + 2 * rr + 1] + bg.y;
          }
          pk[jj][rr] = pack_bf16(h0, h1);
        }
      }
      store_chunk(pk, stage, p.out + (long long)m0 * p.F, p.F, n0 + 64 * ch,
                  p.F, 128);
    }
  }
}

// The K-major A products of forward pass 2 and the dx pass, items (row
// tile, 256-column block of N): out_t = A_t . B[e] (+ b2[e] in pass 2),
// K steps over the shared dim Kd.  B_KMAJOR: B is [N, Kd] rows (w1[e]
// for dx = ds . w1^T), else [Kd, N] rows (w2[e]).
constexpr int kBN = 256;   // the N block of the other products

template <bool B_KMAJOR>
__global__ void __launch_bounds__(NT, 1)
    rows_kernel(const __grid_constant__ CUtensorMap ta,
                const __grid_constant__ CUtensorMap tb, const Args p, int N,
                int Kd) {
  constexpr int BN = kBN;
  constexpr uint32_t kB = BN * 128;
  constexpr uint32_t kStage = kATile + kB;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* extra;
  const Ring r = ring_init(smem_raw, kStage, &extra);
  const int nblk = (N + BN - 1) / BN, items = p.ntiles * nblk;
  const int nk = (Kd + BK - 1) / BK;
  if (threadIdx.x < 128) {
    reg_dealloc<kProducerRegs>();
    if (threadIdx.x == 0)
      for (int w = blockIdx.x, i = 0; w < items; w += gridDim.x) {
        const int tile = w / nblk, m0 = tile * 128, n0 = w % nblk * BN;
        const int e = p.emap[tile];
        for (int k = 0; k < nk; ++k, ++i)
          produce(r, i, [&](uint32_t st, uint32_t bar) {
            mbar_expect_tx(bar, kStage);
            tma_box(st, &ta, bar, k * BK, m0, 0, 0);
            if constexpr (B_KMAJOR) {
              tma_box(st + kATile, &tb, bar, k * BK, n0, e, 0);
            } else {
#pragma unroll
              for (int c = 0; c < BN / 64; ++c)
                tma_box(st + kATile + c * kPanel, &tb, bar, n0 + 64 * c,
                        k * BK, e, 0);
            }
          });
      }
    return;
  }
  reg_alloc<kConsumerRegs>();
  const int cw = (threadIdx.x - 128) >> 7;
  const int t = threadIdx.x & 3;   // columns 8 j + 2 t (+ 1)
  uint32_t* stage = stage_of(extra);
  for (int w = blockIdx.x, i = 0; w < items; w += gridDim.x, i += nk) {
    const int tile = w / nblk, m0 = tile * 128, n0 = w % nblk * BN;
    const int e = p.emap[tile];
    float acc[BN / 2];
    zero(acc);
    consume(r, i, nk, [&](int, uint32_t st) {
      mma_step<0, (B_KMAJOR ? 0 : 1)>(acc, st + cw * kPanel, st + kATile);
    });
    reg_fence(acc);
#pragma unroll
    for (int ch = 0; ch < BN / 64; ++ch) {
      uint32_t pk[8][2];
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        const int j = 8 * ch + jj, c = n0 + 8 * j + 2 * t;
        float2 bias = make_float2(0.f, 0.f);
        if constexpr (!B_KMAJOR)
          if (c < N) bias = load2_any(p.b2, (long long)e * N + c, p.b2dt);
#pragma unroll
        for (int rr = 0; rr < 2; ++rr)
          pk[jj][rr] = pack_bf16(acc[4 * j + 2 * rr] + bias.x,
                                 acc[4 * j + 2 * rr + 1] + bias.y);
      }
      store_chunk(pk, stage, p.out + (long long)m0 * N, N, n0 + 64 * ch, N,
                  128);
    }
  }
}

template <bool GATED>
constexpr int kActBN = GATED ? 64 : 128;

// Backward pass 1, items (row tile, BN-column block of F): recompute s
// = x_t . w1[e] + b1[e] (K steps over D; the gated variant's second
// accumulator the gate half) and dh = dy_t . w2[e]^T (K steps over D':
// w2[e] is [F, D'] rows, K-major), then write dsx = T(ds), hx = T(h)
// and the tile's column sums of the unrounded ds (db1_part [R / 128,
// F2]), summed over the 8 consumer warps in a fixed order.  BN = 128
// columns (two accumulators), 64 for the gated variant (three).
template <bool GATED>
__global__ void __launch_bounds__(NT, 1)
    bwd_act_kernel(const __grid_constant__ CUtensorMap tx,
                   const __grid_constant__ CUtensorMap tw1,
                   const __grid_constant__ CUtensorMap tdy,
                   const __grid_constant__ CUtensorMap tw2, const Args p) {
  constexpr int NB = GATED ? 2 : 1;
  constexpr int BN = kActBN<GATED>, AN = BN / 2;
  constexpr uint32_t kB = BN * 128;     // [BK, BN] or [BN, BK]
  constexpr uint32_t kStage = kATile + NB * kB;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* extra;
  const Ring r = ring_init(smem_raw, kStage, &extra);
  const int nblk = (p.F + BN - 1) / BN, items = p.ntiles * nblk;
  const int n1 = (p.D + BK - 1) / BK, n2 = (p.Dout + BK - 1) / BK;
  if (threadIdx.x < 128) {
    reg_dealloc<kProducerRegs>();
    if (threadIdx.x == 0)
      for (int w = blockIdx.x, i = 0; w < items; w += gridDim.x) {
        const int tile = w / nblk, m0 = tile * 128, n0 = w % nblk * BN;
        const int e = p.emap[tile];
        for (int k = 0; k < n1 + n2; ++k, ++i)
          produce(r, i, [&](uint32_t st, uint32_t bar) {
            if (k < n1) {
              mbar_expect_tx(bar, kStage);
              tma_box(st, &tx, bar, k * BK, m0, 0, 0);
#pragma unroll
              for (int nb = 0; nb < NB; ++nb)
#pragma unroll
                for (int c = 0; c < BN / 64; ++c)
                  tma_box(st + kATile + nb * kB + c * kPanel, &tw1, bar,
                          (nb ? p.F : 0) + n0 + 64 * c, k * BK, e, 0);
            } else {
              const int k0 = (k - n1) * BK;
              mbar_expect_tx(bar, kATile + kB);
              tma_box(st, &tdy, bar, k0, m0, 0, 0);
              tma_box(st + kATile, &tw2, bar, k0, n0, e, 0);
            }
          });
      }
    return;
  }
  reg_alloc<kConsumerRegs>();
  const int cw = (threadIdx.x - 128) >> 7;
  const int t = threadIdx.x & 3;   // columns 8 j + 2 t (+ 1)
  const int F = p.F, F2 = GATED ? 2 * F : F;
  const int lane = threadIdx.x & 31, ci = threadIdx.x - 128;
  const int w8 = ci >> 5;                           // consumer warp 0..7
  uint32_t* stage = stage_of(extra);
  // after the staging areas, the column sums [8 warps][NB * BN]
  float* colsum = reinterpret_cast<float*>(extra + kStagingBytes);
  for (int w = blockIdx.x, i = 0; w < items;
       w += gridDim.x, i += n1 + n2) {
    const int tile = w / nblk, m0 = tile * 128, n0 = w % nblk * BN;
    const int e = p.emap[tile];
    float acc_s[NB][AN], acc_dh[AN];
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) zero(acc_s[nb]);
    zero(acc_dh);
    consume(r, i, n1 + n2, [&](int k, uint32_t st) {
      const uint32_t a = st + cw * kPanel;
      if (k < n1) {
#pragma unroll
        for (int nb = 0; nb < NB; ++nb)
          mma_step<0, 1>(acc_s[nb], a, st + kATile + nb * kB);
      } else {
        mma_step<0, 0>(acc_dh, a, st + kATile);
      }
    });
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) reg_fence(acc_s[nb]);
    reg_fence(acc_dh);
#pragma unroll
    for (int ch = 0; ch < BN / 64; ++ch) {
      uint32_t pk_ds[8][2], pk_g[8][2], pk_h[8][2];
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        const int j = 8 * ch + jj, c = n0 + 8 * j + 2 * t;
        float part[NB][2];
#pragma unroll
        for (int nb = 0; nb < NB; ++nb) part[nb][0] = part[nb][1] = 0.f;
#pragma unroll
        for (int rr = 0; rr < 2; ++rr)
          pk_ds[jj][rr] = pk_g[jj][rr] = pk_h[jj][rr] = 0;
        if (c < F) {
          const float2 bu = load2_any(p.b1, (long long)e * F2 + c, p.b1dt);
          float2 bg = make_float2(0.f, 0.f);
          if constexpr (GATED)
            bg = load2_any(p.b1, (long long)e * F2 + F + c, p.b1dt);
#pragma unroll
          for (int rr = 0; rr < 2; ++rr) {
            float ds0[2], ds1[2], hv[2];
#pragma unroll
            for (int cc = 0; cc < 2; ++cc) {
              const int k = 4 * j + 2 * rr + cc;
              const float s = acc_s[0][k] + (cc ? bu.y : bu.x);
              const float sig = sigmoid_fast(s);
              const float su = s * sig;
              const float du = sig * (1.f + s * (1.f - sig));
              const float dh = acc_dh[k];
              if constexpr (GATED) {
                const float g = acc_s[NB - 1][k] + (cc ? bg.y : bg.x);
                hv[cc] = su * g;
                ds0[cc] = dh * g * du;
                ds1[cc] = dh * su;
              } else {
                hv[cc] = su;
                ds0[cc] = dh * du;
                ds1[cc] = 0.f;
              }
              part[0][cc] += ds0[cc];
              if constexpr (GATED) part[NB - 1][cc] += ds1[cc];
            }
            pk_ds[jj][rr] = pack_bf16(ds0[0], ds0[1]);
            pk_g[jj][rr] = pack_bf16(ds1[0], ds1[1]);
            pk_h[jj][rr] = pack_bf16(hv[0], hv[1]);
          }
        }
        // the warp's 16 rows: lanes of one t, in a fixed butterfly order
#pragma unroll
        for (int nb = 0; nb < NB; ++nb)
#pragma unroll
          for (int cc = 0; cc < 2; ++cc) {
            float v = part[nb][cc];
#pragma unroll
            for (int o = 4; o < 32; o <<= 1)
              v += __shfl_xor_sync(0xffffffffu, v, o);
            if (lane < 4)
              colsum[w8 * NB * BN + nb * BN + 8 * j + 2 * t + cc] = v;
          }
      }
      const int col0 = n0 + 64 * ch;
      store_chunk(pk_ds, stage, p.dsx + (long long)m0 * F2, F2, col0, F,
                  128);
      if constexpr (GATED)
        store_chunk(pk_g, stage, p.dsx + (long long)m0 * F2 + F, F2, col0, F,
                    128);
      store_chunk(pk_h, stage, p.hx + (long long)m0 * F, F, col0, F, 128);
    }
    consumer_sync(256);
    if (ci < NB * BN) {
      const int nb = ci / BN, c = n0 + ci % BN;
      if (c < F) {
        float sum = 0.f;
#pragma unroll
        for (int v = 0; v < 8; ++v) sum += colsum[v * NB * BN + ci];
        p.db1_part[(long long)tile * F2 + nb * F + c] = sum;
      }
    }
    consumer_sync(256);   // colsum is read before the next item writes it
  }
}

// Each expert's tiles in order, one warp per expert (grid E): tiles[e *
// ntiles + i] is the i-th tile t with emap[t] == e, tiles[E * ntiles +
// e] their count, so that a weight-gradient CTA reads its expert's
// tiles without scanning emap.
__global__ void __launch_bounds__(32)
    expert_tiles_kernel(const int* __restrict__ emap, int ntiles, int E,
                        int* __restrict__ tiles) {
  const int e = blockIdx.x, lane = threadIdx.x;
  int n = 0;
  for (int t0 = 0; t0 < ntiles; t0 += 32) {
    const int t = t0 + lane;
    const unsigned hit = __ballot_sync(0xffffffffu, t < ntiles && emap[t] == e);
    if ((hit >> lane) & 1)
      tiles[(long long)e * ntiles + n + __popc(hit & ((1u << lane) - 1u))] = t;
    n += __popc(hit);
  }
  if (lane == 0) tiles[(long long)E * ntiles + e] = n;
}

// The weight gradients, items (expert, 128-row block of M, 256-column
// block of N), the expert slowest: dw[e] = sum over expert e's tiles t,
// in order, of A_t^T . B_t with A [R, M] and B [R, N] (dw1: x and dsx;
// dw2: hx and dy), both MN-major operands (their K is the token row),
// the tiles from expert_tiles_kernel's lists.  One item per (expert,
// output tile): a fixed-order f32 sum with no atomics, written once in
// T; an expert that owns no tile writes zeros.
__global__ void __launch_bounds__(NT, 1)
    dw_kernel(const __grid_constant__ CUtensorMap ta,
              const __grid_constant__ CUtensorMap tb, const Args p) {
  constexpr int BN = kBN;
  constexpr uint32_t kStage = kATile + BN * 128;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* extra;
  const Ring r = ring_init(smem_raw, kStage, &extra);
  const int mblk = (p.M + 127) / 128, nblk = (p.N + BN - 1) / BN;
  const int items = p.E * mblk * nblk;
  const int* counts = p.tiles + (long long)p.E * p.ntiles;
  if (threadIdx.x < 128) {
    reg_dealloc<kProducerRegs>();
    if (threadIdx.x < 32) {
      // the producer warp reads a tile list 32 entries at a time; lane 0
      // issues the copies
      const int lane = threadIdx.x;
      for (int w = blockIdx.x, i = 0; w < items; w += gridDim.x) {
        const int e = w / (mblk * nblk);
        const int m0 = w / nblk % mblk * 128, n0 = w % nblk * BN;
        const int* mine = p.tiles + (long long)e * p.ntiles;
        const int count = counts[e];
        for (int i0 = 0; i0 < count; i0 += 32) {
          const int tl = i0 + lane < count ? mine[i0 + lane] : 0;
          for (int u = 0; u < min(32, count - i0); ++u) {
            const int t = __shfl_sync(0xffffffffu, tl, u);
            if (lane == 0)
              for (int h = 0; h < 2; ++h, ++i)
                produce(r, i, [&](uint32_t st, uint32_t bar) {
                  const int k0 = t * 128 + h * BK;
                  mbar_expect_tx(bar, kStage);
#pragma unroll
                  for (int c = 0; c < 2; ++c)
                    tma_box(st + c * kPanel, &ta, bar, m0 + 64 * c, k0, 0,
                            0);
#pragma unroll
                  for (int c = 0; c < BN / 64; ++c)
                    tma_box(st + kATile + c * kPanel, &tb, bar, n0 + 64 * c,
                            k0, 0, 0);
                });
            __syncwarp();
          }
        }
      }
    }
    return;
  }
  reg_alloc<kConsumerRegs>();
  const int cw = (threadIdx.x - 128) >> 7;
  uint32_t* stage = stage_of(extra);
  for (int w = blockIdx.x, i = 0; w < items; w += gridDim.x) {
    const int e = w / (mblk * nblk);
    const int m0 = w / nblk % mblk * 128, n0 = w % nblk * BN;
    const int n = 2 * counts[e];
    float acc[BN / 2];
    zero(acc);
    consume(r, i, n, [&](int, uint32_t st) {
      mma_step<1, 1>(acc, st + cw * kPanel, st + kATile);
    });
    i += n;
    reg_fence(acc);
#pragma unroll
    for (int ch = 0; ch < BN / 64; ++ch) {
      uint32_t pk[8][2];
#pragma unroll
      for (int jj = 0; jj < 8; ++jj)
#pragma unroll
        for (int rr = 0; rr < 2; ++rr)
          pk[jj][rr] = pack_bf16(acc[4 * (8 * ch + jj) + 2 * rr],
                                 acc[4 * (8 * ch + jj) + 2 * rr + 1]);
      store_chunk(pk, stage, p.out + ((long long)e * p.M + m0) * p.N, p.N,
                  n0 + 64 * ch, p.N, p.M - m0);
    }
  }
}

// ------------------------------------------------------------ host side
// A bf16 [rows, cols] row-major matrix as flash_sm90's 4-D tensor map
// with unit head and batch dims (experts > 1: [experts, rows, cols], the
// expert the head index): boxes of 64 columns x box_rows rows, 128-byte
// swizzle, zero fill outside.
inline bool map(CUtensorMap* m, const void* ptr, int experts, int rows,
                int cols, int box_rows) {
  const long long plane = (long long)rows * cols;
  const long long st[3] = {plane * experts, plane, cols};
  return flash_sm90::tile_map(m, ptr, st, 1, experts, rows, box_rows, cols);
}

// Launch a persistent kernel over ``items`` work items: one CTA per SM
// (or per item, if fewer).
template <typename K, typename... A>
cudaError_t run(K kern, size_t smem, long long items, cudaStream_t st,
                const A&... args) {
  int dev, sms;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  if (items <= 0) return cudaSuccess;
  kern<<<(unsigned)(items < sms ? items : sms), NT, smem, st>>>(args...);
  return cudaGetLastError();
}

constexpr size_t kRowsSmem = ring_smem(kATile + kBN * 128, kStagingBytes);
// backward pass 1: its ring, the staging areas, then the column sums [8
// warps][NB * BN]
constexpr size_t kActSmem =
    ring_smem(kATile + 2 * kPanel, kStagingBytes + 8 * 128 * 4);
template <bool GATED>
constexpr size_t fwd_act_smem() {
  return ring_smem(kATile + (GATED ? 2 : 1) * kFwdBN<GATED> * 128,
                   kStagingBytes);
}
static_assert(fwd_act_smem<true>() <= 232448 && kRowsSmem <= 232448,
              "227 KB of shared memory");

template <bool GATED>
cudaError_t fwd(int b1dt, int b2dt, const void* x, const void* w1,
                const void* b1, const void* w2, const void* b2,
                const int* emap, void* h, void* out, int R, int D, int F,
                int Dout, int E, cudaStream_t st) {
  const int F2 = GATED ? 2 * F : F, nt = R / TILE;
  CUtensorMap tx, tw1, th, tw2;
  if (!map(&tx, x, 1, R, D, 128) || !map(&tw1, w1, E, D, F2, 64) ||
      !map(&th, h, 1, R, F, 128) || !map(&tw2, w2, E, F, Dout, 64))
    return cudaErrorInvalidValue;
  Args p{emap, nt, b1, b2, b1dt, b2dt, static_cast<bf16*>(h), nullptr,
         nullptr, nullptr, nullptr, D, F, Dout, E, 0, 0};
  cudaError_t err = run(fwd_act_kernel<GATED>, fwd_act_smem<GATED>(),
                        (long long)nt * ((F + kFwdBN<GATED> - 1) /
                                         kFwdBN<GATED>),
                        st, tx, tw1, p);
  if (err != cudaSuccess) return err;
  p.out = static_cast<bf16*>(out);
  return run(rows_kernel<false>, kRowsSmem,
             (long long)nt * ((Dout + kBN - 1) / kBN), st, th, tw2, p, Dout,
             F);
}

template <bool GATED>
cudaError_t bwd(int b1dt, int b2dt, const void* x, const void* dy,
                const void* w1, const void* b1, const void* w2,
                const int* emap, void* dsx, void* hx, float* db1_part,
                float* db2_part, int* tiles, void* dx, void* dw1, void* dw2,
                void* db1, void* db2, int R, int D, int F, int Dout, int E,
                cudaStream_t st) {
  const int F2 = GATED ? 2 * F : F, nt = R / TILE;
  constexpr int BN = kActBN<GATED>;
  CUtensorMap ta, tb, tc, td;
  if (!map(&ta, x, 1, R, D, 128) || !map(&tb, w1, E, D, F2, 64) ||
      !map(&tc, dy, 1, R, Dout, 128) || !map(&td, w2, E, F, Dout, BN))
    return cudaErrorInvalidValue;
  Args p{emap, nt, b1, nullptr, b1dt, b2dt, nullptr, static_cast<bf16*>(hx),
         static_cast<bf16*>(dsx), db1_part, tiles, D, F, Dout, E, 0, 0};
  cudaError_t err = run(bwd_act_kernel<GATED>, kActSmem,
                        (long long)nt * ((F + BN - 1) / BN), st, ta, tb, tc,
                        td, p);
  if (err != cudaSuccess) return err;
  expert_tiles_kernel<<<E, 32, 0, st>>>(emap, nt, E, tiles);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  // dx = dsx . w1[e]^T: w1[e] as [D, F2] rows (K-major B)
  if (!map(&ta, dsx, 1, R, F2, 128) || !map(&tb, w1, E, D, F2, kBN))
    return cudaErrorInvalidValue;
  p.out = static_cast<bf16*>(dx);
  err = run(rows_kernel<true>, kRowsSmem,
            (long long)nt * ((D + kBN - 1) / kBN), st, ta, tb, p, D, F2);
  if (err != cudaSuccess) return err;
  // dw1 = x^T dsx and dw2 = hx^T dy per expert
  if (!map(&ta, x, 1, R, D, 64) || !map(&tb, dsx, 1, R, F2, 64))
    return cudaErrorInvalidValue;
  p.out = static_cast<bf16*>(dw1);
  p.M = D;
  p.N = F2;
  err = run(dw_kernel, kRowsSmem,
            (long long)E * ((D + 127) / 128) * ((F2 + kBN - 1) / kBN), st, ta,
            tb, p);
  if (err != cudaSuccess) return err;
  if (!map(&ta, hx, 1, R, F, 64) || !map(&tb, dy, 1, R, Dout, 64))
    return cudaErrorInvalidValue;
  p.out = static_cast<bf16*>(dw2);
  p.M = F;
  p.N = Dout;
  err = run(dw_kernel, kRowsSmem,
            (long long)E * ((F + 127) / 128) * ((Dout + kBN - 1) / kBN), st,
            ta, tb, p);
  if (err != cudaSuccess) return err;
  return bias_grads(db1_part, static_cast<const bf16*>(dy), db2_part, emap,
                    db1, db2, b1dt, b2dt, F2, Dout, E, nt, st);
}

}  // namespace sm90

}  // namespace

extern "C" {

// dtype / b1dt / b2dt: 0 = float32, 1 = bfloat16.  x [R, D], w1 [E, D,
// F2], b1 [E, F2], w2 [E, F, D'], b2 [E, D'] (F2 = 2F when gated, else
// F), emap [R / 128] int32, h [R, F] scratch and out [R, D'] in dtype;
// all contiguous and 16-byte aligned, R % 128 == 0, D, F, D' multiples
// of 8.  Returns a cudaError_t (0 on success).
int grouped_ffn_fwd(int dtype, int b1dt, int b2dt, int gated, const void* x,
                    const void* w1, const void* b1, const void* w2,
                    const void* b2, const void* emap, void* h, void* out,
                    int R, int D, int F, int Dout, int E, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (R % TILE || D % 8 || F % 8 || Dout % 8 || E < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int* em = static_cast<const int*>(emap);
  cudaError_t err;
  if (dtype == 0)
    err = fwd<float>(b1dt, b2dt, gated, x, w1, b1, w2, b2, em, h, out, R, D,
                     F, Dout, st);
  else if (dtype == 1)
    err = (gated ? sm90::fwd<true> : sm90::fwd<false>)(
        b1dt, b2dt, x, w1, b1, w2, b2, em, h, out, R, D, F, Dout, E, st);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}

// As above, plus dy [R, D'] in dtype; scratch dsx [R, F2] and hx [R, F]
// in dtype, db1_part [R / 128, F2] and db2_part [R / 128, D'] float32,
// tiles int32 [E * R / 128 + E] (each expert's tile list, then the
// counts); outputs dx [R, D], dw1, dw2 in dtype, db1 in b1dt, db2 in b2dt
// (the primals' shapes).
int grouped_ffn_bwd(int dtype, int b1dt, int b2dt, int gated, const void* x,
                    const void* dy, const void* w1, const void* b1,
                    const void* w2, const void* emap, void* dsx, void* hx,
                    void* db1_part, void* db2_part, void* tiles, void* dx,
                    void* dw1, void* dw2, void* db1, void* db2, int R, int D,
                    int F, int Dout, int E, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (R % TILE || D % 8 || F % 8 || Dout % 8 || E < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int* em = static_cast<const int*>(emap);
  float* part1 = static_cast<float*>(db1_part);
  float* part2 = static_cast<float*>(db2_part);
  cudaError_t err;
  if (dtype == 0)
    err = bwd<float>(b1dt, b2dt, gated, x, dy, w1, b1, w2, em, dsx, hx, part1,
                     part2, dx, dw1, dw2, db1, db2, R, D, F, Dout, E, st);
  else if (dtype == 1)
    err = (gated ? sm90::bwd<true> : sm90::bwd<false>)(
        b1dt, b2dt, x, dy, w1, b1, w2, em, dsx, hx, part1, part2,
        static_cast<int*>(tiles), dx, dw1, dw2, db1, db2, R, D, F, Dout, E,
        st);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}

const char* grouped_ffn_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
