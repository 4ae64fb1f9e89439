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
// forward (0.10 ms at 989 TFLOP/s bf16) against 0.2 GB of bytes.
//
// The simple design, and what it leaves for later:
//   * every product is one block GEMM: 128 x BN output tiles, K in steps
//     of 32 (bf16) or 16 (f32) staged through shared memory by 16-byte
//     cp.async copies, two stages deep (the next step's tiles load while
//     this step's multiply); 8 warps, each a 32 x BN/2 strip;
//   * bf16 products run on the tensor cores through WMMA (16x16x16
//     mma.sync tiles) with f32 accumulators in registers; float32 runs on
//     CUDA-core FMA (no TF32), so card and CPU agree to f32 rounding;
//   * the TPU kernel keeps the [tile, F] intermediate on chip; here the
//     forward is two passes through an [R, F] scratch h in T, which is
//     bit-faithful because the reference rounds h to T right there;
//   * the TPU grid runs in order, so _bwd_kernel accumulates dw1, dw2,
//     db1 and db2 across an expert's consecutive tiles.  CUDA blocks run
//     in no order, so the reduction is rebuilt without float atomics, in
//     a fixed order: one CTA per (expert, output block) loops over the
//     expert's tiles (dw1, dw2); db1 sums per-tile column partials that
//     the activation pass writes, db2 sums dy, each one thread per
//     (expert, column) over the expert's tiles in order;
//   * empty padding rows and tiles are computed, not skipped; wgmma and
//     TMA are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include <type_traits>

namespace {

using namespace nvcuda;

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
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

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
struct Acc {  // float32: CUDA-core FMA
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

  // The lane's 8 values of piece (i, j); scratch is unused here.
  __device__ __forceinline__ void piece(int i, int j, float*, float* v) {
#pragma unroll
    for (int q = 0; q < 8; ++q) v[q] = c[i][j][q];
  }
};

template <int BN>
struct Acc<__nv_bfloat16, BN> {  // bfloat16: WMMA on the tensor cores
  using T = __nv_bfloat16;
  static constexpr int PJ = BN / 32;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> c[2][PJ];

  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < PJ; ++j) wmma::fill_fragment(c[i][j], 0.f);
  }

  template <bool AT, bool BT>
  __device__ __forceinline__ void mma(const T* a_s, const T* b_s) {
    constexpr int LA = ATile<T, AT>::LD;
    constexpr int LB = BTile<T, BT, BN>::LD;
    using LayA = std::conditional_t<AT, wmma::col_major, wmma::row_major>;
    using LayB = std::conditional_t<BT, wmma::col_major, wmma::row_major>;
    const int warp = threadIdx.x >> 5;
    const int wm = warp & 3, wn = warp >> 2;
    wmma::fragment<wmma::matrix_a, 16, 16, 16, T, LayA> fa[2];
    wmma::fragment<wmma::matrix_b, 16, 16, 16, T, LayB> fb;
#pragma unroll
    for (int kk = 0; kk < kBK<T>; kk += 16) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int m = wm * 32 + i * 16;
        wmma::load_matrix_sync(fa[i], AT ? a_s + kk * LA + m
                                         : a_s + m * LA + kk, LA);
      }
#pragma unroll
      for (int j = 0; j < PJ; ++j) {
        const int n = wn * (BN / 2) + j * 16;
        wmma::load_matrix_sync(fb, BT ? b_s + n * LB + kk
                                      : b_s + kk * LB + n, LB);
#pragma unroll
        for (int i = 0; i < 2; ++i) wmma::mma_sync(c[i][j], fa[i], fb, c[i][j]);
      }
    }
  }

  // The lane's 8 values of piece (i, j), through the warp's 16 x 16
  // float scratch.
  __device__ __forceinline__ void piece(int i, int j, float* scratch,
                                        float* v) {
    const int lane = threadIdx.x & 31;
    wmma::store_matrix_sync(scratch, c[i][j], 16, wmma::mem_row_major);
    __syncwarp();
#pragma unroll
    for (int q = 0; q < 8; ++q)
      v[q] = scratch[(lane >> 1) * 16 + (lane & 1) * 8 + q];
    __syncwarp();
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

  float* scratch = reinterpret_cast<float*>(smem) +
                   (threadIdx.x >> 5) * 256 * NB;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < Acc<T, BN>::PJ; ++j) {
      float v[8], g[8];
      acc[0].piece(i, j, scratch, v);
      if constexpr (GATED) acc[NB - 1].piece(i, j, scratch + 256, g);
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

  float* scratch = reinterpret_cast<float*>(smem) + (threadIdx.x >> 5) * 256;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < Acc<T, BN>::PJ; ++j) {
      float v[8];
      acc.piece(i, j, scratch, v);
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
  constexpr size_t kScratch = kIsBf16<T> ? (size_t)(NB + 1) * 8 * 256 * 4
                                         : 0;
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
  float* scratch = reinterpret_cast<float*>(smem) + warp * 256 * (NB + 1);
  float* colsum = reinterpret_cast<float*>(smem + kScratch);  // [4][NB*BN]
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
      acc_s[0].piece(i, j, scratch, sv);
      if constexpr (GATED) acc_s[NB - 1].piece(i, j, scratch + 256, gv);
      acc_dh.piece(i, j, scratch + 256 * NB, dh);
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
  __syncthreads();  // scratch and the shared tiles are done with
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

  float* scratch = reinterpret_cast<float*>(smem) + (threadIdx.x >> 5) * 256;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < Acc<T, BN>::PJ; ++j) {
      float v[8];
      acc.piece(i, j, scratch, v);
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

  float* scratch = reinterpret_cast<float*>(smem) + (threadIdx.x >> 5) * 256;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < Acc<T, BN>::PJ; ++j) {
      float v[8];
      acc.piece(i, j, scratch, v);
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

// grid (ceil(C / 256), E): out[e, c] = sum over expert e's tiles t, in
// order, of sum over the tile's rows_per_tile rows of src[row, c] (db2
// from dy, 128 rows a tile; db1 from db1_part, one row a tile).
template <typename TS>
__global__ void __launch_bounds__(256)
    colsum_kernel(const TS* __restrict__ src, int rows_per_tile, int C,
                  const int* __restrict__ emap, int ntiles,
                  void* __restrict__ out, int odt) {
  const int c = blockIdx.x * 256 + threadIdx.x;
  const int e = blockIdx.y;
  if (c >= C) return;
  float s = 0.f;
  for (int t = 0; t < ntiles; ++t) {
    if (emap[t] != e) continue;
    const TS* p = src + (long long)t * rows_per_tile * C + c;
    float ts = 0.f;
    for (int r = 0; r < rows_per_tile; ++r) ts += to_f(p[(long long)r * C]);
    s += ts;
  }
  store_any(out, (long long)e * C + c, s, odt);
}

// Dynamic shared bytes of each kernel: two pipeline stages, or the
// epilogue's scratch where that is larger.
template <typename T>
constexpr size_t scratch_bytes(int pieces) {
  return kIsBf16<T> ? (size_t)pieces * 8 * 256 * 4 : 0;
}
template <typename T, bool GATED>
constexpr size_t fwd_act_smem() {
  return cmax(2 * stage_bytes<T, false, false, 128, GATED ? 2 : 1>(),
              scratch_bytes<T>(GATED ? 2 : 1));
}
template <typename T>
constexpr size_t fwd_out_smem() {
  return cmax(2 * stage_bytes<T, false, false, 128, 1>(), scratch_bytes<T>(1));
}
template <typename T, bool GATED>
constexpr size_t bwd_act_smem() {
  constexpr int NB = GATED ? 2 : 1;
  return cmax(cmax(2 * stage_bytes<T, false, false, 64, NB>(),
                   2 * stage_bytes<T, false, true, 64, 1>()),
              scratch_bytes<T>(NB + 1) + (size_t)4 * NB * 64 * 4);
}
template <typename T>
constexpr size_t bwd_dx_smem() {
  return cmax(2 * stage_bytes<T, false, true, 128, 1>(), scratch_bytes<T>(1));
}
template <typename T>
constexpr size_t bwd_dw_smem() {
  return cmax(2 * stage_bytes<T, true, false, 128, 1>(), scratch_bytes<T>(1));
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
                void* dx, void* dw1, void* dw2, void* db1, void* db2, int R,
                int D, int F, int Dout, int E, cudaStream_t st) {
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
  colsum_kernel<float><<<dim3((F2 + 255) / 256, E), 256, 0, st>>>(
      db1_part, 1, F2, emap, nt, db1, b1dt);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  colsum_kernel<T><<<dim3((Dout + 255) / 256, E), 256, 0, st>>>(
      dyt, TILE, Dout, emap, nt, db2, b2dt);
  return cudaGetLastError();
}

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
    err = fwd<__nv_bfloat16>(b1dt, b2dt, gated, x, w1, b1, w2, b2, em, h,
                             out, R, D, F, Dout, st);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}

// As above, plus dy [R, D'] in dtype; scratch dsx [R, F2] and hx [R, F]
// in dtype, db1_part [R / 128, F2] float32; outputs dx [R, D], dw1, dw2
// in dtype, db1 in b1dt, db2 in b2dt (the primals' shapes).
int grouped_ffn_bwd(int dtype, int b1dt, int b2dt, int gated, const void* x,
                    const void* dy, const void* w1, const void* b1,
                    const void* w2, const void* emap, void* dsx, void* hx,
                    void* db1_part, void* dx, void* dw1, void* dw2,
                    void* db1, void* db2, int R, int D, int F, int Dout,
                    int E, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (R % TILE || D % 8 || F % 8 || Dout % 8 || E < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int* em = static_cast<const int*>(emap);
  float* part = static_cast<float*>(db1_part);
  cudaError_t err;
  if (dtype == 0)
    err = bwd<float>(b1dt, b2dt, gated, x, dy, w1, b1, w2, em, dsx, hx, part,
                     dx, dw1, dw2, db1, db2, R, D, F, Dout, E, st);
  else if (dtype == 1)
    err = bwd<__nv_bfloat16>(b1dt, b2dt, gated, x, dy, w1, b1, w2, em, dsx,
                             hx, part, dx, dw1, dw2, db1, db2, R, D, F, Dout,
                             E, st);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}

const char* grouped_ffn_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
