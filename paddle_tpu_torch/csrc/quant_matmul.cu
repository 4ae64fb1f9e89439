// Weight-only int8 / int4 GEMV for Hopper (sm_90a).
//
// Replaces: paddle_tpu/ops/pallas/quant_matmul.py:_pallas_int8 and
// _pallas_int4 (bodies _int8_kernel / _int4_kernel, the K4 TPU kernel).
// out[M, N] = (x[M, K] @ w[K, N]) * scale[N] in x's dtype, for decode
// shapes (M <= 64).  w is int8 [K, N], or int4 nibble-packed [K/2, N]:
// the low nibble of packed row i holds K row 2i, the high nibble K row
// 2i + 1, sign-extended as _int4_kernel does (high = byte >> 4 on the
// sign-extended byte, low = ((byte & 15) ^ 8) - 8).  Numerics follow
// the Pallas body (quant_matmul.py:96-101): the int8 or int4 values
// are widened to bf16, where they are exact, and a bf16 dot with x
// accumulates in f32 (up to summation order); the accumulator is
// multiplied by scale[n] and cast once to x's dtype.
//
// What bounds it on the H100: bytes.  Each weight byte is read once
// and used by M rows; at M = 8 that is 16 (int8) or 32 (int4) flops per
// byte, far below the ~295 flop/byte ridge, so the floor is K * N bytes
// (int8) or K * N / 2 (int4) over 3.35 TB/s.  On the CUDA cores the M
// FMAs per weight alone come to the floor's issue rate at M = 8; on the
// tensor cores a weight costs only its widening (about 2.8 instructions
// for int8, 1.6 for int4), whatever M is.
//
// The bf16 kernel (wo_mma_kernel):
//   * the weights are the A operand of mma.sync.m16n8k16 (bf16 in, f32
//     accumulate) and x the B operand: x's M rows are the mma's N of 8
//     (M padded to 8, 16, 32 or 64), so each widened weight feeds every
//     8-row tile of x;
//   * CTA = 4 warps = 128 columns of w; a split of the K rows (grid.y)
//     streams through a 4-stage cp.async ring, each stage 64 q rows of
//     the CTA's columns (int8: 64 K rows, int4: 128) and x's matching
//     columns.  Staged q rows are 144 (int8) or 160 (int4) bytes apart
//     and x rows 16 bytes longer than their data, so the fragment reads
//     below touch 32 different banks;
//   * the mma's k order and row order are permuted so that each thread
//     reads whole 4-byte words of q: lane (g, t) owns columns 4g .. 4g
//     + 3 of its warp's 32 (its A rows g and g + 8 of two 16-row tiles)
//     and K rows 2t, 2t + 1, 2t + 8, 2t + 9 of each k16 step (int4:
//     packed rows t and t + 4, whose nibbles are those K rows), x's B
//     fragment the same K rows, so x stays in its own order;
//   * widening in registers: int8 by the exponent trick (PRMT puts the
//     biased byte under the exponent of 2^23, one FADD takes the bias
//     off, the upper halves of two exact floats are their bf16 pair);
//     int4 straight to bf16 (PRMT brings a byte's two nibbles to the
//     two halves, one LOP3 masks them under the exponent of 2^7 with
//     the sign bias, one HSUB2 takes 136 off: 128 + (v + 8) - 136 = v);
//   * split K: the wrapper splits the K rows until the grid holds about
//     two CTAs per SM (the k/v projections have N = 1024, 8 column
//     blocks), but no further than keeps the partial sums' traffic
//     within half the weight bytes.  With one split each CTA writes the
//     output; with more,
//     each writes its f32 partial sums [split, M, N] and takes a ticket
//     from its column block's counter, and the CTA that takes the last
//     one sums the splits in split order, applies the scale, casts and
//     resets the counter for the next launch (one launch, no float
//     atomics: reruns give the same bits).
//
// The float32 path (the card-vs-CPU parity runs) keeps the CUDA-core
// body (wo_gemv_kernel):
//   * CTA = 256 threads = 16 along N x 16 along K.  A thread owns 8
//     columns and loads them as one 8-byte word per q row (16 threads
//     cover one 128-byte row segment), so the CTA's column block is
//     128 wide and each q byte is loaded once.
//   * x rows are staged in shared memory as f32, 8 rows per CTA (grid
//     z covers M in 8-row tiles; each tile re-reads q, from L2 when the
//     tiles run together).
//   * int -> f32 without the slow conversion unit: PRMT places the
//     biased byte (or nibble) under the exponent of 2^23 and one FADD
//     takes the bias off.
//   * Split K as above, but each split writes its f32 partial sums and
//     a second pass sums the splits in order, applies the scale and
//     casts.  The 16 K-threads of a column reduce through a shuffle and
//     shared memory at the end of the CTA.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "warp_mma.cuh"

namespace {

// 4 unsigned bytes u (each value + bias) -> 4 floats minus the bias:
// byte i becomes the low mantissa byte of 2^23 (0x4B000000).
__device__ __forceinline__ void bytes_to_f(uint32_t u, float bias,
                                           float* f) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
    f[i] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540 + i)) - bias;
}

// ------------------------------------------------------ the bf16 kernel
constexpr int kMmaThreads = 128;    // 4 warps, 32 columns each
constexpr int kMmaBN = 128;         // columns per CTA
constexpr int kQRows = 64;          // q rows per ring stage
constexpr int kQStages = 4;         // ring depth

// One ring stage: q [kQRows rows][128 bytes] at a kWStride-byte row
// stride, then x [8 * MT rows][kK bf16] at kXStride.
template <bool kInt4, int MT>
struct QSmem {
  static constexpr int kK = kInt4 ? 2 * kQRows : kQRows;  // K per stage
  static constexpr int kWStride = kInt4 ? 160 : 144;
  static constexpr int kXStride = kK * 2 + 16;
  static constexpr int kW = kQRows * kWStride;
  static constexpr int kStage = kW + 8 * MT * kXStride;
  static constexpr int kBytes = kQStages * kStage;
};

// the upper halves of two exact floats (integers of magnitude < 256):
// their bf16 pair {lo, hi}
__device__ __forceinline__ uint32_t bf16_pair(float lo, float hi) {
  return __byte_perm(__float_as_uint(lo), __float_as_uint(hi), 0x7632);
}

// byte I of a packed int4 word p (ps = p >> 4) -> the bf16 pair {low
// nibble, high nibble}: 0x4300 | (n ^ 8) is 128 + (v + 8) in bf16
template <int I>
__device__ __forceinline__ uint32_t nibbles_bf16(uint32_t p, uint32_t ps) {
  constexpr uint32_t kSel = I | (I << 4) | ((4 + I) << 8) | ((4 + I) << 12);
  uint32_t v = (__byte_perm(p, ps, kSel) & 0x000F000Fu) ^ 0x43084308u;
  const uint32_t k136 = 0x43084308u;          // {136, 136}
  __nv_bfloat162 h =
      __hsub2(*reinterpret_cast<__nv_bfloat162*>(&v),
              *reinterpret_cast<const __nv_bfloat162*>(&k136));
  return *reinterpret_cast<uint32_t*>(&h);
}

__device__ __forceinline__ void store_bf16x4(__nv_bfloat16* p, float a,
                                             float b, float c, float d) {
  *reinterpret_cast<uint2*>(p) = make_uint2(pack_bf16(a, b), pack_bf16(c, d));
}

// Grid (N / 128, splits), kMmaThreads threads.  x [M, K] bf16 (K a
// multiple of 8, zero past the logical K); q int8 [rows, N] (rows = the
// logical K, or K/2 packed for int4); scale [N] f32; out [M, N].  With
// splits > 1: ws [splits, M, N] f32 partial sums, tickets [N / 128]
// int32 zeroed before the first launch (each launch leaves them zero).
// Split y covers q rows [y * rows_per_split, +rows_per_split), a
// multiple of kQRows.
template <bool kInt4, int MT>
__global__ void __launch_bounds__(kMmaThreads) wo_mma_kernel(
    const __nv_bfloat16* __restrict__ x, const int8_t* __restrict__ q,
    const float* __restrict__ scale, __nv_bfloat16* __restrict__ out,
    float* __restrict__ ws, int* __restrict__ tickets, int M, int K,
    int rows, int N, int rows_per_split) {
  using S = QSmem<kInt4, MT>;
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ int last;
  const uint32_t sbase = smem_u32(smem);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int n0 = blockIdx.x * kMmaBN;
  const int split = blockIdx.y, n_split = gridDim.y;
  const int r_begin = split * rows_per_split;
  const int r_end = min(rows, r_begin + rows_per_split);
  const int k_end = kInt4 ? 2 * r_end : r_end;
  const int nst = (r_end - r_begin + kQRows - 1) / kQRows;

  // stage s: q rows and x columns past the split zero-filled, unread
  const auto load_stage = [&](int s) {
    const int rb = r_begin + s * kQRows;
    const uint32_t wst = sbase + (s % kQStages) * S::kStage;
    const uint32_t xst = wst + S::kW;
#pragma unroll
    for (int e = tid; e < kQRows * 8; e += kMmaThreads) {
      const int r = e >> 3, c = e & 7;
      const bool ok = rb + r < r_end;
      cp16(wst + r * S::kWStride + c * 16,
           q + (size_t)(ok ? rb + r : r_begin) * N + n0 + c * 16, ok);
    }
    constexpr int kXC = S::kK / 8;            // 16-byte chunks of x a row
    const int kb = kInt4 ? 2 * rb : rb;
#pragma unroll
    for (int e = tid; e < 8 * MT * kXC; e += kMmaThreads) {
      const int m = e / kXC, c = e % kXC;
      const bool ok = m < M && kb + c * 8 < k_end;
      cp16(xst + m * S::kXStride + c * 16,
           x + (ok ? (size_t)m * K + kb + c * 8 : 0), ok);
    }
  };

  float acc[MT][2][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][j][e] = 0.f;

#pragma unroll
  for (int s = 0; s < kQStages - 1; ++s) {
    if (s < nst) load_stage(s);
    cp_commit();
  }
  const int wcol = warp * 32 + 4 * g;       // the thread's 4 columns
  for (int s = 0; s < nst; ++s) {
    cp_wait<kQStages - 2>();                // stage s's copies (own)
    __syncthreads();                        // everyone's; stage s - 1 done
    if (s + kQStages - 1 < nst) load_stage(s + kQStages - 1);
    cp_commit();
    const unsigned char* wsm = smem + (s % kQStages) * S::kStage;
    const unsigned char* xsm = wsm + S::kW;
#pragma unroll
    for (int kk = 0; kk < S::kK / 16; ++kk) {
      // A fragments of two 16-column tiles: tile j's rows g and g + 8
      // are columns 4g + 2j and 4g + 2j + 1; a[j][0..3] hold K rows
      // {2t, 2t+1} and {2t+8, 2t+9} of those rows
      uint32_t a[2][4];
      if constexpr (kInt4) {
        const uint32_t p0 = *reinterpret_cast<const uint32_t*>(
            wsm + (8 * kk + t) * S::kWStride + wcol);
        const uint32_t p1 = *reinterpret_cast<const uint32_t*>(
            wsm + (8 * kk + t + 4) * S::kWStride + wcol);
        const uint32_t s0 = p0 >> 4, s1 = p1 >> 4;
        a[0][0] = nibbles_bf16<0>(p0, s0);
        a[0][1] = nibbles_bf16<1>(p0, s0);
        a[1][0] = nibbles_bf16<2>(p0, s0);
        a[1][1] = nibbles_bf16<3>(p0, s0);
        a[0][2] = nibbles_bf16<0>(p1, s1);
        a[0][3] = nibbles_bf16<1>(p1, s1);
        a[1][2] = nibbles_bf16<2>(p1, s1);
        a[1][3] = nibbles_bf16<3>(p1, s1);
      } else {
        float f[4][4];                      // K rows 2t, 2t+1, 2t+8, 2t+9
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int row = 16 * kk + 2 * t + (r & 1) + 8 * (r >> 1);
          const uint32_t w = *reinterpret_cast<const uint32_t*>(
              wsm + row * S::kWStride + wcol);
          bytes_to_f(w ^ 0x80808080u, 8388736.f, f[r]);
        }
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          a[j][0] = bf16_pair(f[0][2 * j], f[1][2 * j]);
          a[j][1] = bf16_pair(f[0][2 * j + 1], f[1][2 * j + 1]);
          a[j][2] = bf16_pair(f[2][2 * j], f[3][2 * j]);
          a[j][3] = bf16_pair(f[2][2 * j + 1], f[3][2 * j + 1]);
        }
      }
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const unsigned char* xr =
            xsm + (8 * mt + g) * S::kXStride + (16 * kk + 2 * t) * 2;
        const uint32_t b0 = *reinterpret_cast<const uint32_t*>(xr);
        const uint32_t b1 = *reinterpret_cast<const uint32_t*>(xr + 16);
        mma16816(acc[mt][0], a[0], b0, b1);
        mma16816(acc[mt][1], a[1], b0, b1);
      }
    }
  }
  cp_wait<0>();

  // accumulator (tile j, e): column 4g + 2j + (e >> 1), row 2t + (e & 1)
  // of the 8-row tile mt
  const int n = n0 + wcol;
  const float4 sc = *reinterpret_cast<const float4*>(scale + n);
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = 8 * mt + 2 * t + h;
      if (m >= M) continue;
      const float v0 = acc[mt][0][h], v1 = acc[mt][0][2 + h];
      const float v2 = acc[mt][1][h], v3 = acc[mt][1][2 + h];
      if (n_split == 1)
        store_bf16x4(out + (size_t)m * N + n, v0 * sc.x, v1 * sc.y,
                     v2 * sc.z, v3 * sc.w);
      else
        *reinterpret_cast<float4*>(ws + ((size_t)split * M + m) * N + n) =
            make_float4(v0, v1, v2, v3);
    }
  if (n_split == 1) return;

  // the ticket: the last split of the column block sums them in order
  __threadfence();
  __syncthreads();
  if (tid == 0) last = atomicAdd(tickets + blockIdx.x, 1) == n_split - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  for (int e = tid; e < M * (kMmaBN / 4); e += kMmaThreads) {
    const int m = e / (kMmaBN / 4), c = n0 + 4 * (e % (kMmaBN / 4));
    float4 sum = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int sp = 0; sp < n_split; ++sp) {
      const float4 p = __ldcg(
          reinterpret_cast<const float4*>(ws + ((size_t)sp * M + m) * N + c));
      sum.x += p.x;
      sum.y += p.y;
      sum.z += p.z;
      sum.w += p.w;
    }
    const float4 s4 = *reinterpret_cast<const float4*>(scale + c);
    store_bf16x4(out + (size_t)m * N + c, sum.x * s4.x, sum.y * s4.y,
                 sum.z * s4.z, sum.w * s4.w);
  }
  if (tid == 0) tickets[blockIdx.x] = 0;    // ready for the next launch
}

template <bool kInt4, int MT>
cudaError_t launch_mma(const void* x, const void* q, const void* scale,
                       void* out, void* ws, void* tickets, int M, int K,
                       int rows, int N, int splits, int rows_per_split,
                       cudaStream_t stream) {
  constexpr int smem = QSmem<kInt4, MT>::kBytes;
  auto kern = wo_mma_kernel<kInt4, MT>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kern<<<dim3(N / kMmaBN, splits), kMmaThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const int8_t*>(q),
      static_cast<const float*>(scale), static_cast<__nv_bfloat16*>(out),
      static_cast<float*>(ws), static_cast<int*>(tickets), M, K, rows, N,
      rows_per_split);
  return cudaGetLastError();
}

template <bool kInt4>
cudaError_t launch_mma_m(const void* x, const void* q, const void* scale,
                         void* out, void* ws, void* tickets, int M, int K,
                         int rows, int N, int splits, int rows_per_split,
                         cudaStream_t s) {
  if (M <= 8)
    return launch_mma<kInt4, 1>(x, q, scale, out, ws, tickets, M, K, rows, N,
                                splits, rows_per_split, s);
  if (M <= 16)
    return launch_mma<kInt4, 2>(x, q, scale, out, ws, tickets, M, K, rows, N,
                                splits, rows_per_split, s);
  if (M <= 32)
    return launch_mma<kInt4, 4>(x, q, scale, out, ws, tickets, M, K, rows, N,
                                splits, rows_per_split, s);
  return launch_mma<kInt4, 8>(x, q, scale, out, ws, tickets, M, K, rows, N,
                              splits, rows_per_split, s);
}

// ------------------------------------------------------- the f32 kernel
constexpr int kThreads = 256;
constexpr int kTN = 16;             // threads along N
constexpr int kTK = kThreads / kTN; // threads along K
constexpr int kCols = 8;            // columns per thread: one 8-byte load
constexpr int kBN = kTN * kCols;    // 128 columns per CTA
constexpr int kMT = 8;              // rows of x per CTA
constexpr int kKC = 256;            // q rows per staged x chunk
constexpr int kWarps = kThreads / 32;

// x [M, K]; q int8 [rows, N] (rows = K, or K/2 packed for int4);
// scale [N]; out [M, N] (splits == 1) or ws [splits, M, N] f32 partial
// sums.  Grid (N / kBN, splits, ceil(M / kMT)).
template <bool kInt4>
__global__ void __launch_bounds__(kThreads) wo_gemv_kernel(
    const float* __restrict__ x, const int8_t* __restrict__ q,
    const float* __restrict__ scale, float* __restrict__ out,
    float* __restrict__ ws, int M, int K, int N, int rows_per_split) {
  // the x chunk during the K loop, then the cross-warp reduction buffer
  __shared__ __align__(16) float smem[kWarps * kMT * kBN];
  constexpr int kXC = kInt4 ? 2 * kKC : kKC;  // x columns per chunk
  float* xs = smem;                            // [kMT][kXC]
  const int t = threadIdx.x;
  const int tn = t % kTN, tk = t / kTN;
  const int n0 = blockIdx.x * kBN + tn * kCols;
  const int m0 = blockIdx.z * kMT;
  const int rows = kInt4 ? K / 2 : K;
  const int r_begin = blockIdx.y * rows_per_split;
  const int r_end = min(rows, r_begin + rows_per_split);

  float acc[kMT][kCols];
#pragma unroll
  for (int m = 0; m < kMT; ++m)
#pragma unroll
    for (int j = 0; j < kCols; ++j) acc[m][j] = 0.f;

  for (int c0 = r_begin; c0 < r_end; c0 += kKC) {
    const int nrows = min(kKC, r_end - c0);
    const int xcols = kInt4 ? 2 * nrows : nrows;
    const int xk0 = kInt4 ? 2 * c0 : c0;
    __syncthreads();  // the previous chunk is consumed
    for (int i = t; i < kMT * xcols; i += kThreads) {
      const int m = i / xcols, kk = i % xcols;
      const int gm = m0 + m;
      xs[m * kXC + kk] = gm < M ? x[(size_t)gm * K + xk0 + kk] : 0.f;
    }
    __syncthreads();
    const int8_t* qp = q + (size_t)c0 * N + n0;
#pragma unroll 4
    for (int r = tk; r < nrows; r += kTK) {
      const uint2 w = __ldg(reinterpret_cast<const uint2*>(qp + (size_t)r * N));
      if (kInt4) {
        // nibbles + 8 are 0..15: the same bias trick, bias 2^23 + 8
        float lo[kCols], hi[kCols];
        const uint32_t l0 = (w.x & 0x0F0F0F0Fu) ^ 0x08080808u;
        const uint32_t l1 = (w.y & 0x0F0F0F0Fu) ^ 0x08080808u;
        const uint32_t h0 = ((w.x >> 4) & 0x0F0F0F0Fu) ^ 0x08080808u;
        const uint32_t h1 = ((w.y >> 4) & 0x0F0F0F0Fu) ^ 0x08080808u;
        bytes_to_f(l0, 8388616.f, lo);
        bytes_to_f(l1, 8388616.f, lo + 4);
        bytes_to_f(h0, 8388616.f, hi);
        bytes_to_f(h1, 8388616.f, hi + 4);
#pragma unroll
        for (int m = 0; m < kMT; ++m) {
          const float xe = xs[m * kXC + 2 * r];
          const float xo = xs[m * kXC + 2 * r + 1];
#pragma unroll
          for (int j = 0; j < kCols; ++j) {
            acc[m][j] = fmaf(xe, lo[j], acc[m][j]);
            acc[m][j] = fmaf(xo, hi[j], acc[m][j]);
          }
        }
      } else {
        // signed bytes ^ 0x80 are value + 128: bias 2^23 + 128
        float wf[kCols];
        bytes_to_f(w.x ^ 0x80808080u, 8388736.f, wf);
        bytes_to_f(w.y ^ 0x80808080u, 8388736.f, wf + 4);
#pragma unroll
        for (int m = 0; m < kMT; ++m) {
          const float xv = xs[m * kXC + r];
#pragma unroll
          for (int j = 0; j < kCols; ++j)
            acc[m][j] = fmaf(xv, wf[j], acc[m][j]);
        }
      }
    }
  }

  // reduce over the 16 K-threads of each column: lanes l and l ^ 16 of
  // a warp hold the same columns (tk = 2w, 2w + 1), then across warps
  __syncthreads();  // xs is dead; smem becomes red [kWarps][kMT][kBN]
  const int lane = t % 32, warp = t / 32;
#pragma unroll
  for (int m = 0; m < kMT; ++m)
#pragma unroll
    for (int j = 0; j < kCols; ++j)
      acc[m][j] += __shfl_xor_sync(0xffffffffu, acc[m][j], 16);
  if (lane < 16) {
#pragma unroll
    for (int m = 0; m < kMT; ++m)
#pragma unroll
      for (int j = 0; j < kCols; ++j)
        smem[(warp * kMT + m) * kBN + tn * kCols + j] = acc[m][j];
  }
  __syncthreads();
  for (int o = t; o < kMT * kBN; o += kThreads) {
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) s += smem[w * kMT * kBN + o];
    const int gm = m0 + o / kBN;
    const int n = blockIdx.x * kBN + o % kBN;
    if (gm < M) {
      if (ws != nullptr)
        ws[((size_t)blockIdx.y * M + gm) * N + n] = s;
      else
        out[(size_t)gm * N + n] = s * scale[n];
    }
  }
}

// out[i] = (sum over splits of ws[split, i]) * scale[i % N], in order.
__global__ void splitk_reduce_kernel(const float* __restrict__ ws,
                                     const float* __restrict__ scale,
                                     float* __restrict__ out, int M, int N,
                                     int splits) {
  const size_t total = (size_t)M * N;
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  float s = 0.f;
  for (int sp = 0; sp < splits; ++sp) s += ws[sp * total + i];
  out[i] = s * scale[i % N];
}

template <bool kInt4>
cudaError_t launch_f32(const void* x, const void* q, const void* scale,
                       void* out, void* ws, int M, int K, int N, int splits,
                       int rows_per_split, cudaStream_t stream) {
  dim3 grid(N / kBN, splits, (M + kMT - 1) / kMT);
  float* part = splits > 1 ? static_cast<float*>(ws) : nullptr;
  wo_gemv_kernel<kInt4><<<grid, kThreads, 0, stream>>>(
      static_cast<const float*>(x), static_cast<const int8_t*>(q),
      static_cast<const float*>(scale), static_cast<float*>(out), part, M, K,
      N, rows_per_split);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || part == nullptr) return err;
  const size_t total = (size_t)M * N;
  splitk_reduce_kernel<<<(unsigned)((total + 255) / 256), 256, 0, stream>>>(
      part, static_cast<const float*>(scale), static_cast<float*>(out), M, N,
      splits);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32 x/out, 1 = bfloat16.  int4: 0 = int8 q [rows = K,
// N], 1 = packed int4 q [rows = K/2, N] (K even).  N % 128 == 0, 1 <= M
// <= 64, all contiguous; q, scale and x 16-byte aligned.  K is x's row
// length: the logical K in float32; in bfloat16 a multiple of 8, x zero
// past the logical K.  ws: f32 [splits, M, N] scratch when splits > 1
// (else ignored); each split covers rows_per_split q rows (bfloat16: a
// multiple of 64).  tickets: bfloat16 with splits > 1, N / 128 int32
// counters, zero before the launch and left zero.  Returns a
// cudaError_t (0 on success).
int quant_matmul_fwd(int dtype, int int4, const void* x, const void* q,
                     const void* scale, void* out, void* ws, void* tickets,
                     int M, int K, int rows, int N, int splits,
                     int rows_per_split, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (M < 1 || M > 64 || N < 1 || N % kMmaBN || splits < 1 ||
      rows_per_split < 1 || (splits > 1 && !ws))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err;
  if (dtype == 0) {
    err = int4 ? launch_f32<true>(x, q, scale, out, ws, M, K, N, splits,
                                  rows_per_split, s)
               : launch_f32<false>(x, q, scale, out, ws, M, K, N, splits,
                                   rows_per_split, s);
  } else if (dtype == 1) {
    if (K % 8 || rows_per_split % kQRows || (splits > 1 && !tickets))
      return static_cast<int>(cudaErrorInvalidValue);
    err = int4 ? launch_mma_m<true>(x, q, scale, out, ws, tickets, M, K, rows,
                                    N, splits, rows_per_split, s)
               : launch_mma_m<false>(x, q, scale, out, ws, tickets, M, K,
                                     rows, N, splits, rows_per_split, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

const char* quant_matmul_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
