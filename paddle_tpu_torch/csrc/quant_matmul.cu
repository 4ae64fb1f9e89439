// Weight-only int8 / int4 GEMV for Hopper (sm_90a).
//
// Replaces: paddle_tpu/ops/pallas/quant_matmul.py:_pallas_int8 and
// _pallas_int4 (bodies _int8_kernel / _int4_kernel, the K4 TPU kernel).
// out[M, N] = (x[M, K] @ w[K, N]) * scale[N] in x's dtype, for decode
// shapes (M <= 64).  w is int8 [K, N], or int4 nibble-packed [K/2, N]:
// the low nibble of packed row i holds K row 2i, the high nibble K row
// 2i + 1.  Numerics follow the Pallas body: an int8 or int4 value is
// exact in f32, so converting it straight to f32 and running f32 FMAs
// with x gives the body's f32 accumulator (up to summation order); the
// accumulator is multiplied by scale[n] and cast once to x's dtype.
// int4 sign extension as in _int4_kernel: high = byte >> 4 on the
// sign-extended byte, low = ((byte & 15) ^ 8) - 8.
//
// What bounds it on the H100: bytes.  Each weight byte is read once
// and used by M rows; at M = 8 that is 8 (int8) or 16 (int4) FMAs per
// byte, so the floor is K * N bytes (int8) or K * N / 2 (int4) over
// 3.35 TB/s.  At M = 8 the f32 FMAs on the CUDA cores come close to
// that floor (int8) or past it (int4): the tensor cores (mma on
// weights converted to bf16) are the way to the byte floor, later.
//
// The simple design:
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
//   * Split K: the k/v projections of llama3_8b have N = 1024, only 8
//     column blocks for 132 SMs, so the wrapper splits K until a call
//     has >= 2 CTAs per SM.  Each split writes f32 partial sums
//     [split, M, N]; a second pass sums the splits in order, applies
//     the scale and casts (deterministic, no atomics).  With one split
//     the first pass writes the output itself.
//   * The 16 K-threads of a column reduce through a shuffle and shared
//     memory at the end of the CTA.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTN = 16;             // threads along N
constexpr int kTK = kThreads / kTN; // threads along K
constexpr int kCols = 8;            // columns per thread: one 8-byte load
constexpr int kBN = kTN * kCols;    // 128 columns per CTA
constexpr int kMT = 8;              // rows of x per CTA
constexpr int kKC = 256;            // q rows per staged x chunk
constexpr int kWarps = kThreads / 32;

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

// 4 unsigned bytes u (each value + bias) -> 4 floats minus the bias:
// byte i becomes the low mantissa byte of 2^23 (0x4B000000).
__device__ __forceinline__ void bytes_to_f(uint32_t u, float bias,
                                           float* f) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
    f[i] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540 + i)) - bias;
}

// x [M, K]; q int8 [rows, N] (rows = K, or K/2 packed for int4);
// scale [N]; out [M, N] (splits == 1) or ws [splits, M, N] f32 partial
// sums.  Grid (N / kBN, splits, ceil(M / kMT)).
template <typename T, bool kInt4>
__global__ void __launch_bounds__(kThreads) wo_gemv_kernel(
    const T* __restrict__ x, const int8_t* __restrict__ q,
    const float* __restrict__ scale, T* __restrict__ out,
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
      xs[m * kXC + kk] =
          gm < M ? to_f(x[(size_t)gm * K + xk0 + kk]) : 0.f;
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
        out[(size_t)gm * N + n] = from_f<T>(s * scale[n]);
    }
  }
}

// out[i] = (sum over splits of ws[split, i]) * scale[i % N], in order.
template <typename T>
__global__ void splitk_reduce_kernel(const float* __restrict__ ws,
                                     const float* __restrict__ scale,
                                     T* __restrict__ out, int M, int N,
                                     int splits) {
  const size_t total = (size_t)M * N;
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  float s = 0.f;
  for (int sp = 0; sp < splits; ++sp) s += ws[sp * total + i];
  out[i] = from_f<T>(s * scale[i % N]);
}

template <typename T, bool kInt4>
cudaError_t launch(const void* x, const void* q, const void* scale,
                   void* out, void* ws, int M, int K, int N, int splits,
                   int rows_per_split, cudaStream_t stream) {
  dim3 grid(N / kBN, splits, (M + kMT - 1) / kMT);
  float* part = splits > 1 ? static_cast<float*>(ws) : nullptr;
  wo_gemv_kernel<T, kInt4><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const int8_t*>(q),
      static_cast<const float*>(scale), static_cast<T*>(out), part, M, K,
      N, rows_per_split);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || part == nullptr) return err;
  const size_t total = (size_t)M * N;
  splitk_reduce_kernel<T><<<(unsigned)((total + 255) / 256), 256, 0,
                            stream>>>(part, static_cast<const float*>(scale),
                                      static_cast<T*>(out), M, N, splits);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32 x/out, 1 = bfloat16.  int4: 0 = int8 q [K, N],
// 1 = packed int4 q [K/2, N] (K even).  N % 128 == 0, M <= 64, all
// contiguous; q 16-byte aligned.  ws: f32 [splits, M, N] scratch when
// splits > 1 (else ignored); each split covers rows_per_split q rows.
// Returns a cudaError_t (0 on success).
int quant_matmul_fwd(int dtype, int int4, const void* x, const void* q,
                     const void* scale, void* out, void* ws, int M, int K,
                     int N, int splits, int rows_per_split, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0)
    err = int4 ? launch<float, true>(x, q, scale, out, ws, M, K, N, splits,
                                     rows_per_split, s)
               : launch<float, false>(x, q, scale, out, ws, M, K, N, splits,
                                      rows_per_split, s);
  else if (dtype == 1)
    err = int4 ? launch<__nv_bfloat16, true>(x, q, scale, out, ws, M, K, N,
                                             splits, rows_per_split, s)
               : launch<__nv_bfloat16, false>(x, q, scale, out, ws, M, K, N,
                                              splits, rows_per_split, s);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}

const char* quant_matmul_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
