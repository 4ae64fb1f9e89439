// Batched gather-LoRA matmul for Hopper (sm_90a).
//
// Replaces: paddle_tpu/ops/pallas/lora_matmul.py:_pallas_gather_matmul
// (body _lora_kernel, the K5 TPU kernel).  Each slot s applies its own
// adapter, bank row idx[s]:
//     out[s] = (x[s] @ A[idx[s]]^T) @ B[idx[s]] * scale[idx[s]]
// with x [S, K] (bf16 or f32), banks A [N, r, K] and B [N, r, M] (f32
// or bf16), scale [N] f32, idx [S] int32, out [S, M] in x's dtype.
// Numerics follow the Pallas body: h = x[s] A^T accumulates in f32 and
// is rounded to the bank's dtype before the second product (:60; a
// no-op for the serving runner's f32 bank), the second product
// accumulates in f32, is multiplied by the scale and cast once.  Bank
// row 0 is the all-zero "no adapter" row by convention; it is not
// special-cased here: zeros give zeros by arithmetic.  idx is not
// range-checked (that would cost a host sync): the caller passes rows
// of the bank.
//
// What bounds it on the H100: bytes.  A call reads x, the distinct bank
// rows idx names (r * (K + M) elements each) and writes out; ~2 FMAs
// per bank element read.
//
// The simple design:
//   * grid (slot, 256-column block of M).  Each CTA loads its idx[s]
//     itself (the TPU kernel's scalar prefetch has no counterpart) and
//     recomputes the r-vector h = x[s] A[idx]^T: r * K MACs per CTA,
//     one warp per row of h, lanes striding over K with 8 independent
//     partial sums (loads in flight, not one latency-bound chain), a
//     shuffle sum.
//     With S = 8 decode slots one CTA per slot would be 8 CTAs on 132
//     SMs; the column blocks give S * M / 256 of them, at the price of
//     re-reading A[idx] (from L2) in every CTA of a slot.
//   * h lives in shared memory; each thread then owns one output
//     column: r FMAs down the column of B[idx] (coalesced across the
//     block), times scale[idx], cast.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBM = kThreads;   // output columns per CTA
constexpr int kMaxRank = 64;
constexpr int kUnroll = 8;      // loads in flight per lane in the shrink

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

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Grid (S, ceil(M / kBM)), block kThreads.
template <typename TX, typename TB>
__global__ void __launch_bounds__(kThreads) lora_gather_kernel(
    const TX* __restrict__ x, const TB* __restrict__ a,
    const TB* __restrict__ b, const float* __restrict__ scale,
    const int* __restrict__ idx, TX* __restrict__ out, int K, int R,
    int M) {
  __shared__ float h_s[kMaxRank];
  const int s = blockIdx.x;
  const int row = idx[s];
  const int t = threadIdx.x, lane = t % 32, warp = t / 32;
  const TX* xr = x + (size_t)s * K;
  const TB* ar = a + (size_t)row * R * K;
  for (int j = warp; j < R; j += kThreads / 32) {
    const TB* aj = ar + (size_t)j * K;
    // kUnroll independent partial sums keep kUnroll loads of x and A in
    // flight per lane (one chain would wait out each load's latency)
    float part[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) part[u] = 0.f;
    int k = lane;
    for (; k + 32 * (kUnroll - 1) < K; k += 32 * kUnroll) {
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
        part[u] = fmaf(to_f(xr[k + 32 * u]), to_f(aj[k + 32 * u]),
                       part[u]);
    }
    for (; k < K; k += 32) part[0] = fmaf(to_f(xr[k]), to_f(aj[k]), part[0]);
    float acc = 0.f;
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) acc += part[u];
    acc = warp_sum(acc);
    // round h to the bank's dtype, as the Pallas body does
    if (lane == 0) h_s[j] = to_f(from_f<TB>(acc));
  }
  __syncthreads();
  const int c = blockIdx.y * kBM + t;
  if (c >= M) return;
  const TB* br = b + (size_t)row * R * M + c;
  float acc = 0.f;
#pragma unroll 4
  for (int j = 0; j < R; ++j)
    acc = fmaf(h_s[j], to_f(br[(size_t)j * M]), acc);
  out[(size_t)s * M + c] = from_f<TX>(acc * scale[row]);
}

template <typename TX, typename TB>
cudaError_t launch(const void* x, const void* a, const void* b,
                   const void* scale, const void* idx, void* out, int S,
                   int K, int R, int M, cudaStream_t stream) {
  dim3 grid(S, (M + kBM - 1) / kBM);
  lora_gather_kernel<TX, TB><<<grid, kThreads, 0, stream>>>(
      static_cast<const TX*>(x), static_cast<const TB*>(a),
      static_cast<const TB*>(b), static_cast<const float*>(scale),
      static_cast<const int*>(idx), static_cast<TX*>(out), K, R, M);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// xdtype / bdtype: 0 = float32, 1 = bfloat16.  x [S, K], a [N, r, K],
// b [N, r, M], scale [N] f32, idx [S] int32 in [0, N), out [S, M]; all
// contiguous; r <= 64.  Returns a cudaError_t (0 on success).
int lora_gather_fwd(int xdtype, int bdtype, const void* x, const void* a,
                    const void* b, const void* scale, const void* idx,
                    void* out, int S, int K, int R, int M, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (R < 1 || R > kMaxRank) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err;
  if (xdtype == 0 && bdtype == 0)
    err = launch<float, float>(x, a, b, scale, idx, out, S, K, R, M, st);
  else if (xdtype == 0 && bdtype == 1)
    err = launch<float, __nv_bfloat16>(x, a, b, scale, idx, out, S, K, R, M,
                                       st);
  else if (xdtype == 1 && bdtype == 0)
    err = launch<__nv_bfloat16, float>(x, a, b, scale, idx, out, S, K, R, M,
                                       st);
  else if (xdtype == 1 && bdtype == 1)
    err = launch<__nv_bfloat16, __nv_bfloat16>(x, a, b, scale, idx, out, S,
                                               K, R, M, st);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}

const char* lora_matmul_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
