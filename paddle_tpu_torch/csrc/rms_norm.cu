// Row-wise RMSNorm for Hopper (sm_90a).
//
// Replaces: paddle_tpu/ops/pallas/rms_norm.py:_pallas_rms (body
// _rms_kernel, the K6 TPU kernel).  Per row of x [N, d]:
//     out = T((x * rsqrt(mean(x^2) + eps)) * w)
// with the statistics, the normalisation and the weight multiply in f32
// and one cast to x's dtype at the end.  x in float32, bfloat16 or
// float16; w [d] in any of the three.  The backward is closed form in
// plain PyTorch (it is not a kernel in the reference either).
//
// What bounds it on the H100: bytes.  A call reads x and writes out once
// (2 * N * d * sizeof(T)) plus w; ~4 flops per element.  At llama3_8b
// width (16,384 x 4096 bf16) that is 268 MB, 0.08 ms at 3.35 TB/s.
//
// The simple design: one CTA of 256 threads per row; each thread loads
// 16-byte vectors of the row and sums their squares in f32, a warp
// shuffle and a shared-memory step reduce the row, and a second sweep
// re-reads the row (from L1/L2, it was just read) to write the output.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT = 256;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f(__half x) { return __half2float(x); }
template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}
template <>
__device__ __forceinline__ __half from_f<__half>(float x) {
  return __float2half(x);
}

// Grid N, block NT; d is a multiple of 16 / sizeof(TX).
template <typename TX, typename TW>
__global__ void __launch_bounds__(NT)
    rms_kernel(const TX* __restrict__ x, const TW* __restrict__ w,
               TX* __restrict__ out, int d, float eps) {
  constexpr int kVec = 16 / sizeof(TX);
  __shared__ float red[NT / 32];
  __shared__ float rinv;
  const TX* xr = x + (long long)blockIdx.x * d;
  TX* orow = out + (long long)blockIdx.x * d;
  float ss = 0.f;
  for (int i = threadIdx.x * kVec; i < d; i += NT * kVec) {
    const uint4 raw = *reinterpret_cast<const uint4*>(xr + i);
    const TX* a = reinterpret_cast<const TX*>(&raw);
#pragma unroll
    for (int u = 0; u < kVec; ++u) {
      const float f = to_f(a[u]);
      ss = fmaf(f, f, ss);
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, o);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = ss;
  __syncthreads();
  if (threadIdx.x == 0) {
    float s = 0.f;
#pragma unroll
    for (int k = 0; k < NT / 32; ++k) s += red[k];
    rinv = 1.f / sqrtf(s / (float)d + eps);
  }
  __syncthreads();
  const float r = rinv;
  for (int i = threadIdx.x * kVec; i < d; i += NT * kVec) {
    const uint4 raw = *reinterpret_cast<const uint4*>(xr + i);
    const TX* a = reinterpret_cast<const TX*>(&raw);
    uint4 packed;
    TX* o = reinterpret_cast<TX*>(&packed);
#pragma unroll
    for (int u = 0; u < kVec; ++u)
      o[u] = from_f<TX>(to_f(a[u]) * r * to_f(w[i + u]));
    *reinterpret_cast<uint4*>(orow + i) = packed;
  }
}

template <typename TX>
cudaError_t launch_x(int wdt, const void* x, const void* w, void* out, int n,
                     int d, float eps, cudaStream_t st) {
  const TX* xt = static_cast<const TX*>(x);
  TX* ot = static_cast<TX*>(out);
  if (wdt == 0)
    rms_kernel<TX, float><<<n, NT, 0, st>>>(
        xt, static_cast<const float*>(w), ot, d, eps);
  else if (wdt == 1)
    rms_kernel<TX, __nv_bfloat16><<<n, NT, 0, st>>>(
        xt, static_cast<const __nv_bfloat16*>(w), ot, d, eps);
  else if (wdt == 2)
    rms_kernel<TX, __half><<<n, NT, 0, st>>>(
        xt, static_cast<const __half*>(w), ot, d, eps);
  else
    return cudaErrorInvalidValue;
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// xdt / wdt: 0 = float32, 1 = bfloat16, 2 = float16.  x [n, d] and out
// [n, d] in xdt, w [d] in wdt; contiguous, x and out 16-byte aligned, d a
// multiple of 8 (of 128 on the reference's kernel route).  Returns a
// cudaError_t (0 on success).
int rms_norm_fwd(int xdt, int wdt, const void* x, const void* w, void* out,
                 int n, int d, float eps, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (d % 8 || n < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err;
  if (xdt == 0)
    err = launch_x<float>(wdt, x, w, out, n, d, eps, st);
  else if (xdt == 1)
    err = launch_x<__nv_bfloat16>(wdt, x, w, out, n, d, eps, st);
  else if (xdt == 2)
    err = launch_x<__half>(wdt, x, w, out, n, d, eps, st);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}

const char* rms_norm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
