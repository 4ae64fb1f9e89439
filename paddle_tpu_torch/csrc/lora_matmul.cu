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
// accumulates in f32 (j ascending), is multiplied by the scale and cast
// once.  Bank row 0 is the all-zero "no adapter" row by convention; it
// is not special-cased here: zeros give zeros by arithmetic.  idx is not
// range-checked (that would cost a host sync): the caller passes rows
// of the bank.
//
// What bounds it on the H100: bytes.  A call must read x, the distinct
// bank rows idx names (r * (K + M) elements each) once and write out;
// ~2 FMAs per bank byte of an f32 bank (4 of a bf16 one) when each
// adapter serves one or two slots, far below the CUDA cores' 67 TFLOP/s
// f32 rate, so both bank dtypes take CUDA-core FMAs on 16-byte (f32) or
// 8-byte (bf16) vector loads; mma.sync would need a bf16 bank and more
// slots per adapter than decode batches have.
//
// The design: two kernels, each spread over the card, each reading a
// distinct bank row once.
//   * Shrink, grid (splits, S).  CTA (c, s) works only if s is the first
//     slot that names its adapter u = idx[s] (the others return at
//     once: the grid is a function of shapes, so the wrapper never reads
//     idx on the host).  It reads rows A[u, :, chunk c] once and, for
//     every slot naming u, four at a time, the partial h over that K
//     chunk: warp w owns rank rows w, w + 8, ..., its lanes stride over
//     the chunk, and a shuffle sum ends each row.  The partials go to
//     part [splits, S, r] (f32), each element written by exactly one
//     CTA.  The split count is the wrapper's (a rule of shapes: about
//     two (split, slot) CTAs per SM, chunks of at least 256 elements).
//   * Expand, grid (ceil(M / 512), S).  CTA (b, s), again only for the
//     first slot of adapter u, sums the partials of u's slots over the
//     splits in split order (so reruns are bit-equal: no atomics),
//     rounds h to the bank's dtype into shared memory, then each thread
//     owns 4 columns of the 512-column block: it loads B[u, j, cols]
//     once per group of up to 8 slots of u and applies it to all of
//     them, times scale[u], cast.
// Each kernel starts its loads of the bank before the chain of
// dependent reads (idx, the slot list, the partials) ends, since at
// decode shapes each call is a few of these latencies long.  part lives
// in a per-stream scratch buffer of the wrapper, so a call allocates
// nothing but its output.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxRank = 64;
constexpr int kMaxRows = 64;       // slots S
constexpr int kShrinkThreads = 256;
constexpr int kG = 4;              // slots per pass over A's rows
constexpr int kExpandThreads = 128;
constexpr int kBM = 4 * kExpandThreads;  // output columns per expand CTA
constexpr int kEG = 8;             // slots per pass over B's columns

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

// Four consecutive elements as f32: one 16-byte (f32) or 8-byte (bf16)
// load; p is aligned to the vector.
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 v = *reinterpret_cast<const uint2*>(p);
  const float2 lo =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v.x));
  const float2 hi =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v.y));
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}
__device__ __forceinline__ void store4(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, const float (&v)[4]) {
  __nv_bfloat162 lo = __floats2bfloat162_rn(v[0], v[1]);
  __nv_bfloat162 hi = __floats2bfloat162_rn(v[2], v[3]);
  uint2 w;
  w.x = *reinterpret_cast<uint32_t*>(&lo);
  w.y = *reinterpret_cast<uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(p) = w;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// The slots that name slot s's adapter, in slot order, into list (shared
// memory); returns how many, or 0 where s is not the first of them (the
// CTA then has nothing to do).  Ends with a barrier.
__device__ __forceinline__ int adapter_slots(const int* idx, int S, int s,
                                             int* list, int* count) {
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    const int u = idx[s];
    const unsigned lo =
        __ballot_sync(0xffffffffu, lane < S && idx[lane] == u);
    const unsigned hi =
        __ballot_sync(0xffffffffu, lane + 32 < S && idx[lane + 32] == u);
    const int first = lo ? __ffs(lo) - 1 : 31 + __ffs(hi);
    const unsigned below = (1u << lane) - 1u;
    if (first == s) {
      if ((lo >> lane) & 1) list[__popc(lo & below)] = lane;
      if ((hi >> lane) & 1) list[__popc(lo) + __popc(hi & below)] = lane + 32;
    }
    if (lane == 0) *count = first == s ? __popc(lo) + __popc(hi) : 0;
  }
  __syncthreads();
  return *count;
}

// Four columns col.. of a bank row as f32: one vector load where
// ``full`` (the 4 columns lie below M and are aligned), else element
// loads with zeros past M.
template <typename TB>
__device__ __forceinline__ float4 load_cols(const TB* p, int col, int M,
                                            bool full) {
  if (full) return load4(p);
  float v[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) v[q] = col + q < M ? to_f(p[q]) : 0.f;
  return make_float4(v[0], v[1], v[2], v[3]);
}

// Grid (splits, S), block kShrinkThreads; RW = rank rows per warp
// (ceil(r / 8)).  part[c, s', j] = x[s', chunk c] . A[u, j, chunk c] for
// every slot s' of adapter u.  vec: K and chunk multiples of 4 and x, a
// aligned to their 4-element vectors.  Each lane requests kU 4-element
// vectors of each of its rows at once (the chunk in few rounds of
// loads), and A's first round goes out before the slot list is built.
template <typename TX, typename TB, int RW>
__global__ void __launch_bounds__(kShrinkThreads) lora_shrink_kernel(
    const TX* __restrict__ x, const TB* __restrict__ a,
    const int* __restrict__ idx, float* __restrict__ part, int S, int K,
    int R, int chunk, int vec) {
  constexpr int kU = RW <= 2 ? 4 : RW <= 4 ? 2 : 1;
  __shared__ int list[kMaxRows];
  __shared__ int count;
  const int c = blockIdx.x, s = blockIdx.y;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int k0 = c * chunk, k1 = min(K, k0 + chunk);
  const TB* ar = a + (size_t)idx[s] * R * K;
  float4 av[kU][RW];
  const auto load_a = [&](int k) {
#pragma unroll
    for (int q = 0; q < kU; ++q)
#pragma unroll
      for (int i = 0; i < RW; ++i) {
        const int j = warp + 8 * i, kq = k + 128 * q;
        av[q][i] = j < R && kq < k1 ? load4(ar + (size_t)j * K + kq)
                                    : make_float4(0.f, 0.f, 0.f, 0.f);
      }
  };
  if (vec) load_a(k0 + 4 * lane);
  const int n = adapter_slots(idx, S, s, list, &count);
  if (n == 0) return;
  for (int g0 = 0; g0 < n; g0 += kG) {
    const TX* xs[kG];
#pragma unroll
    for (int g = 0; g < kG; ++g)
      xs[g] = x + (size_t)list[min(g0 + g, n - 1)] * K;
    float acc[RW][kG];
#pragma unroll
    for (int i = 0; i < RW; ++i)
#pragma unroll
      for (int g = 0; g < kG; ++g) acc[i][g] = 0.f;
    if (vec) {
      for (int k = k0 + 4 * lane; k < k1; k += 128 * kU) {
        if (g0 > 0 || k != k0 + 4 * lane) load_a(k);
#pragma unroll
        for (int q = 0; q < kU; ++q) {
          const int kq = k + 128 * q;
          if (kq >= k1) break;
          float4 xv[kG];
#pragma unroll
          for (int g = 0; g < kG; ++g) xv[g] = load4(xs[g] + kq);
#pragma unroll
          for (int i = 0; i < RW; ++i)
#pragma unroll
            for (int g = 0; g < kG; ++g) {
              acc[i][g] = fmaf(xv[g].x, av[q][i].x, acc[i][g]);
              acc[i][g] = fmaf(xv[g].y, av[q][i].y, acc[i][g]);
              acc[i][g] = fmaf(xv[g].z, av[q][i].z, acc[i][g]);
              acc[i][g] = fmaf(xv[g].w, av[q][i].w, acc[i][g]);
            }
        }
      }
    } else {
      for (int k = k0 + lane; k < k1; k += 32) {
        float xv[kG];
#pragma unroll
        for (int g = 0; g < kG; ++g) xv[g] = to_f(xs[g][k]);
#pragma unroll
        for (int i = 0; i < RW; ++i) {
          const int j = warp + 8 * i;
          if (j >= R) continue;
          const float v = to_f(ar[(size_t)j * K + k]);
#pragma unroll
          for (int g = 0; g < kG; ++g) acc[i][g] = fmaf(xv[g], v, acc[i][g]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < RW; ++i)
#pragma unroll
      for (int g = 0; g < kG; ++g) {
        const float v = warp_sum(acc[i][g]);
        const int j = warp + 8 * i;
        if (lane == 0 && j < R && g0 + g < n)
          part[((size_t)c * S + list[g0 + g]) * R + j] = v;
      }
  }
}

// Grid (ceil(M / kBM), S), block kExpandThreads.  out[s', cols] for every
// slot s' of adapter u = idx[s], from the partials of the shrink.  vec:
// M a multiple of 4 and b, out aligned to their 4-element vectors.  The
// first kRows rows of B[u, :, cols] are requested first, so that the
// latencies of the slot list, the partial sums and B overlap.
template <typename TX, typename TB>
__global__ void __launch_bounds__(kExpandThreads) lora_expand_kernel(
    const float* __restrict__ part, const TB* __restrict__ b,
    const float* __restrict__ scale, const int* __restrict__ idx,
    TX* __restrict__ out, int S, int R, int M, int splits, int vec) {
  constexpr int kRows = 16;
  __shared__ int list[kMaxRows];
  __shared__ int count;
  __shared__ float h_s[kMaxRows * kMaxRank];
  const int s = blockIdx.y;
  const int u = idx[s];
  const int col = blockIdx.x * kBM + 4 * threadIdx.x;
  const bool live = col < M, full = vec && col + 3 < M;
  const TB* br = b + (size_t)u * R * M + col;
  float4 bq[kRows];
  const auto load_rows = [&](int j0) {
#pragma unroll
    for (int jj = 0; jj < kRows; ++jj)
      bq[jj] = live && j0 + jj < R
                   ? load_cols(br + (size_t)(j0 + jj) * M, col, M, full)
                   : make_float4(0.f, 0.f, 0.f, 0.f);
  };
  load_rows(0);
  const int n = adapter_slots(idx, S, s, list, &count);
  if (n == 0) return;
  // h of u's slots: the split partials in split order (their loads
  // issued together), rounded to the bank's dtype as the Pallas body does
  for (int i = threadIdx.x; i < n * R; i += kExpandThreads) {
    const float* p = part + (size_t)list[i / R] * R + i % R;
    float h = 0.f;
#pragma unroll 16
    for (int c = 0; c < splits; ++c) h += p[(size_t)c * S * R];
    h_s[i] = to_f(from_f<TB>(h));
  }
  __syncthreads();
  if (!live) return;
  const float sc = scale[u];
  for (int g0 = 0; g0 < n; g0 += kEG) {
    float acc[kEG][4];
#pragma unroll
    for (int g = 0; g < kEG; ++g)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[g][q] = 0.f;
    for (int j0 = 0; j0 < R; j0 += kRows) {
      if (g0 > 0 || j0 > 0) load_rows(j0);
#pragma unroll
      for (int jj = 0; jj < kRows; ++jj) {
        if (j0 + jj >= R) break;
        const float bv[4] = {bq[jj].x, bq[jj].y, bq[jj].z, bq[jj].w};
#pragma unroll
        for (int g = 0; g < kEG; ++g) {
          const float h = g0 + g < n ? h_s[(g0 + g) * R + j0 + jj] : 0.f;
#pragma unroll
          for (int q = 0; q < 4; ++q) acc[g][q] = fmaf(h, bv[q], acc[g][q]);
        }
      }
    }
#pragma unroll
    for (int g = 0; g < kEG; ++g) {
      if (g0 + g >= n) continue;
      TX* o = out + (size_t)list[g0 + g] * M + col;
      float v[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) v[q] = acc[g][q] * sc;
      if (full) {
        store4(o, v);
      } else {
#pragma unroll
        for (int q = 0; q < 4; ++q)
          if (col + q < M) o[q] = from_f<TX>(v[q]);
      }
    }
  }
}

template <typename TX, typename TB, int RW>
cudaError_t shrink(const void* x, const void* a, const int* idx, float* part,
                   int S, int K, int R, int splits, int chunk, int vec,
                   cudaStream_t st) {
  lora_shrink_kernel<TX, TB, RW><<<dim3(splits, S), kShrinkThreads, 0, st>>>(
      static_cast<const TX*>(x), static_cast<const TB*>(a), idx, part, S, K,
      R, chunk, vec);
  return cudaGetLastError();
}

template <typename TX, typename TB>
cudaError_t launch(const void* x, const void* a, const void* b,
                   const void* scale, const void* idx, void* part, void* out,
                   int S, int K, int R, int M, int splits, int chunk,
                   int vec_x, int vec_b, cudaStream_t st) {
  const int* ix = static_cast<const int*>(idx);
  float* p = static_cast<float*>(part);
  cudaError_t err;
  if (R <= 8)
    err = shrink<TX, TB, 1>(x, a, ix, p, S, K, R, splits, chunk, vec_x, st);
  else if (R <= 16)
    err = shrink<TX, TB, 2>(x, a, ix, p, S, K, R, splits, chunk, vec_x, st);
  else if (R <= 32)
    err = shrink<TX, TB, 4>(x, a, ix, p, S, K, R, splits, chunk, vec_x, st);
  else
    err = shrink<TX, TB, 8>(x, a, ix, p, S, K, R, splits, chunk, vec_x, st);
  if (err != cudaSuccess) return err;
  lora_expand_kernel<TX, TB>
      <<<dim3((M + kBM - 1) / kBM, S), kExpandThreads, 0, st>>>(
          p, static_cast<const TB*>(b), static_cast<const float*>(scale), ix,
          static_cast<TX*>(out), S, R, M, splits, vec_b);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// xdtype / bdtype: 0 = float32, 1 = bfloat16.  x [S, K], a [N, r, K],
// b [N, r, M], scale [N] f32, idx [S] int32 in [0, N), out [S, M]; all
// contiguous; S <= 64, r <= 64.  part: f32 scratch of splits * S * r;
// the shrink covers K in splits chunks of ``chunk`` elements (a multiple
// of 128).  vec_x: K % 4 == 0 and x, a aligned to 4 elements; vec_b:
// M % 4 == 0 and b, out aligned to 4 elements.  Two kernel launches;
// returns a cudaError_t (0 on success).
int lora_gather_fwd(int xdtype, int bdtype, const void* x, const void* a,
                    const void* b, const void* scale, const void* idx,
                    void* part, void* out, int S, int K, int R, int M,
                    int splits, int chunk, int vec_x, int vec_b,
                    void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (R < 1 || R > kMaxRank || S < 1 || S > kMaxRows || splits < 1 ||
      chunk % 128 || (long long)splits * chunk < K)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err;
  if (xdtype == 0 && bdtype == 0)
    err = launch<float, float>(x, a, b, scale, idx, part, out, S, K, R, M,
                               splits, chunk, vec_x, vec_b, st);
  else if (xdtype == 0 && bdtype == 1)
    err = launch<float, __nv_bfloat16>(x, a, b, scale, idx, part, out, S, K,
                                       R, M, splits, chunk, vec_x, vec_b, st);
  else if (xdtype == 1 && bdtype == 0)
    err = launch<__nv_bfloat16, float>(x, a, b, scale, idx, part, out, S, K,
                                       R, M, splits, chunk, vec_x, vec_b, st);
  else if (xdtype == 1 && bdtype == 1)
    err = launch<__nv_bfloat16, __nv_bfloat16>(x, a, b, scale, idx, part,
                                               out, S, K, R, M, splits, chunk,
                                               vec_x, vec_b, st);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}

const char* lora_matmul_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
