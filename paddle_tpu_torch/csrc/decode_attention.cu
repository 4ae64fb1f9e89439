// Dense-cache decode attention for Hopper (sm_90a).
//
// Replaces: paddle_tpu/ops/pallas/decode_attention.py:_pallas_decode
// (_decode_kernel, the K7 TPU kernel).  One query token per sequence
// attends over its kv-head-major cache [B, kvh, T, D], keys t <= pos[b];
// rep = nh / kvh query heads share each kv head's K/V reads (GQA).
//
// Numerics follow the TPU kernel: scores q.k in f32 times 1/sqrt(D),
// keys past pos[b] masked, an online softmax with m, l and acc in f32,
// p rounded to v's dtype before the P.V product
// (decode_attention.py:64-75) while l sums the unrounded p, and the
// output acc / l in q's dtype.  A row with pos[b] < 0 sees no key and
// is written as zeros.
//
// What bounds it on the H100: bytes.  It reads every visible K/V row
// once and does ~4 flops per byte, far below the ~295 flop/byte ridge,
// so the floor is 2 * sum_b(pos_b + 1) * kvh * D * itemsize over
// 3.35 TB/s.
//
// The design (split-T, "flash-decoding"), and what it leaves for later:
//   * the TPU grid (B, kvh, T / block_t) carries m, l and acc in scratch
//     along its sequential T axis; blocks on an H100 run in parallel and
//     carry nothing.  So pass 1 gives each CTA one (T chunk, sequence,
//     kv head): it walks its kChunk keys in kTile-key tiles and writes
//     its partial (m, l, acc) in f32; chunks wholly past pos[b] return
//     at once.  Pass 2, one CTA per (sequence, q head), rescales the
//     partials to their common max and divides.  At B 8, 8 kv heads and
//     T 8192 that is 2048 CTAs, not the 64 of one CTA per (b, kv head).
//   * the ragged edge is masked here: only keys [chunk start,
//     min(chunk end, pos[b] + 1, T)) are read, so T needs no alignment.
//   * K and V tiles are staged in shared memory with plain 16-byte
//     loads; there is no cp.async/TMA double buffering, so a tile's load
//     does not overlap the previous tile's math (later work).
//   * scores use one warp per key with a shuffle reduction over D; P.V
//     gives each thread one head-dim column of the rep accumulators.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kD = 128;      // head_dim (the only width on the ported path)
constexpr int kMaxRep = 16;  // query heads per kv head held in registers
constexpr int kTile = 64;    // keys staged in shared memory at a time
constexpr int kChunk = 256;  // keys per CTA of pass 1 (_CHUNK in Python)

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

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Keys [0, visible(b)) attend: pos[b] + 1, clipped to the cache.
__device__ __forceinline__ int visible(const int* pos, int b, int T) {
  return min(pos[b] + 1, T);
}

// Pass 1.  q [B, nh, D]; kc/vc [B, kvh, T, D]; pos [B]; partials
// part_m/part_l [B, nh, n_chunks], part_acc [B, nh, n_chunks, D] (f32,
// acc unnormalised).  Grid (n_chunks, B * kvh), block kD threads.
template <typename T>
__global__ void __launch_bounds__(kD) decode_partial_kernel(
    const T* __restrict__ q, const T* __restrict__ kc,
    const T* __restrict__ vc, const int* __restrict__ pos,
    float* __restrict__ part_m, float* __restrict__ part_l,
    float* __restrict__ part_acc, int kvh, int rep, int T_len,
    int n_chunks, float sm_scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* k_s = reinterpret_cast<T*>(smem);                   // [kTile][kD]
  T* v_s = k_s + kTile * kD;                             // [kTile][kD]
  float* q_s = reinterpret_cast<float*>(v_s + kTile * kD);  // [rep][kD]
  float* p_s = q_s + rep * kD;                           // [rep][kTile]
  float* m_s = p_s + rep * kTile;                        // [rep]
  float* l_s = m_s + rep;                                // [rep]
  float* a_s = l_s + rep;                                // [rep] alpha

  constexpr int kWarps = kD / 32;
  constexpr int kPer = kD / 32;            // head-dim elements per lane
  constexpr int kVec = 16 / sizeof(T);     // elements per 16-byte load
  const int c = blockIdx.x;
  const int b = blockIdx.y / kvh;
  const int g = blockIdx.y % kvh;
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  const int nh = kvh * rep;
  const int lo = c * kChunk;
  const int hi = min(lo + kChunk, visible(pos, b, T_len));
  if (lo >= hi) return;  // wholly past pos[b]: pass 2 never reads it

  for (int r = 0; r < rep; ++r)
    q_s[r * kD + t] = to_f(q[((size_t)b * nh + g * rep + r) * kD + t]);
  if (t < rep) {
    m_s[t] = -INFINITY;
    l_s[t] = 0.f;
  }
  float acc[kMaxRep];
#pragma unroll
  for (int r = 0; r < kMaxRep; ++r) acc[r] = 0.f;
  __syncthreads();

  const size_t head = ((size_t)b * kvh + g) * (size_t)T_len * kD;
  for (int t0 = lo; t0 < hi; t0 += kTile) {
    const int n = min(kTile, hi - t0);  // keys of this tile, all visible
    const uint4* ksrc =
        reinterpret_cast<const uint4*>(kc + head + (size_t)t0 * kD);
    const uint4* vsrc =
        reinterpret_cast<const uint4*>(vc + head + (size_t)t0 * kD);
    uint4* kdst = reinterpret_cast<uint4*>(k_s);
    uint4* vdst = reinterpret_cast<uint4*>(v_s);
    for (int e = t; e < n * (kD / kVec); e += kD) {
      kdst[e] = ksrc[e];
      vdst[e] = vsrc[e];
    }
    __syncthreads();

    // scores s[r][j] = q_r . k_j * scale, one warp per key
    for (int j = warp; j < n; j += kWarps) {
      float kf[kPer];
#pragma unroll
      for (int e = 0; e < kPer; ++e)
        kf[e] = to_f(k_s[j * kD + lane * kPer + e]);
      for (int r = 0; r < rep; ++r) {
        float s = 0.f;
#pragma unroll
        for (int e = 0; e < kPer; ++e)
          s += q_s[r * kD + lane * kPer + e] * kf[e];
        s = warp_sum(s);
        if (lane == 0) p_s[r * kTile + j] = s * sm_scale;
      }
    }
    __syncthreads();

    // online softmax, one warp per query row; n >= 1, so m_cur is finite
    for (int r = warp; r < rep; r += kWarps) {
      float mx = -INFINITY;
      for (int j = lane; j < n; j += 32) mx = fmaxf(mx, p_s[r * kTile + j]);
      mx = warp_max(mx);
      const float m_prev = m_s[r];
      const float m_cur = fmaxf(m_prev, mx);
      float sum = 0.f;
      for (int j = lane; j < n; j += 32) {
        const float p = expf(p_s[r * kTile + j] - m_cur);
        sum += p;
        p_s[r * kTile + j] = to_f(from_f<T>(p));  // p in v's dtype for P.V
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float alpha = expf(m_prev - m_cur);
        a_s[r] = alpha;
        l_s[r] = l_s[r] * alpha + sum;
        m_s[r] = m_cur;
      }
    }
    __syncthreads();

    // acc[r][t] = acc * alpha + sum_j p[r][j] * v[j][t]
#pragma unroll
    for (int r = 0; r < kMaxRep; ++r) {
      if (r < rep) {
        float o = acc[r] * a_s[r];
        for (int j = 0; j < n; ++j)
          o += p_s[r * kTile + j] * to_f(v_s[j * kD + t]);
        acc[r] = o;
      }
    }
    __syncthreads();  // the next tile overwrites k_s, v_s and p_s
  }

#pragma unroll
  for (int r = 0; r < kMaxRep; ++r) {
    if (r < rep) {
      const size_t row = ((size_t)b * nh + g * rep + r) * n_chunks + c;
      part_acc[row * kD + t] = acc[r];
      if (t == 0) {
        part_m[row] = m_s[r];
        part_l[row] = l_s[r];
      }
    }
  }
}

// Pass 2.  Grid B * nh, block kD threads: out[b, h] = sum_c acc_c *
// e^(m_c - m) / sum_c l_c * e^(m_c - m) over the chunks pass 1 wrote.
template <typename T>
__global__ void __launch_bounds__(kD) decode_combine_kernel(
    const float* __restrict__ part_m, const float* __restrict__ part_l,
    const float* __restrict__ part_acc, const int* __restrict__ pos,
    T* __restrict__ out, int nh, int T_len, int n_chunks) {
  const int bh = blockIdx.x;
  const int t = threadIdx.x;
  const int hi = visible(pos, bh / nh, T_len);
  const int nc = hi > 0 ? (hi + kChunk - 1) / kChunk : 0;
  const float* pm = part_m + (size_t)bh * n_chunks;
  const float* pl = part_l + (size_t)bh * n_chunks;
  const float* pa = part_acc + (size_t)bh * n_chunks * kD;
  float m = -INFINITY;
  for (int c = 0; c < nc; ++c) m = fmaxf(m, pm[c]);
  float l = 0.f, o = 0.f;
  for (int c = 0; c < nc; ++c) {
    const float w = expf(pm[c] - m);
    l += pl[c] * w;
    o += pa[(size_t)c * kD + t] * w;
  }
  out[(size_t)bh * kD + t] = from_f<T>(nc > 0 ? o / l : 0.f);
}

template <typename T>
int launch(const void* q, const void* kc, const void* vc, const void* pos,
           void* out, void* part_m, void* part_l, void* part_acc, int B,
           int kvh, int rep, int T_len, int n_chunks, float sm_scale,
           cudaStream_t stream) {
  const size_t smem =
      2 * (size_t)kTile * kD * sizeof(T) +
      ((size_t)rep * kD + (size_t)rep * kTile + 3 * rep) * sizeof(float);
  auto partial = decode_partial_kernel<T>;
  cudaError_t err = cudaFuncSetAttribute(
      partial, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  partial<<<dim3(n_chunks, B * kvh), kD, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(kc),
      static_cast<const T*>(vc), static_cast<const int*>(pos),
      static_cast<float*>(part_m), static_cast<float*>(part_l),
      static_cast<float*>(part_acc), kvh, rep, T_len, n_chunks, sm_scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  decode_combine_kernel<T><<<B * kvh * rep, kD, 0, stream>>>(
      static_cast<const float*>(part_m), static_cast<const float*>(part_l),
      static_cast<const float*>(part_acc), static_cast<const int*>(pos),
      static_cast<T*>(out), kvh * rep, T_len, n_chunks);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16; head_dim must be 128.  Returns a
// cudaError_t code (0 = launched).  Shapes are validated by the Python
// wrapper; n_chunks = ceil(T / 256).
int decode_attention_fwd(int dtype, int head_dim, const void* q,
                         const void* kc, const void* vc, const void* pos,
                         void* out, void* part_m, void* part_l,
                         void* part_acc, int B, int kvh, int rep, int T_len,
                         int n_chunks, float sm_scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (rep < 1 || rep > kMaxRep || head_dim != kD) {
    return (int)cudaErrorInvalidValue;
  }
  if (n_chunks != (T_len + kChunk - 1) / kChunk || B * kvh > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  if (dtype == 0)
    return launch<float>(q, kc, vc, pos, out, part_m, part_l, part_acc, B,
                         kvh, rep, T_len, n_chunks, sm_scale, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, kc, vc, pos, out, part_m, part_l,
                                 part_acc, B, kvh, rep, T_len, n_chunks,
                                 sm_scale, s);
  return (int)cudaErrorInvalidValue;
}

const char* decode_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
