// Flash-attention building blocks shared by flash_attention.cu (K1/K2)
// and flash_mask.cu (K8): Params and the visibility rules, shared-memory
// tiles, the CUDA-core products, the float32 forward, dq and dk/dv
// kernel bodies, and what the f32 K8 dbias kernel (flash_mask.cu) builds
// on.
//
// Each body takes a compile-time Mode.  kPlain (K1/K2): a key is visible
// when it is below Sk and, causal, at or left of the bottom-right
// aligned diagonal.  kIntervals and kBiased (K8) add, in the order of
// paddle_tpu/ops/pallas/flash_mask.py:_fwd_kernel:
//   * kBiased only: an additive bias [B|1, H|1, Sq, Sk] (float32,
//     bfloat16 or float16), added in f32 after the scale, and query rows
//     past Sq masked (the bias has no row for them);
//   * flashmask column intervals [B|1, H|1, nvec, Sk] int32, when nvec >
//     0: for key column j, query rows in [mask[0][j], mask[1][j]) are
//     masked (and, nvec == 4, also [mask[2][j], mask[3][j])).
// An invisible key's logit is -inf in the forward and its recomputed p
// is 0 in the backward, so rows with no visible key give zero output,
// lse = LSE_INVALID and zero gradients.  The modes are separate
// instances so that each compiles as lean as the kernel it replaced: on
// an H100, one shared instance (the bias read and an early return in
// the elementwise loops) made the K2 kernels 14-17 % slower, and the
// visibility test written other than as a select before the exp cost
// them 4-6 %.
//
// The bodies run the float32 flash kernels (K1/K2 and K8, the dbias
// kernel's included); every bf16 kernel (K1/K2 and the K8 forward, dq,
// dk/dv and dbias) has its Hopper body in flash_sm90.cuh (wgmma, a TMA
// ring, register accumulators).
//
// The simple design, and what it leaves for later:
//   * 4 warps per CTA; 64-row tiles (32-row at head_dim 256, to fit 227
//     KB of shared memory) staged with plain 16-byte loads (no
//     cp.async/TMA, no double buffering); every body is a template on
//     the head dim, with instances at 64, 128 and 256;
//   * float32 uses CUDA-core FMA (no TF32), so card and CPU agree to
//     f32 rounding;
//   * the bias and the intervals are read from device memory per score
//     element (coalesced along the key axis); key blocks that the
//     intervals mask for a whole query block are not skipped.
#pragma once

#include <cfloat>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace flash {

// The bodies' tiles per head dim D (64, 128 or 256): kBM<D> rows of the
// CTA's own tile and of a streamed K/V tile.  At 256 a 64-row f32 tile
// is 66 KB, so the tiles halve to fit the 227 KB a CTA may use.
template <int D>
constexpr int kBM = D == 256 ? 32 : 64;
constexpr int NT = 128;    // threads per CTA (4 warps)
constexpr float kLseInvalid = FLT_MAX * 0.5f;   // LSE_INVALID

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

// Element i of a float tensor of dtype code dt (0 = float32, 1 =
// bfloat16, 2 = float16), as f32; and the store back.
__device__ __forceinline__ float load_any(const void* p, long long i, int dt) {
  if (dt == 0) return static_cast<const float*>(p)[i];
  if (dt == 1) return __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i]);
  return __half2float(static_cast<const __half*>(p)[i]);
}
__device__ __forceinline__ void store_any(void* p, long long i, float v,
                                          int dt) {
  if (dt == 0) {
    static_cast<float*>(p)[i] = v;
  } else if (dt == 1) {
    static_cast<__nv_bfloat16*>(p)[i] = __float2bfloat16(v);
  } else {
    static_cast<__half*>(p)[i] = __float2half(v);
  }
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

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const void* o;
  const void* dout;
  float* lse;     // [B, H, Sq] contiguous (forward: null = not written)
  float* delta;   // [B, H, Sq] contiguous
  void* out;      // forward output
  void* dq;
  void* dk;
  void* dv;
  int B, H, group, sq, sk, causal;
  float scale;
  // element strides: batch, head, sequence (the head dim is contiguous)
  long long q_s[3], k_s[3], v_s[3], o_s[3], do_s[3];
  long long dq_s[3], dk_s[3], dv_s[3];
  // K8 only.  Intervals: batch, head (0 = broadcast), vector strides;
  // null when nvec == 0.
  const int* mask;
  int nvec;
  long long m_s[3];
  // Bias: batch, head (0 = broadcast), row strides, columns contiguous;
  // null for none.  bias_dt: 0 float32, 1 bfloat16, 2 float16.
  const void* bias;
  int bias_dt;
  long long b_s[3];
  // dbias: contiguous [Bb, Hb, Sq, Sk] in the bias dtype, with an f32
  // accumulator of the same shape where a bf16/f16 dbias sums several
  // (batch, head) members (null otherwise).
  void* dbias;
  float* dbias_acc;
  // The bf16 K8 forward's tile table (flash_sm90.cuh): {min, max} of
  // each interval vector over each 64-key block, [Bm, Hm, nvec,
  // ceil(Sk / 64)] with Bm = B where m_s[0] != 0, else 1 (Hm likewise).
  const int2* tbl;
};

// The mask and bias of one (batch, q head), resolved once per CTA.
struct Vis {
  const int* mask;   // [nvec, Sk] rows at stride m_sv, or null
  long long m_sv;
  int nvec;
  const void* bias;  // [Sq, Sk] rows at stride b_ss, or null
  long long b_ss;
  int bias_dt;
};

__device__ __forceinline__ Vis vis_for(const Params& p, int b, int h) {
  Vis m;
  m.mask = p.nvec ? p.mask + b * p.m_s[0] + h * p.m_s[1] : nullptr;
  m.m_sv = p.m_s[2];
  m.nvec = p.nvec;
  m.bias = p.bias ? static_cast<const char*>(p.bias) +
                        (b * p.b_s[0] + h * p.b_s[1]) *
                            (p.bias_dt == 0 ? 4 : 2)
                  : nullptr;
  m.b_ss = p.b_s[2];
  m.bias_dt = p.bias_dt;
  return m;
}

enum Mode { kPlain, kIntervals, kBiased };

// Whether query row qi sees key kj.
template <Mode kMode>
__device__ __forceinline__ bool visible(int qi, int kj, const Params& p,
                                        const Vis& m) {
  bool vis = kj < p.sk && (!p.causal || kj <= qi + p.sk - p.sq);
  if constexpr (kMode == kBiased) vis = vis && qi < p.sq;
  if constexpr (kMode != kPlain) {
    if (vis && m.mask) {
      for (int iv = 0; iv < m.nvec; iv += 2) {
        const int start = m.mask[iv * m.m_sv + kj];
        const int end = m.mask[(iv + 1) * m.m_sv + kj];
        if (qi >= start && qi < end) vis = false;
      }
    }
  }
  return vis;
}

// The logit of a visible (qi, kj) from the raw dot product: scaled, and
// biased in kBiased.
template <Mode kMode>
__device__ __forceinline__ float scaled(float dot, int qi, int kj,
                                        const Params& p, const Vis& m) {
  if constexpr (kMode == kBiased) {
    return dot * p.scale +
           load_any(m.bias, (long long)qi * m.b_ss + kj, m.bias_dt);
  } else {
    return dot * p.scale;
  }
}

// Padded leading dimensions (16 bytes of padding against bank conflicts;
// every WMMA operand starts 32-byte aligned).
template <typename T, int D>
struct Ld {
  static constexpr int T_ = D + 16 / (int)sizeof(T);  // [rows, D] tiles
  static constexpr int S = kBM<D> + 4;                 // float score tile
  static constexpr int O = D + 4;                      // float accumulator
};

template <typename T, int D>
constexpr size_t tile_bytes(int rows) {
  return (size_t)rows * Ld<T, D>::T_ * sizeof(T);
}
template <int D>
constexpr size_t score_bytes(int rows) {
  return (size_t)rows * (kBM<D> + 4) * sizeof(float);
}
template <int D>
constexpr size_t acc_bytes(int rows) {
  return (size_t)rows * (D + 4) * sizeof(float);
}

// Load rows [row0, row0 + ROWS) of a [S, D] operand into a padded tile,
// zero-filling rows >= n (they must be finite: 0 * NaN would poison a
// product even where p == 0).
template <typename T, int D, int ROWS>
__device__ __forceinline__ void load_tile(T* dst, const T* src,
                                          long long stride, int row0,
                                          int n) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kPerRow = D / kVec;
  for (int e = threadIdx.x; e < ROWS * kPerRow; e += NT) {
    const int r = e / kPerRow;
    const int c = (e % kPerRow) * kVec;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < n)
      val = *reinterpret_cast<const uint4*>(
          src + (long long)(row0 + r) * stride + c);
    *reinterpret_cast<uint4*>(dst + r * Ld<T, D>::T_ + c) = val;
  }
}

// c[r][j] = a_r . b_j (raw dot, f32) for r < ROWS, j < BN (CUDA cores:
// the bf16 kernels' products are wgmma, in flash_sm90.cuh).
template <typename T, int D, int ROWS>
__device__ __forceinline__ void mm_abt(const T* a_s, const T* b_s,
                                       float* c_s) {
  constexpr int BN = kBM<D>;
  constexpr int LT = Ld<T, D>::T_;
  constexpr int LS = Ld<T, D>::S;
  for (int e = threadIdx.x; e < ROWS * BN; e += NT) {
    const int r = e / BN;
    const int j = e % BN;
    float s = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d)
      s += to_f(a_s[r * LT + d]) * to_f(b_s[j * LT + d]);
    c_s[r * LS + j] = s;
  }
}

// c[r][:] += sum_j p[r][j] * b[j][:] for r < BM, j < BN (float32: the
// bf16 kernels' products are wgmma, in flash_sm90.cuh).
template <int D>
__device__ __forceinline__ void mm_acc_ab(const float* p_s, const float* b_s,
                                          float* c_s) {
  constexpr int BM = kBM<D>, BN = kBM<D>;
  constexpr int LT = Ld<float, D>::T_;
  constexpr int LS = Ld<float, D>::S;
  constexpr int LO = Ld<float, D>::O;
  for (int e = threadIdx.x; e < BM * D; e += NT) {
    const int r = e / D;
    const int d = e % D;
    float o = c_s[r * LO + d];
#pragma unroll 8
    for (int j = 0; j < BN; ++j) o += p_s[r * LS + j] * b_s[j * LT + d];
    c_s[r * LO + d] = o;
  }
}

// c[j][:] += sum_r p[r][j] * b[r][:] for j < BN, r < ROWS (the
// transposed product of the dk/dv kernel; float32).
template <int D, int ROWS>
__device__ __forceinline__ void mm_acc_atb(const float* p_s, const float* b_s,
                                           float* c_s) {
  constexpr int BN = kBM<D>;
  constexpr int LT = Ld<float, D>::T_;
  constexpr int LS = Ld<float, D>::S;
  constexpr int LO = Ld<float, D>::O;
  for (int e = threadIdx.x; e < BN * D; e += NT) {
    const int j = e / D;
    const int d = e % D;
    float o = c_s[j * LO + d];
#pragma unroll 8
    for (int r = 0; r < ROWS; ++r) o += p_s[r * LS + j] * b_s[r * LT + d];
    c_s[j * LO + d] = o;
  }
}

// K-block trip count of a query block (flash_attention._q_trip_count).
template <int D>
__device__ __forceinline__ int q_trip_count(int q0, const Params& p) {
  constexpr int BM = kBM<D>, BN = kBM<D>;
  const int nblk = (p.sk + BN - 1) / BN;
  if (!p.causal) return nblk;
  const int num = q0 + BM + (p.sk - p.sq) + BN - 1;
  return num <= 0 ? 0 : min(num / BN, nblk);
}

// ------------------------------------------------------------- forward
template <typename T, int D>
struct FwdSmem {
  static constexpr int BM = kBM<D>;
  static constexpr size_t kT = tile_bytes<T, D>(BM);
  static constexpr size_t kS = score_bytes<D>(BM);
  static constexpr size_t kO = acc_bytes<D>(BM);
  static constexpr size_t kML = 2 * BM * sizeof(float);
  static constexpr size_t bytes = 3 * kT + kS + kO + kML;
};

// Grid (ceil(Sq / kBM<D>), H, B), 128 threads: online softmax with f32
// m, l and accumulator; rows with no visible key give zeros and lse =
// LSE_INVALID, else lse = m + log(l).  float32 only (the bodies' T).
template <typename T, Mode kMode, int D>
__device__ __forceinline__ void fwd_body(const Params& p,
                                         unsigned char* smem) {
  static_assert(std::is_same<T, float>::value, "bf16: flash_sm90.cuh");
  using S = FwdSmem<T, D>;
  constexpr int BM = kBM<D>, BN = kBM<D>;
  constexpr int LS = Ld<T, D>::S;
  constexpr int LO = Ld<T, D>::O;
  T* q_t = reinterpret_cast<T*>(smem);
  T* k_t = reinterpret_cast<T*>(smem + S::kT);
  T* v_t = reinterpret_cast<T*>(smem + 2 * S::kT);
  float* s_t = reinterpret_cast<float*>(smem + 3 * S::kT);
  float* o_t = reinterpret_cast<float*>(smem + 3 * S::kT + S::kS);
  float* m_t = reinterpret_cast<float*>(smem + 3 * S::kT + S::kS + S::kO);
  float* l_t = m_t + BM;

  const int q0 = blockIdx.x * BM;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / p.group;
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  const T* qg = static_cast<const T*>(p.q) + b * p.q_s[0] + h * p.q_s[1];
  const T* kg = static_cast<const T*>(p.k) + b * p.k_s[0] + hk * p.k_s[1];
  const T* vg = static_cast<const T*>(p.v) + b * p.v_s[0] + hk * p.v_s[1];
  const Vis m = kMode == kPlain ? Vis{} : vis_for(p, b, h);
  const int upper = q_trip_count<D>(q0, p);

  load_tile<T, D, BM>(q_t, qg, p.q_s[2], q0, p.sq);
  for (int e = t; e < BM * D; e += NT) o_t[(e / D) * LO + e % D] = 0.f;
  if (t < BM) {
    m_t[t] = -INFINITY;
    l_t[t] = 0.f;
  }

  for (int kb = 0; kb < upper; ++kb) {
    const int k0 = kb * BN;
    __syncthreads();  // the previous block is done with k_t, v_t, s_t
    load_tile<T, D, BN>(k_t, kg, p.k_s[2], k0, p.sk);
    load_tile<T, D, BN>(v_t, vg, p.v_s[2], k0, p.sk);
    __syncthreads();
    mm_abt<T, D, BM>(q_t, k_t, s_t);
    __syncthreads();

    // online softmax: warp w owns query rows [BM / 4 w, BM / 4 (w + 1));
    // -inf stands for MASK_VAL, guarded (alpha = 1 and m taken as 0 while
    // a row has seen no visible key)
    for (int rr = 0; rr < BM / 4; ++rr) {
      const int r = warp * (BM / 4) + rr;
      float sv[BN / 32];
      float mx = -INFINITY;
#pragma unroll
      for (int u = 0; u < BN / 32; ++u) {
        const int c = lane + 32 * u;
        const int qi = q0 + r;
        const int kj = k0 + c;
        const float s = visible<kMode>(qi, kj, p, m)
                            ? scaled<kMode>(s_t[r * LS + c], qi, kj, p, m)
                            : -INFINITY;
        sv[u] = s;
        mx = fmaxf(mx, s);
      }
      mx = warp_max(mx);
      const float m_prev = m_t[r];
      const float m_cur = fmaxf(m_prev, mx);
      const bool finite = m_cur != -INFINITY;
      const float alpha = finite ? expf(m_prev - m_cur) : 1.f;
      const float m_safe = finite ? m_cur : 0.f;
      float sum = 0.f;
#pragma unroll
      for (int u = 0; u < BN / 32; ++u) {
        const int c = lane + 32 * u;
        const float pe = expf(sv[u] - m_safe);
        sum += pe;
        s_t[r * LS + c] = pe;
      }
      sum = warp_sum(sum);
      for (int d = lane; d < D; d += 32) o_t[r * LO + d] *= alpha;
      if (lane == 0) {
        m_t[r] = m_cur;
        l_t[r] = l_t[r] * alpha + sum;
      }
    }
    __syncthreads();
    mm_acc_ab<D>(s_t, v_t, o_t);
  }
  __syncthreads();

  T* og = static_cast<T*>(p.out) + b * p.o_s[0] + h * p.o_s[1];
  for (int e = t; e < BM * D; e += NT) {
    const int r = e / D;
    const int d = e % D;
    if (q0 + r < p.sq) {
      const float l = l_t[r];
      og[(long long)(q0 + r) * p.o_s[2] + d] =
          from_f<T>(l > 0.f ? o_t[r * LO + d] / l : 0.f);
    }
  }
  if (p.lse && t < BM && q0 + t < p.sq) {
    const float l = l_t[t];
    p.lse[((long long)b * p.H + h) * p.sq + q0 + t] =
        l > 0.f ? m_t[t] + logf(l) : kLseInvalid;
  }
}

// --------------------------------------------------------- backward dq
template <typename T, int D>
struct DqSmem {
  static constexpr int BM = kBM<D>;
  static constexpr size_t kT = tile_bytes<T, D>(BM);   // q, do, k, v
  static constexpr size_t kS = score_bytes<D>(BM);     // s, dp
  static constexpr size_t kO = acc_bytes<D>(BM);       // dq
  static constexpr size_t kLD = 2 * BM * sizeof(float);
  static constexpr size_t bytes = 4 * kT + 2 * kS + kO + kLD;
};

// Grid (ceil(Sq / kBM<D>), H, B), 128 threads: p = exp(logit - lse)
// recomputed; delta = rowsum(out * dout) in f32, written for the dk/dv
// kernel; ds = p * (dp - delta) * scale; dq = ds K.  float32 only.
template <typename T, Mode kMode, int D>
__device__ __forceinline__ void dq_body(const Params& p,
                                        unsigned char* smem) {
  static_assert(std::is_same<T, float>::value, "bf16: flash_sm90.cuh");
  using S = DqSmem<T, D>;
  constexpr int BM = kBM<D>, BN = kBM<D>;
  constexpr int LT = Ld<T, D>::T_;
  constexpr int LS = Ld<T, D>::S;
  constexpr int LO = Ld<T, D>::O;
  T* q_t = reinterpret_cast<T*>(smem);
  T* do_t = reinterpret_cast<T*>(smem + S::kT);
  T* k_t = reinterpret_cast<T*>(smem + 2 * S::kT);
  T* v_t = reinterpret_cast<T*>(smem + 3 * S::kT);
  float* s_t = reinterpret_cast<float*>(smem + 4 * S::kT);
  float* dp_t = reinterpret_cast<float*>(smem + 4 * S::kT + S::kS);
  float* dq_t = reinterpret_cast<float*>(smem + 4 * S::kT + 2 * S::kS);
  float* lse_t = reinterpret_cast<float*>(smem + 4 * S::kT + 2 * S::kS +
                                          S::kO);
  float* delta_t = lse_t + BM;

  const int q0 = blockIdx.x * BM;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / p.group;
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  const T* qg = static_cast<const T*>(p.q) + b * p.q_s[0] + h * p.q_s[1];
  const T* dog = static_cast<const T*>(p.dout) + b * p.do_s[0] + h * p.do_s[1];
  const T* og = static_cast<const T*>(p.o) + b * p.o_s[0] + h * p.o_s[1];
  const T* kg = static_cast<const T*>(p.k) + b * p.k_s[0] + hk * p.k_s[1];
  const T* vg = static_cast<const T*>(p.v) + b * p.v_s[0] + hk * p.v_s[1];
  const Vis m = kMode == kPlain ? Vis{} : vis_for(p, b, h);
  const long long row_base = ((long long)b * p.H + h) * p.sq;
  const int upper = q_trip_count<D>(q0, p);

  load_tile<T, D, BM>(q_t, qg, p.q_s[2], q0, p.sq);
  load_tile<T, D, BM>(do_t, dog, p.do_s[2], q0, p.sq);
  for (int e = t; e < BM * D; e += NT) dq_t[(e / D) * LO + e % D] = 0.f;
  __syncthreads();
  // delta = rowsum(out * dout) in f32; lse of rows past Sq is invalid
  for (int rr = 0; rr < BM / 4; ++rr) {
    const int r = warp * (BM / 4) + rr;
    const int qi = q0 + r;
    float acc = 0.f;
    if (qi < p.sq)
      for (int d = lane; d < D; d += 32)
        acc += to_f(og[(long long)qi * p.o_s[2] + d]) * to_f(do_t[r * LT + d]);
    acc = warp_sum(acc);
    if (lane == 0) {
      delta_t[r] = acc;
      lse_t[r] = qi < p.sq ? p.lse[row_base + qi] : kLseInvalid;
      if (qi < p.sq) p.delta[row_base + qi] = acc;
    }
  }

  for (int kb = 0; kb < upper; ++kb) {
    const int k0 = kb * BN;
    __syncthreads();  // the previous block is done with k_t, v_t, s_t
    load_tile<T, D, BN>(k_t, kg, p.k_s[2], k0, p.sk);
    load_tile<T, D, BN>(v_t, vg, p.v_s[2], k0, p.sk);
    __syncthreads();
    mm_abt<T, D, BM>(q_t, k_t, s_t);
    mm_abt<T, D, BM>(do_t, v_t, dp_t);
    __syncthreads();
    for (int e = t; e < BM * BN; e += NT) {
      const int r = e / BN;
      const int c = e % BN;
      const int qi = q0 + r;
      const int kj = k0 + c;
      const float pr =
          visible<kMode>(qi, kj, p, m)
              ? expf(scaled<kMode>(s_t[r * LS + c], qi, kj, p, m) - lse_t[r])
              : 0.f;
      s_t[r * LS + c] = pr * (dp_t[r * LS + c] - delta_t[r]) * p.scale;
    }
    __syncthreads();
    mm_acc_ab<D>(s_t, k_t, dq_t);
  }
  __syncthreads();

  T* dqg = static_cast<T*>(p.dq) + b * p.dq_s[0] + h * p.dq_s[1];
  for (int e = t; e < BM * D; e += NT) {
    const int r = e / D;
    const int d = e % D;
    if (q0 + r < p.sq)
      dqg[(long long)(q0 + r) * p.dq_s[2] + d] = from_f<T>(dq_t[r * LO + d]);
  }
}

// -------------------------------------------------------- backward dkv
template <typename T, int D>
struct DkvCfg {
  static constexpr int BN = kBM<D>;
  static constexpr int QB = BN / 2;                      // streamed q rows
  static constexpr size_t kKV = tile_bytes<T, D>(BN);    // k, v
  static constexpr size_t kQ = tile_bytes<T, D>(QB);     // q, do
  static constexpr size_t kS = score_bytes<D>(QB);       // s/p, dp/ds
  static constexpr size_t kO = acc_bytes<D>(BN);         // dk, dv
  static constexpr size_t kLD = 2 * QB * sizeof(float);
  static constexpr size_t bytes = 2 * kKV + 2 * kQ + 2 * kS + 2 * kO + kLD;
};

// Grid (ceil(Sk / kBM<D>), kvH, B), 128 threads (p.H is kvH here): one CTA
// per key block loops over the GQA group's q heads and their query
// blocks from the causal lower bound (_k_trip_bounds), accumulating dk
// and dv of the whole group in f32 (the reference rounds per q head,
// then sums: identical in float32).  It streams 32-row query blocks so
// its shared memory fits the 227 KB a CTA may use.  float32 only.
template <typename T, Mode kMode, int D>
__device__ __forceinline__ void dkv_body(const Params& p,
                                         unsigned char* smem) {
  static_assert(std::is_same<T, float>::value, "bf16: flash_sm90.cuh");
  using C = DkvCfg<T, D>;
  constexpr int BN = C::BN, QB = C::QB;
  constexpr int LS = Ld<T, D>::S;
  constexpr int LO = Ld<T, D>::O;
  unsigned char* ptr = smem;
  T* k_t = reinterpret_cast<T*>(ptr);             ptr += C::kKV;
  T* v_t = reinterpret_cast<T*>(ptr);             ptr += C::kKV;
  T* q_t = reinterpret_cast<T*>(ptr);             ptr += C::kQ;
  T* do_t = reinterpret_cast<T*>(ptr);            ptr += C::kQ;
  float* s_t = reinterpret_cast<float*>(ptr);     ptr += C::kS;
  float* dp_t = reinterpret_cast<float*>(ptr);    ptr += C::kS;
  float* dk_t = reinterpret_cast<float*>(ptr);    ptr += C::kO;
  float* dv_t = reinterpret_cast<float*>(ptr);    ptr += C::kO;
  float* lse_t = reinterpret_cast<float*>(ptr);
  float* delta_t = lse_t + QB;

  const int k0 = blockIdx.x * BN;
  const int hk = blockIdx.y;
  const int b = blockIdx.z;
  const int t = threadIdx.x;
  const T* kg = static_cast<const T*>(p.k) + b * p.k_s[0] + hk * p.k_s[1];
  const T* vg = static_cast<const T*>(p.v) + b * p.v_s[0] + hk * p.v_s[1];
  // causal lower bound on query blocks (_k_trip_bounds)
  const int nq = (p.sq + QB - 1) / QB;
  int lower = 0;
  if (p.causal) {
    const int x = k0 - (p.sk - p.sq);
    lower = x <= 0 ? 0 : min(x / QB, nq);
  }

  load_tile<T, D, BN>(k_t, kg, p.k_s[2], k0, p.sk);
  load_tile<T, D, BN>(v_t, vg, p.v_s[2], k0, p.sk);
  for (int e = t; e < BN * D; e += NT) {
    dk_t[(e / D) * LO + e % D] = 0.f;
    dv_t[(e / D) * LO + e % D] = 0.f;
  }

  for (int j = 0; j < p.group; ++j) {
    const int h = hk * p.group + j;
    const T* qg = static_cast<const T*>(p.q) + b * p.q_s[0] + h * p.q_s[1];
    const T* dog =
        static_cast<const T*>(p.dout) + b * p.do_s[0] + h * p.do_s[1];
    const Vis m = kMode == kPlain ? Vis{} : vis_for(p, b, h);
    const long long row_base = ((long long)b * p.H * p.group + h) * p.sq;
    for (int qb = lower; qb < nq; ++qb) {
      const int q0 = qb * QB;
      __syncthreads();  // the previous block is done with q_t .. dp_t
      load_tile<T, D, QB>(q_t, qg, p.q_s[2], q0, p.sq);
      load_tile<T, D, QB>(do_t, dog, p.do_s[2], q0, p.sq);
      if (t < QB) {
        const int qi = q0 + t;
        lse_t[t] = qi < p.sq ? p.lse[row_base + qi] : kLseInvalid;
        delta_t[t] = qi < p.sq ? p.delta[row_base + qi] : 0.f;
      }
      __syncthreads();
      mm_abt<T, D, QB>(q_t, k_t, s_t);
      mm_abt<T, D, QB>(do_t, v_t, dp_t);
      __syncthreads();
      for (int e = t; e < QB * BN; e += NT) {
        const int r = e / BN;
        const int c = e % BN;
        const int qi = q0 + r;
        const float pr =
            qi < p.sq && visible<kMode>(qi, k0 + c, p, m)
                ? expf(scaled<kMode>(s_t[r * LS + c], qi, k0 + c, p, m) -
                       lse_t[r])
                : 0.f;
        s_t[r * LS + c] = pr;
        dp_t[r * LS + c] = pr * (dp_t[r * LS + c] - delta_t[r]) * p.scale;
      }
      __syncthreads();
      mm_acc_atb<D, QB>(s_t, do_t, dv_t);
      mm_acc_atb<D, QB>(dp_t, q_t, dk_t);
    }
  }
  __syncthreads();

  T* dkg = static_cast<T*>(p.dk) + b * p.dk_s[0] + hk * p.dk_s[1];
  T* dvg = static_cast<T*>(p.dv) + b * p.dv_s[0] + hk * p.dv_s[1];
  for (int e = t; e < BN * D; e += NT) {
    const int r = e / D;
    const int d = e % D;
    if (k0 + r < p.sk) {
      dkg[(long long)(k0 + r) * p.dk_s[2] + d] = from_f<T>(dk_t[r * LO + d]);
      dvg[(long long)(k0 + r) * p.dv_s[2] + d] = from_f<T>(dv_t[r * LO + d]);
    }
  }
}

// ------------------------------------------------------------- host side
template <typename Kern>
int launch(Kern kern, size_t smem, dim3 grid, const Params& p,
           cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kern<<<grid, NT, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

inline void set3(long long* dst, const long long* src) {
  dst[0] = src[0];
  dst[1] = src[1];
  dst[2] = src[2];
}

// The head dims the kernels are built for: 64, 128 and 256, the ones the
// reference's sdpa sends to its Pallas kernels.
inline bool bad_args(int dtype, int head_dim, int B, int H, int group,
                     int sq, int sk) {
  return (dtype != 0 && dtype != 1) ||
         (head_dim != 64 && head_dim != 128 && head_dim != 256) || B < 1 ||
         H < 1 || group < 1 || sq < 1 || sk < 1;
}

// ``launch(std::integral_constant<int, D>())`` for the head dim D that
// ``head_dim`` names (64, 128 or 256), else cudaErrorInvalidValue.
template <typename F>
inline int by_head_dim(int head_dim, F launch) {
  switch (head_dim) {
    case 64:
      return launch(std::integral_constant<int, 64>());
    case 128:
      return launch(std::integral_constant<int, 128>());
    case 256:
      return launch(std::integral_constant<int, 256>());
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace flash
