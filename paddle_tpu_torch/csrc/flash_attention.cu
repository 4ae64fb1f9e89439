// Flash attention forward (K1) and backward (K2) for Hopper (sm_90a).
//
// Replaces, in paddle_tpu/ops/pallas/flash_attention.py:
//   * K1: _flash_fwd_x32 -> _fwd_kernel (:523, :576) and its streamed
//     long-sequence twin _flash_fwd_stream (:721);
//   * K2: _flash_bwd_x32 -> _bwd_dq_kernel (:925) and _bwd_dkv_kernel
//     (:960), with the GQA group sum of :1064-1066, and the streamed
//     twin _flash_bwd_stream (:862).
// One kernel of each kind takes every length: the TPU's 128-padding and
// its streamed switch past 4096 tokens are VMEM limits the card does
// not have (K/V or Q/dO tiles are staged through shared memory).
//
// Semantics, as in the Pallas kernels:
//   * keys k >= Sk are invisible (the ragged edge is masked here);
//   * causal visibility is bottom-right aligned: k <= q + (Sk - Sq);
//   * GQA: q head h reads kv head h / group;
//   * forward: online softmax with f32 m, l and accumulator; p rounded
//     to v's dtype before P.V; rows with no visible key give zeros and
//     lse = LSE_INVALID; otherwise lse = m + log(l);
//   * backward: p = exp(s * scale - lse) recomputed; delta =
//     rowsum(out * dout) in f32; ds = p * (dp - delta) * scale, rounded
//     to the input dtype before dq = ds K and dk = ds^T Q; dv = p^T dO
//     with p rounded to dO's dtype.
//
// What bounds them on the H100: operations.  At a training shape
// (seq 2048, head_dim 128) the forward does 4 * pairs * D flops per
// head against O(S * D) bytes, the dq kernel 6 * pairs * D and the
// dk/dv kernel 8 * pairs * D, all far above the ~295 flop/byte ridge;
// the floor is the visible flops over the 989 TFLOP/s bf16 peak.
//
// The simple design, and what it leaves for later:
//   * 4 warps per CTA; 64-row tiles staged in shared memory with plain
//     16-byte loads (no cp.async/TMA, no double buffering);
//   * bf16 products on the tensor cores through WMMA (16x16x16
//     mma.sync tiles), not wgmma; score tiles and f32 accumulators
//     round-trip through shared memory, so the softmax and the
//     elementwise backward run as plain thread loops;
//   * float32 uses CUDA-core FMA (no TF32), so card and CPU agree to
//     f32 rounding;
//   * forward and dq: one CTA per (64-row query block, q head, batch),
//     streaming K/V blocks up to the causal trip count;
//   * dq also writes delta [B, H, Sq] for the dk/dv kernel, which so
//     never reads O;
//   * dk/dv: one CTA per (64-key block, kv head, batch) loops over the
//     group's q heads and their query blocks from the causal lower
//     bound (_k_trip_bounds), accumulating dk and dv of the whole group
//     in f32.  That replaces the reference's per-q-head [B, H, Sk, D]
//     intermediates and their group sum: no extra memory and no extra
//     pass, at the price of fewer CTAs under GQA (kvH instead of H per
//     key block).  The f32 instance streams 32-row query blocks so its
//     shared memory fits the 227 KB a CTA may use.
// A wgmma + TMA pipeline with register accumulators is the later work
// that makes these fast.
#include <cfloat>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include <type_traits>

namespace {

using namespace nvcuda;

constexpr int D = 128;     // head dim (the only one of a ported model)
constexpr int BM = 64;     // rows of the CTA's own tile
constexpr int BN = 64;     // rows of a streamed K/V tile
constexpr int NT = 128;    // threads per CTA (4 warps)
constexpr float kLseInvalid = FLT_MAX * 0.5f;   // LSE_INVALID

template <typename T>
constexpr bool kIsBf16 = std::is_same<T, __nv_bfloat16>::value;

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

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const void* o;
  const void* dout;
  float* lse;     // [B, H, Sq] contiguous
  float* delta;   // [B, H, Sq] contiguous
  void* out;      // forward output
  void* dq;
  void* dk;
  void* dv;
  int H, group, sq, sk, causal;
  float scale;
  // element strides: batch, head, sequence (the head dim is contiguous)
  long long q_s[3], k_s[3], v_s[3], o_s[3], do_s[3];
  long long dq_s[3], dk_s[3], dv_s[3];
};

// Padded leading dimensions (16 bytes of padding against bank conflicts;
// every WMMA operand starts 32-byte aligned).
template <typename T>
struct Ld {
  static constexpr int T_ = D + 16 / (int)sizeof(T);  // [rows, D] tiles
  static constexpr int S = BN + 4;                     // float score tile
  static constexpr int P = BN + 8;                     // bf16 p / ds tile
  static constexpr int O = D + 4;                      // float accumulator
};

template <typename T>
constexpr size_t tile_bytes(int rows) {
  return (size_t)rows * Ld<T>::T_ * sizeof(T);
}
constexpr size_t score_bytes(int rows) {
  return (size_t)rows * (BN + 4) * sizeof(float);
}
template <typename T>
constexpr size_t p_bytes(int rows) {
  return kIsBf16<T> ? (size_t)rows * (BN + 8) * 2 : 0;
}
constexpr size_t acc_bytes(int rows) {
  return (size_t)rows * (D + 4) * sizeof(float);
}

// Load rows [row0, row0 + ROWS) of a [S, D] operand into a padded tile,
// zero-filling rows >= n (they must be finite: 0 * NaN would poison a
// product even where p == 0).
template <typename T, int ROWS>
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
    *reinterpret_cast<uint4*>(dst + r * Ld<T>::T_ + c) = val;
  }
}

// c[r][j] = a_r . b_j (raw dot, f32) for r < ROWS, j < BN.
template <typename T, int ROWS>
__device__ __forceinline__ void mm_abt(const T* a_s, const T* b_s,
                                       float* c_s) {
  constexpr int LT = Ld<T>::T_;
  constexpr int LS = Ld<T>::S;
  if constexpr (kIsBf16<T>) {
    static_assert(ROWS == 64, "bf16 tiles: one 16-row strip per warp");
    const int warp = threadIdx.x >> 5;
    wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a;
    wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> b;
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> c[BN / 16];
#pragma unroll
    for (int n = 0; n < BN / 16; ++n) wmma::fill_fragment(c[n], 0.f);
#pragma unroll
    for (int kk = 0; kk < D; kk += 16) {
      wmma::load_matrix_sync(a, a_s + warp * 16 * LT + kk, LT);
#pragma unroll
      for (int n = 0; n < BN / 16; ++n) {
        // B^T as a column-major [D, BN] operand is B row-major [BN, D]
        wmma::load_matrix_sync(b, b_s + n * 16 * LT + kk, LT);
        wmma::mma_sync(c[n], a, b, c[n]);
      }
    }
#pragma unroll
    for (int n = 0; n < BN / 16; ++n)
      wmma::store_matrix_sync(c_s + warp * 16 * LS + n * 16, c[n], LS,
                              wmma::mem_row_major);
  } else {
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
}

// c[r][:] += sum_j p[r][j] * b[j][:] for r < 64, j < BN.  bf16 reads p
// from the bf16 tile pb, float32 from the float tile pf.
template <typename T>
__device__ __forceinline__ void mm_acc_ab(const __nv_bfloat16* pb,
                                          const float* pf, const T* b_s,
                                          float* c_s) {
  constexpr int LT = Ld<T>::T_;
  constexpr int LS = Ld<T>::S;
  constexpr int LP = Ld<T>::P;
  constexpr int LO = Ld<T>::O;
  if constexpr (kIsBf16<T>) {
    const int warp = threadIdx.x >> 5;
    wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a;
    wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> b;
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> c;
#pragma unroll
    for (int n = 0; n < D / 16; ++n) {
      float* tile = c_s + warp * 16 * LO + n * 16;
      wmma::load_matrix_sync(c, tile, LO, wmma::mem_row_major);
#pragma unroll
      for (int kk = 0; kk < BN; kk += 16) {
        wmma::load_matrix_sync(a, pb + warp * 16 * LP + kk, LP);
        wmma::load_matrix_sync(b, b_s + kk * LT + n * 16, LT);
        wmma::mma_sync(c, a, b, c);
      }
      wmma::store_matrix_sync(tile, c, LO, wmma::mem_row_major);
    }
  } else {
    for (int e = threadIdx.x; e < BM * D; e += NT) {
      const int r = e / D;
      const int d = e % D;
      float o = c_s[r * LO + d];
#pragma unroll 8
      for (int j = 0; j < BN; ++j) o += pf[r * LS + j] * to_f(b_s[j * LT + d]);
      c_s[r * LO + d] = o;
    }
  }
}

// c[j][:] += sum_r p[r][j] * b[r][:] for j < BN, r < ROWS (the
// transposed product of the dk/dv kernel).
template <typename T, int ROWS>
__device__ __forceinline__ void mm_acc_atb(const __nv_bfloat16* pb,
                                           const float* pf, const T* b_s,
                                           float* c_s) {
  constexpr int LT = Ld<T>::T_;
  constexpr int LS = Ld<T>::S;
  constexpr int LP = Ld<T>::P;
  constexpr int LO = Ld<T>::O;
  if constexpr (kIsBf16<T>) {
    const int warp = threadIdx.x >> 5;  // output rows [16 warp, +16)
    wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::col_major> a;
    wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> b;
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> c;
#pragma unroll
    for (int n = 0; n < D / 16; ++n) {
      float* tile = c_s + warp * 16 * LO + n * 16;
      wmma::load_matrix_sync(c, tile, LO, wmma::mem_row_major);
#pragma unroll
      for (int kk = 0; kk < ROWS; kk += 16) {
        // A(i, j) = p[kk + j][16 warp + i]: p^T read column-major
        wmma::load_matrix_sync(a, pb + kk * LP + warp * 16, LP);
        wmma::load_matrix_sync(b, b_s + kk * LT + n * 16, LT);
        wmma::mma_sync(c, a, b, c);
      }
      wmma::store_matrix_sync(tile, c, LO, wmma::mem_row_major);
    }
  } else {
    for (int e = threadIdx.x; e < BN * D; e += NT) {
      const int j = e / D;
      const int d = e % D;
      float o = c_s[j * LO + d];
#pragma unroll 8
      for (int r = 0; r < ROWS; ++r) o += pf[r * LS + j] * to_f(b_s[r * LT + d]);
      c_s[j * LO + d] = o;
    }
  }
}

// K-block trip count of a query block (flash_attention._q_trip_count).
__device__ __forceinline__ int q_trip_count(int q0, const Params& p) {
  const int nblk = (p.sk + BN - 1) / BN;
  if (!p.causal) return nblk;
  const int num = q0 + BM + (p.sk - p.sq) + BN - 1;
  return num <= 0 ? 0 : min(num / BN, nblk);
}

__device__ __forceinline__ bool visible(int qi, int kj, const Params& p) {
  return kj < p.sk && (!p.causal || kj <= qi + p.sk - p.sq);
}

// ------------------------------------------------------------- forward
template <typename T>
struct FwdSmem {
  static constexpr size_t kT = tile_bytes<T>(BM);
  static constexpr size_t kS = score_bytes(BM);
  static constexpr size_t kO = acc_bytes(BM);
  static constexpr size_t kML = 2 * BM * sizeof(float);
  static constexpr size_t kP = p_bytes<T>(BM);
  static constexpr size_t bytes = 3 * kT + kS + kO + kML + kP;
};

// Grid (ceil(Sq / 64), H, B), 128 threads.
template <typename T>
__global__ void __launch_bounds__(NT) flash_fwd_kernel(Params p) {
  using S = FwdSmem<T>;
  constexpr int LS = Ld<T>::S;
  constexpr int LO = Ld<T>::O;
  constexpr int LP = Ld<T>::P;
  extern __shared__ __align__(128) unsigned char smem[];
  T* q_t = reinterpret_cast<T*>(smem);
  T* k_t = reinterpret_cast<T*>(smem + S::kT);
  T* v_t = reinterpret_cast<T*>(smem + 2 * S::kT);
  float* s_t = reinterpret_cast<float*>(smem + 3 * S::kT);
  float* o_t = reinterpret_cast<float*>(smem + 3 * S::kT + S::kS);
  float* m_t = reinterpret_cast<float*>(smem + 3 * S::kT + S::kS + S::kO);
  float* l_t = m_t + BM;
  __nv_bfloat16* p_t = reinterpret_cast<__nv_bfloat16*>(
      smem + 3 * S::kT + S::kS + S::kO + S::kML);

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
  const int upper = q_trip_count(q0, p);

  load_tile<T, BM>(q_t, qg, p.q_s[2], q0, p.sq);
  for (int e = t; e < BM * D; e += NT) o_t[(e / D) * LO + e % D] = 0.f;
  if (t < BM) {
    m_t[t] = -INFINITY;
    l_t[t] = 0.f;
  }

  for (int kb = 0; kb < upper; ++kb) {
    const int k0 = kb * BN;
    __syncthreads();  // the previous block is done with k_t, v_t, s_t, p_t
    load_tile<T, BN>(k_t, kg, p.k_s[2], k0, p.sk);
    load_tile<T, BN>(v_t, vg, p.v_s[2], k0, p.sk);
    __syncthreads();
    mm_abt<T, BM>(q_t, k_t, s_t);
    __syncthreads();

    // online softmax: warp w owns query rows [16 w, 16 w + 16); -inf
    // stands for MASK_VAL, guarded (alpha = 1 and m taken as 0 while a
    // row has seen no visible key)
    for (int rr = 0; rr < 16; ++rr) {
      const int r = warp * 16 + rr;
      float sv[BN / 32];
      float mx = -INFINITY;
#pragma unroll
      for (int u = 0; u < BN / 32; ++u) {
        const int c = lane + 32 * u;
        const float s = visible(q0 + r, k0 + c, p) ? s_t[r * LS + c] * p.scale
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
        if constexpr (kIsBf16<T>) {
          p_t[r * LP + c] = __float2bfloat16(pe);
        } else {
          s_t[r * LS + c] = pe;
        }
      }
      sum = warp_sum(sum);
      for (int d = lane; d < D; d += 32) o_t[r * LO + d] *= alpha;
      if (lane == 0) {
        m_t[r] = m_cur;
        l_t[r] = l_t[r] * alpha + sum;
      }
    }
    __syncthreads();
    mm_acc_ab<T>(p_t, s_t, v_t, o_t);
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
  if (t < BM && q0 + t < p.sq) {
    const float l = l_t[t];
    p.lse[((long long)b * p.H + h) * p.sq + q0 + t] =
        l > 0.f ? m_t[t] + logf(l) : kLseInvalid;
  }
}

// --------------------------------------------------------- backward dq
template <typename T>
struct DqSmem {
  static constexpr size_t kT = tile_bytes<T>(BM);   // q, do, k, v
  static constexpr size_t kS = score_bytes(BM);     // s, dp
  static constexpr size_t kO = acc_bytes(BM);       // dq
  static constexpr size_t kLD = 2 * BM * sizeof(float);
  static constexpr size_t kP = p_bytes<T>(BM);      // ds (bf16)
  static constexpr size_t bytes = 4 * kT + 2 * kS + kO + kLD + kP;
};

// Grid (ceil(Sq / 64), H, B), 128 threads.
template <typename T>
__global__ void __launch_bounds__(NT) flash_bwd_dq_kernel(Params p) {
  using S = DqSmem<T>;
  constexpr int LT = Ld<T>::T_;
  constexpr int LS = Ld<T>::S;
  constexpr int LO = Ld<T>::O;
  constexpr int LP = Ld<T>::P;
  extern __shared__ __align__(128) unsigned char smem[];
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
  __nv_bfloat16* ds_t = reinterpret_cast<__nv_bfloat16*>(
      smem + 4 * S::kT + 2 * S::kS + S::kO + S::kLD);

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
  const long long row_base = ((long long)b * p.H + h) * p.sq;
  const int upper = q_trip_count(q0, p);

  load_tile<T, BM>(q_t, qg, p.q_s[2], q0, p.sq);
  load_tile<T, BM>(do_t, dog, p.do_s[2], q0, p.sq);
  for (int e = t; e < BM * D; e += NT) dq_t[(e / D) * LO + e % D] = 0.f;
  __syncthreads();
  // delta = rowsum(out * dout) in f32; lse of rows past Sq is invalid
  for (int rr = 0; rr < 16; ++rr) {
    const int r = warp * 16 + rr;
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
    __syncthreads();  // the previous block is done with k_t, v_t, s_t, ds_t
    load_tile<T, BN>(k_t, kg, p.k_s[2], k0, p.sk);
    load_tile<T, BN>(v_t, vg, p.v_s[2], k0, p.sk);
    __syncthreads();
    mm_abt<T, BM>(q_t, k_t, s_t);
    mm_abt<T, BM>(do_t, v_t, dp_t);
    __syncthreads();
    for (int e = t; e < BM * BN; e += NT) {
      const int r = e / BN;
      const int c = e % BN;
      const float pr = visible(q0 + r, k0 + c, p)
                           ? expf(s_t[r * LS + c] * p.scale - lse_t[r])
                           : 0.f;
      const float ds = pr * (dp_t[r * LS + c] - delta_t[r]) * p.scale;
      if constexpr (kIsBf16<T>) {
        ds_t[r * LP + c] = __float2bfloat16(ds);
      } else {
        s_t[r * LS + c] = ds;
      }
    }
    __syncthreads();
    mm_acc_ab<T>(ds_t, s_t, k_t, dq_t);
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
template <typename T>
struct DkvCfg {
  static constexpr int QB = kIsBf16<T> ? 64 : 32;   // streamed q rows
  static constexpr size_t kKV = tile_bytes<T>(BN);    // k, v
  static constexpr size_t kQ = tile_bytes<T>(QB);     // q, do
  static constexpr size_t kS = score_bytes(QB);       // s/p, dp/ds
  static constexpr size_t kP = p_bytes<T>(QB);        // p, ds (bf16)
  static constexpr size_t kO = acc_bytes(BN);         // dk, dv
  static constexpr size_t kLD = 2 * QB * sizeof(float);
  static constexpr size_t bytes =
      2 * kKV + 2 * kQ + 2 * kS + 2 * kP + 2 * kO + kLD;
};

// Grid (ceil(Sk / 64), kvH, B), 128 threads.
template <typename T>
__global__ void __launch_bounds__(NT) flash_bwd_dkv_kernel(Params p) {
  using C = DkvCfg<T>;
  constexpr int QB = C::QB;
  constexpr int LS = Ld<T>::S;
  constexpr int LO = Ld<T>::O;
  constexpr int LP = Ld<T>::P;
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* ptr = smem;
  T* k_t = reinterpret_cast<T*>(ptr);             ptr += C::kKV;
  T* v_t = reinterpret_cast<T*>(ptr);             ptr += C::kKV;
  T* q_t = reinterpret_cast<T*>(ptr);             ptr += C::kQ;
  T* do_t = reinterpret_cast<T*>(ptr);            ptr += C::kQ;
  float* s_t = reinterpret_cast<float*>(ptr);     ptr += C::kS;
  float* dp_t = reinterpret_cast<float*>(ptr);    ptr += C::kS;
  float* dk_t = reinterpret_cast<float*>(ptr);    ptr += C::kO;
  float* dv_t = reinterpret_cast<float*>(ptr);    ptr += C::kO;
  __nv_bfloat16* p_t = reinterpret_cast<__nv_bfloat16*>(ptr);   ptr += C::kP;
  __nv_bfloat16* ds_t = reinterpret_cast<__nv_bfloat16*>(ptr);  ptr += C::kP;
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

  load_tile<T, BN>(k_t, kg, p.k_s[2], k0, p.sk);
  load_tile<T, BN>(v_t, vg, p.v_s[2], k0, p.sk);
  for (int e = t; e < BN * D; e += NT) {
    dk_t[(e / D) * LO + e % D] = 0.f;
    dv_t[(e / D) * LO + e % D] = 0.f;
  }

  for (int j = 0; j < p.group; ++j) {
    const int h = hk * p.group + j;
    const T* qg = static_cast<const T*>(p.q) + b * p.q_s[0] + h * p.q_s[1];
    const T* dog =
        static_cast<const T*>(p.dout) + b * p.do_s[0] + h * p.do_s[1];
    const long long row_base = ((long long)b * p.H * p.group + h) * p.sq;
    for (int qb = lower; qb < nq; ++qb) {
      const int q0 = qb * QB;
      __syncthreads();  // the previous block is done with q_t .. ds_t
      load_tile<T, QB>(q_t, qg, p.q_s[2], q0, p.sq);
      load_tile<T, QB>(do_t, dog, p.do_s[2], q0, p.sq);
      if (t < QB) {
        const int qi = q0 + t;
        lse_t[t] = qi < p.sq ? p.lse[row_base + qi] : kLseInvalid;
        delta_t[t] = qi < p.sq ? p.delta[row_base + qi] : 0.f;
      }
      __syncthreads();
      mm_abt<T, QB>(q_t, k_t, s_t);
      mm_abt<T, QB>(do_t, v_t, dp_t);
      __syncthreads();
      for (int e = t; e < QB * BN; e += NT) {
        const int r = e / BN;
        const int c = e % BN;
        const int qi = q0 + r;
        const float pr = qi < p.sq && visible(qi, k0 + c, p)
                             ? expf(s_t[r * LS + c] * p.scale - lse_t[r])
                             : 0.f;
        const float ds = pr * (dp_t[r * LS + c] - delta_t[r]) * p.scale;
        if constexpr (kIsBf16<T>) {
          p_t[r * LP + c] = __float2bfloat16(pr);
          ds_t[r * LP + c] = __float2bfloat16(ds);
        } else {
          s_t[r * LS + c] = pr;
          dp_t[r * LS + c] = ds;
        }
      }
      __syncthreads();
      mm_acc_atb<T, QB>(p_t, s_t, do_t, dv_t);
      mm_acc_atb<T, QB>(ds_t, dp_t, q_t, dk_t);
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

template <typename Kern>
int launch(Kern kern, size_t smem, dim3 grid, const Params& p,
           cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kern<<<grid, NT, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

void set3(long long* dst, const long long* src) {
  dst[0] = src[0];
  dst[1] = src[1];
  dst[2] = src[2];
}

bool bad_args(int dtype, int head_dim, int B, int H, int group, int sq,
              int sk) {
  return (dtype != 0 && dtype != 1) || head_dim != D || B < 1 || H < 1 ||
         group < 1 || sq < 1 || sk < 1;
}

}  // namespace

extern "C" {

// All entries: dtype 0 = float32, 1 = bfloat16; head_dim must be 128;
// strides are int64 element strides (batch, head, sequence) per tensor
// in the order of the tensor arguments; lse/delta are contiguous
// [B, H, Sq] float32.  Each returns a cudaError_t code (0 = launched).
// Shapes are validated by the Python wrappers
// (paddle_tpu_torch/ops/pallas/flash_attention.py).

// strides: q, k, v, out (12)
int flash_attention_fwd(int dtype, int head_dim, const void* q,
                        const void* k, const void* v, void* out, void* lse,
                        int B, int H, int group, int sq, int sk, int causal,
                        float scale, const long long* strides,
                        void* stream) {
  if (bad_args(dtype, head_dim, B, H, group, sq, sk))
    return (int)cudaErrorInvalidValue;
  Params p = {};
  p.q = q;
  p.k = k;
  p.v = v;
  p.out = out;
  p.lse = static_cast<float*>(lse);
  p.H = H;
  p.group = group;
  p.sq = sq;
  p.sk = sk;
  p.causal = causal;
  p.scale = scale;
  set3(p.q_s, strides);
  set3(p.k_s, strides + 3);
  set3(p.v_s, strides + 6);
  set3(p.o_s, strides + 9);
  dim3 grid((sq + BM - 1) / BM, H, B);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch(flash_fwd_kernel<float>, FwdSmem<float>::bytes, grid, p, s);
  return launch(flash_fwd_kernel<__nv_bfloat16>,
                FwdSmem<__nv_bfloat16>::bytes, grid, p, s);
}

// strides: q, k, v, out, dout, dq (18); writes dq and delta
int flash_attention_bwd_dq(int dtype, int head_dim, const void* q,
                           const void* k, const void* v, const void* out,
                           const void* dout, const void* lse, void* delta,
                           void* dq, int B, int H, int group, int sq, int sk,
                           int causal, float scale,
                           const long long* strides, void* stream) {
  if (bad_args(dtype, head_dim, B, H, group, sq, sk))
    return (int)cudaErrorInvalidValue;
  Params p = {};
  p.q = q;
  p.k = k;
  p.v = v;
  p.o = out;
  p.dout = dout;
  p.lse = const_cast<float*>(static_cast<const float*>(lse));
  p.delta = static_cast<float*>(delta);
  p.dq = dq;
  p.H = H;
  p.group = group;
  p.sq = sq;
  p.sk = sk;
  p.causal = causal;
  p.scale = scale;
  set3(p.q_s, strides);
  set3(p.k_s, strides + 3);
  set3(p.v_s, strides + 6);
  set3(p.o_s, strides + 9);
  set3(p.do_s, strides + 12);
  set3(p.dq_s, strides + 15);
  dim3 grid((sq + BM - 1) / BM, H, B);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch(flash_bwd_dq_kernel<float>, DqSmem<float>::bytes, grid, p,
                  s);
  return launch(flash_bwd_dq_kernel<__nv_bfloat16>,
                DqSmem<__nv_bfloat16>::bytes, grid, p, s);
}

// strides: q, k, v, dout, dk, dv (18); kvH kv heads, group q heads each
int flash_attention_bwd_dkv(int dtype, int head_dim, const void* q,
                            const void* k, const void* v, const void* dout,
                            const void* lse, const void* delta, void* dk,
                            void* dv, int B, int kvH, int group, int sq,
                            int sk, int causal, float scale,
                            const long long* strides, void* stream) {
  if (bad_args(dtype, head_dim, B, kvH, group, sq, sk))
    return (int)cudaErrorInvalidValue;
  Params p = {};
  p.q = q;
  p.k = k;
  p.v = v;
  p.dout = dout;
  p.lse = const_cast<float*>(static_cast<const float*>(lse));
  p.delta = const_cast<float*>(static_cast<const float*>(delta));
  p.dk = dk;
  p.dv = dv;
  p.H = kvH;  // the kernel indexes lse/delta as (b * kvH * group + h)
  p.group = group;
  p.sq = sq;
  p.sk = sk;
  p.causal = causal;
  p.scale = scale;
  set3(p.q_s, strides);
  set3(p.k_s, strides + 3);
  set3(p.v_s, strides + 6);
  set3(p.do_s, strides + 9);
  set3(p.dk_s, strides + 12);
  set3(p.dv_s, strides + 15);
  dim3 grid((sk + BN - 1) / BN, kvH, B);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch(flash_bwd_dkv_kernel<float>, DkvCfg<float>::bytes, grid, p,
                  s);
  return launch(flash_bwd_dkv_kernel<__nv_bfloat16>,
                DkvCfg<__nv_bfloat16>::bytes, grid, p, s);
}

const char* flash_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
