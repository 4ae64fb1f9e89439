// Paged decode attention for Hopper (sm_90a).
//
// Replaces: paddle_tpu/ops/pallas/paged_attention.py:paged_attention
// (_paged_kernel, the K3 TPU kernel).  One query token per sequence
// attends over its KV pages, read from a shared pool [P, kvh, ps, D]
// through a block table [B, W]; rep = nh / kvh query heads share one KV
// head (GQA).  The mma.sync instances take every head dim that is a
// multiple of 16 from 16 to 256; a CUDA-core body takes every other head
// dim (paged_attention_any_fwd, at the end).  Any group, any page size.
// Only keys below lens[b] are read: the pages that pad a table row,
// the dump page among them, are never touched.
//
// Numerics follow the TPU kernel, not the dense-gather reference:
// scores and the online-softmax state (m, l, acc) are f32, keys at
// t >= lens[b] are masked, and p is rounded to the value dtype before
// the P.V product (paged_attention.py:111-113) while l sums the
// unrounded p.  With lens[b] == 0 the row is written as zeros (l_safe,
// :119); the reference paged_attention_xla gives NaN there.
//
// What bounds it on the H100: bytes.  Decode reads every visible K/V
// row once (2 * lens * D * itemsize per kv head) and does ~4 * rep
// flops per byte, far below the ~295 flop/byte ridge, so the floor is
// the KV bytes over 3.35 TB/s.  Everything below serves keeping the HBM
// busy: many CTAs, loads in flight while the math runs, one launch.
//
// The bf16 kernel (paged_mma_kernel), on the pattern of K7
// (decode_attention.cu):
//   * one CTA per (sequence and kv head, group of 16 query heads, key
//     split): the 16 query heads are the M of mma.sync.m16n8k16 (bf16
//     in, f32 accumulate), so any group works (grid.y runs over the
//     groups of 16; rows past rep are zero and never stored).  The key
//     split is grid.z, the slowest index, so the CTAs of the first
//     splits, which every row with a key runs, are dispatched first;
//   * K and V come in 64-key tiles through a 3-stage cp.async ring of
//     16-byte copies.  Key t of row b is row t % ps of page
//     table[b, t / ps], so a tile may span pages (ps < 64) or be part
//     of one (ps > 64), and any page size works.  The table is read one
//     tile ahead of the copies, during a tile's math, into a small
//     shared table of pool rows, so no copy waits on a table read;
//     copies of keys at or past lens[b] are zero-filled, not read.
//     Rows are laid out for conflict-free ldmatrix: at D 64, 128 and
//     256 (8 or more 16-byte chunks a row, a power of two) chunk c of
//     row r sits at c ^ (r & 7), and at D 32 (4 chunks: rows r and
//     r + 2 would share banks at a 64-byte stride) at c ^ ((r >> 1) &
//     3).  Every other head dim (a multiple of 16 that is not a power of
//     two, and 16 itself, 2 chunks a row) has D / 8 + 1 chunks a row,
//     one of padding: the row stride is an odd number of 16-byte units,
//     so 8 consecutive rows at one chunk fall in 8 different bank
//     groups without any XOR (an XOR would leave a row of D / 8 chunks
//     when D / 8 is not a power of two);
//   * each of the 4 warps owns 16 keys of every tile: S = Q.K^T (two n8
//     tiles, K by ldmatrix), the online softmax on the accumulator
//     registers, then O += P.V with P packed to bf16 straight from the
//     S accumulators (the m16n8 C layout of two key tiles is the A
//     layout of one k16 step) and V by ldmatrix.trans.  The warps'
//     (m, l, O) are merged in shared memory at the end, in warp order;
//   * one launch.  The wrapper picks the split count from shapes only
//     (the table span W * ps, not lens, which stays on the device).  A
//     split that starts at or past lens[b] returns at once: the merge
//     counts only the n_act = ceil(lens[b] / chunk) splits that hold a
//     key, so it waits on no partial from them.  With one split each
//     CTA writes the output directly; with more, each active CTA writes
//     its partial (m, l, acc) in f32 and takes a ticket from an atomic
//     counter of its (sequence, kv head, group); the CTA that takes the
//     last one merges the partials in split order, writes the output
//     and resets the counter for the next launch.  The merge order is
//     fixed, so reruns give the same bits.
//
// The float32 instance (the card-vs-CPU parity runs) keeps a simple
// CUDA-core body: split-T partials of 256 keys (one warp per key for
// the scores, one thread per head-dim column for P.V, in D rounded up
// to whole warps) and a combine pass, no tensor cores, so that it
// agrees with the CPU to f32 rounding.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "warp_mma.cuh"

namespace {

constexpr int kTile = 64;        // keys per ring stage
constexpr int kStages = 3;       // ring depth
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kRows = 16;        // query heads per CTA (the mma M)
constexpr int kMaxSplit = 64;    // _MAX_SPLIT in Python
constexpr int kChunkF32 = 256;   // keys per CTA of the f32 first pass

// ------------------------------------------------------ the bf16 kernel
// Shared memory: Q [16, D], then the ring of kStages (K, V) tile pairs,
// each row of D bf16 stored as D / 8 swizzled chunks of 16 bytes.
// After the key loop the ring holds the warps' (m, l) and O for the
// merge, then the splits' weights.
// the head dims whose rows take the XOR swizzle; every other one is padded
template <int D>
constexpr bool kXorRows = D == 32 || D == 64 || D == 128 || D == 256;

template <int D>
struct Smem {
  static constexpr int kRowBytes = kXorRows<D> ? D * 2 : (D / 8 + 1) * 16;
  static constexpr int kTileBytes = kTile * kRowBytes;
  static constexpr int kQ = 0;
  static constexpr int kRing = kRows * kRowBytes;
  static constexpr int kBytes = kRing + kStages * 2 * kTileBytes;
  static constexpr int kO = kRing;                           // [warp][16][D]
  static constexpr int kML = kO + kWarps * kRows * D * 4;    // [warp][16][2]
  static constexpr int kW = kML + kWarps * kRows * 2 * 4;    // [16][splits]
  static_assert(kW + kRows * kMaxSplit * 4 <= kBytes,
                "the merge areas fit in the ring");
};

template <int D>
__device__ __forceinline__ uint32_t swz(int r, int c) {
  if constexpr (!kXorRows<D>)
    return r * Smem<D>::kRowBytes + (c << 4);
  else if constexpr (D == 32)
    return r * Smem<D>::kRowBytes + ((c ^ ((r >> 1) & 3)) << 4);
  else
    return r * Smem<D>::kRowBytes + ((c ^ (r & 7)) << 4);
}

// Grid (B * kvh, ceil(rep / 16), n_split), kThreads threads.  q [B, nh,
// D]; kpool/vpool [P, kvh, ps, D]; table [B, W]; lens [B]; out [B, nh,
// D].  With n_split > 1: part_ml [ctas, n_split, 16, 2] (m in log2
// units, l) and part_o [ctas, n_split, 16, D] (acc, unnormalised),
// tickets [ctas] int32 zeroed before the first launch (each launch
// leaves them zero), ctas = B * kvh * gridDim.y.  sl2 = log2(e) /
// sqrt(D).
template <int D>
__global__ void __launch_bounds__(kThreads) paged_mma_kernel(
    const __nv_bfloat16* __restrict__ q,
    const __nv_bfloat16* __restrict__ kpool,
    const __nv_bfloat16* __restrict__ vpool, const int* __restrict__ table,
    const int* __restrict__ lens, __nv_bfloat16* __restrict__ out,
    float* __restrict__ part_ml, float* __restrict__ part_o,
    int* __restrict__ tickets, int kvh, int rep, int ps, int W, int chunk,
    float sl2) {
  using S = Smem<D>;
  constexpr int kChunks = D / 8;            // 16-byte chunks per row
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ uint32_t rows_s[kStages + 1][kTile];   // pool rows of tiles
  __shared__ int last;
  const uint32_t sbase = smem_u32(smem);
  const int split = blockIdx.z, n_split = gridDim.z;
  const int b = blockIdx.x / kvh, g = blockIdx.x % kvh;
  const int cta = blockIdx.x * gridDim.y + blockIdx.y;
  const int h0 = g * rep + blockIdx.y * kRows;   // the CTA's first q head
  const int nrows = min(kRows, rep - (int)blockIdx.y * kRows);
  const int nh = kvh * rep;
  const int vis = max(0, min(lens[b], W * ps));
  const int n_act = vis > 0 ? (vis + chunk - 1) / chunk : 1;
  if (split >= n_act) return;               // wholly past lens[b]
  const int lo = split * chunk, hi = min(lo + chunk, vis);
  const int ntiles = (hi - lo + kTile - 1) / kTile;   // 0 when vis == 0
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gi = lane >> 2, ti = lane & 3;
  const int* trow = table + (size_t)b * W;
  const size_t head_off = (size_t)g * ps * D;
  // key t's row of the pool in units of D: page * kvh * ps + t % ps
  const auto pool_row = [&](int t) -> uint32_t {
    const int pi = t / ps;
    return (uint32_t)trow[pi] * (uint32_t)(kvh * ps) + (uint32_t)(t - pi * ps);
  };

  for (int e = tid; e < kRows * kChunks; e += kThreads) {
    const int r = e / kChunks, c = e % kChunks;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (r < nrows)
      v = *reinterpret_cast<const uint4*>(q + ((size_t)b * nh + h0 + r) * D +
                                          c * 8);
    *reinterpret_cast<uint4*>(smem + S::kQ + swz<D>(r, c)) = v;
  }
  for (int e = tid; e < kStages * kTile; e += kThreads) {
    const int t = lo + e;                   // tiles 0 .. kStages - 1
    if (t < hi) rows_s[e / kTile][e % kTile] = pool_row(t);
  }
  __syncthreads();

  // tile i of the split into its stage: keys past hi zero-filled, unread
  const auto load_tile = [&](int i) {
    const int t0 = lo + i * kTile;
    const uint32_t ks = sbase + S::kRing + (i % kStages) * 2 * S::kTileBytes;
    const uint32_t vs = ks + S::kTileBytes;
    const uint32_t* rows = rows_s[i % (kStages + 1)];
#pragma unroll 4
    for (int e = tid; e < kTile * kChunks; e += kThreads) {
      const int r = e / kChunks, c = e % kChunks;
      const bool ok = t0 + r < hi;
      const size_t off = ok ? (size_t)rows[r] * D + head_off + c * 8 : 0;
      cp16(ks + swz<D>(r, c), kpool + off, ok);
      cp16(vs + swz<D>(r, c), vpool + off, ok);
    }
  };

  float o[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[j][e] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < ntiles) load_tile(s);
    cp_commit();
  }
  const int kw = warp * 16;                 // the warp's keys of a tile
  for (int i = 0; i < ntiles; ++i) {
    cp_wait<kStages - 2>();                 // tile i's copies (own)
    __syncthreads();                        // everyone's; tile i - 1 done
    if (i + kStages - 1 < ntiles) load_tile(i + kStages - 1);
    cp_commit();
    // the pool rows of tile i + kStages: read now, stored after the math
    const int tn = lo + (i + kStages) * kTile + tid;
    const uint32_t next_row = tid < kTile && tn < hi ? pool_row(tn) : 0u;
    const int t0 = lo + i * kTile;
    if (t0 + kw < hi) {  // else the warp's keys are all past lens
      const uint32_t ks =
          sbase + S::kRing + (i % kStages) * 2 * S::kTileBytes;
      const uint32_t vs = ks + S::kTileBytes;

      // S = Q.K^T over the warp's 16 keys: two n8 tiles
      float sc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        uint32_t a[4], bk[4];
        ldsm_x4(a, sbase + S::kQ + swz<D>(lane & 15, 2 * kk + (lane >> 4)));
        ldsm_x4(bk, ks + swz<D>(kw + (lane & 7) + ((lane >> 4) << 3),
                                2 * kk + ((lane >> 3) & 1)));
        mma16816(sc[0], a, bk[0], bk[1]);
        mma16816(sc[1], a, bk[2], bk[3]);
      }

      // online softmax of rows gi and gi + 8 (log2 units); keys >= hi masked
      float alpha[2];
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          sc[n][e] = t0 + kw + 8 * n + 2 * ti + (e & 1) < hi ? sc[n][e] * sl2
                                                              : -INFINITY;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float mx = fmaxf(fmaxf(sc[0][2 * r], sc[0][2 * r + 1]),
                         fmaxf(sc[1][2 * r], sc[1][2 * r + 1]));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float mn = fmaxf(m[r], mx);
        const bool dead = mn == -INFINITY;
        alpha[r] = dead ? 1.f : exp2f(m[r] - mn);
        const float ms = dead ? 0.f : mn;
        float sum = 0.f;
#pragma unroll
        for (int n = 0; n < 2; ++n)
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const float p = exp2f(sc[n][2 * r + c] - ms);
            sc[n][2 * r + c] = p;
            sum += p;              // l sums the unrounded p (quad partials)
          }
        l[r] = l[r] * alpha[r] + sum;
        m[r] = mn;
      }
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        o[j][0] *= alpha[0];
        o[j][1] *= alpha[0];
        o[j][2] *= alpha[1];
        o[j][3] *= alpha[1];
      }

      // O += P.V: P rounded to bf16, the S accumulators as the A fragment
      const uint32_t pa[4] = {pack_bf16(sc[0][0], sc[0][1]),
                              pack_bf16(sc[0][2], sc[0][3]),
                              pack_bf16(sc[1][0], sc[1][1]),
                              pack_bf16(sc[1][2], sc[1][3])};
#pragma unroll
      for (int jj = 0; jj < D / 16; ++jj) {
        uint32_t bv[4];
        ldsm_x4_t(bv, vs + swz<D>(kw + (lane & 7) + (((lane >> 3) & 1) << 3),
                                  2 * jj + (lane >> 4)));
        mma16816(o[2 * jj], pa, bv[0], bv[1]);
        mma16816(o[2 * jj + 1], pa, bv[2], bv[3]);
      }
    }
    if (tid < kTile) rows_s[(i + kStages) % (kStages + 1)][tid] = next_row;
  }
  cp_wait<0>();
  __syncthreads();                          // the ring is free

  // merge the warps' (m, l, O) in warp order
  float* o_s = reinterpret_cast<float*>(smem + S::kO);
  float* ml_s = reinterpret_cast<float*>(smem + S::kML);
  float* w_s = reinterpret_cast<float*>(smem + S::kW);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int r = 0; r < 2; ++r)
      *reinterpret_cast<float2*>(o_s + (warp * kRows + gi + 8 * r) * D +
                                 8 * j + 2 * ti) =
          make_float2(o[j][2 * r], o[j][2 * r + 1]);
  if (ti == 0)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      ml_s[(warp * kRows + gi + 8 * r) * 2] = m[r];
      ml_s[(warp * kRows + gi + 8 * r) * 2 + 1] = l[r];
    }
  __syncthreads();
  // per row: the merged max and each warp's weight e^(m_w - M), over L
  // when this split is the only one
  if (tid < kRows) {
    float mx = -INFINITY, sum = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, ml_s[(w * kRows + tid) * 2]);
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float wt =
          mx == -INFINITY ? 0.f : exp2f(ml_s[(w * kRows + tid) * 2] - mx);
      w_s[tid * kWarps + w] = wt;
      sum += ml_s[(w * kRows + tid) * 2 + 1] * wt;
    }
    if (n_split == 1) {
      const float inv = sum > 0.f ? 1.f / sum : 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) w_s[tid * kWarps + w] *= inv;
    } else {
      float* pml = part_ml + (((size_t)cta * n_split + split) * kRows + tid) * 2;
      pml[0] = mx;
      pml[1] = sum;
    }
  }
  __syncthreads();
  for (int e = tid; e < nrows * D; e += kThreads) {
    const int r = e / D, c = e % D;
    float acc = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w)
      acc += o_s[(w * kRows + r) * D + c] * w_s[r * kWarps + w];
    if (n_split == 1) {
      out[((size_t)b * nh + h0 + r) * D + c] = __float2bfloat16(acc);
    } else {
      part_o[(((size_t)cta * n_split + split) * kRows + r) * D + c] = acc;
    }
  }
  if (n_split == 1) return;

  // the ticket: the last of the n_act active splits merges them
  __threadfence();
  __syncthreads();
  if (tid == 0) last = atomicAdd(tickets + cta, 1) == n_act - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  // every split's (m, l) into shared memory at once (the O area is free),
  // then each row's weights; the partial outputs by 16-byte loads, eight
  // splits in flight
  const float* pml = part_ml + (size_t)cta * n_split * kRows * 2;
  float* ml_all = o_s;                      // [n_act][16][2]
  for (int e = tid; e < n_act * kRows * 2; e += kThreads)
    ml_all[e] = __ldcg(pml + e);
  __syncthreads();
  if (tid < nrows) {
    float mx = -INFINITY, sum = 0.f;
    for (int s = 0; s < n_act; ++s)
      mx = fmaxf(mx, ml_all[(s * kRows + tid) * 2]);
    for (int s = 0; s < n_act; ++s) {
      const float wt =
          mx == -INFINITY ? 0.f : exp2f(ml_all[(s * kRows + tid) * 2] - mx);
      w_s[tid * kMaxSplit + s] = wt;
      sum += ml_all[(s * kRows + tid) * 2 + 1] * wt;
    }
    const float inv = sum > 0.f ? 1.f / sum : 0.f;
    for (int s = 0; s < n_act; ++s) w_s[tid * kMaxSplit + s] *= inv;
  }
  __syncthreads();
  const float4* po = reinterpret_cast<const float4*>(
      part_o + (size_t)cta * n_split * kRows * D);
  for (int e = tid; e < nrows * (D / 4); e += kThreads) {
    const int r = e / (D / 4), c = e % (D / 4);
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 8
    for (int s = 0; s < n_act; ++s) {
      const float4 v = __ldcg(po + ((size_t)s * kRows + r) * (D / 4) + c);
      const float wt = w_s[r * kMaxSplit + s];
      acc.x += v.x * wt;
      acc.y += v.y * wt;
      acc.z += v.z * wt;
      acc.w += v.w * wt;
    }
    __nv_bfloat16* dst = out + ((size_t)b * nh + h0 + r) * D + 4 * c;
    *reinterpret_cast<uint2*>(dst) =
        make_uint2(pack_bf16(acc.x, acc.y), pack_bf16(acc.z, acc.w));
  }
  if (tid == 0) tickets[cta] = 0;           // ready for the next launch
}

template <int D>
int launch_mma(const void* q, const void* kpool, const void* vpool,
               const void* table, const void* lens, void* out, void* part_ml,
               void* part_o, void* tickets, int B, int kvh, int rep, int ps,
               int W, int n_split, int chunk, float sm_scale,
               cudaStream_t stream) {
  const int smem = Smem<D>::kBytes;
  auto kern = paged_mma_kernel<D>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(B * kvh, (rep + kRows - 1) / kRows, n_split);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(kpool),
      static_cast<const __nv_bfloat16*>(vpool),
      static_cast<const int*>(table), static_cast<const int*>(lens),
      static_cast<__nv_bfloat16*>(out), static_cast<float*>(part_ml),
      static_cast<float*>(part_o), static_cast<int*>(tickets), kvh, rep, ps,
      W, chunk, sm_scale * 1.4426950408889634f);
  return (int)cudaGetLastError();
}

// ----------------------------------------------------- the f32 kernels
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

// Threads of a pass-1 CTA: D rounded up to whole warps.
template <int D>
constexpr int kF32Threads = (D + 31) / 32 * 32;

// Pass 1.  Grid (n_chunks, B * kvh, ceil(rep / 16)), kF32Threads<D>
// threads: each CTA takes one 256-key chunk of one (sequence, kv head)
// for up to 16 query heads, in 64-key tiles gathered row by row from the
// pages, and writes its partial (m, l, acc) to part_ml [B * nh,
// n_chunks, 2] and part_o [B * nh, n_chunks, D].  Thread t < D owns
// head-dim column t of P.V; lane i of a warp owns columns [i * kPer,
// (i + 1) * kPer) of a score's dot product.
template <int D>
__global__ void __launch_bounds__(kF32Threads<D>) paged_f32_partial_kernel(
    const float* __restrict__ q, const float* __restrict__ kpool,
    const float* __restrict__ vpool, const int* __restrict__ table,
    const int* __restrict__ lens, float* __restrict__ part_ml,
    float* __restrict__ part_o, int kvh, int rep, int ps, int W,
    int n_chunks, float sm_scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  float* k_s = reinterpret_cast<float*>(smem);           // [kTile][D]
  float* v_s = k_s + kTile * D;                          // [kTile][D]
  float* q_s = v_s + kTile * D;                          // [16][D]
  float* p_s = q_s + kRows * D;                          // [16][kTile]
  float* m_s = p_s + kRows * kTile;                      // [16]
  float* l_s = m_s + kRows;                              // [16]
  float* a_s = l_s + kRows;                              // [16] alpha

  constexpr int kNT = kF32Threads<D>;
  constexpr int kW = kNT / 32;             // warps
  constexpr int kPer = kNT / 32;           // head-dim elements per lane
  // whether lane's element e of a dot product lies inside the head dim
  // (always, at the head dims that are whole warps)
  const auto in_d = [](int lane, int e) {
    return D % 32 == 0 || lane * kPer + e < D;
  };
  const int c = blockIdx.x;
  const int b = blockIdx.y / kvh;
  const int g = blockIdx.y % kvh;
  const int r0 = blockIdx.z * kRows;       // first head of the group
  const int nr = min(kRows, rep - r0);
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  const int nh = kvh * rep;
  const int lo = c * kChunkF32;
  const int hi = min(lo + kChunkF32, min(lens[b], W * ps));
  if (lo >= hi) return;  // wholly past lens[b]: pass 2 never reads it

  if (D % 32 == 0 || t < D)
    for (int r = 0; r < nr; ++r)
      q_s[r * D + t] = q[((size_t)b * nh + g * rep + r0 + r) * D + t];
  if (t < nr) {
    m_s[t] = -INFINITY;
    l_s[t] = 0.f;
  }
  float acc[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) acc[r] = 0.f;
  __syncthreads();

  const int* trow = table + (size_t)b * W;
  for (int t0 = lo; t0 < hi; t0 += kTile) {
    const int n = min(kTile, hi - t0);  // keys of this tile, all visible
    float4* kdst = reinterpret_cast<float4*>(k_s);
    float4* vdst = reinterpret_cast<float4*>(v_s);
    for (int e = t; e < n * (D / 4); e += kNT) {
      const int j = e / (D / 4), tok = t0 + j, pi = tok / ps;
      const size_t row = (((size_t)trow[pi] * kvh + g) * ps + tok - pi * ps) * D;
      kdst[e] = reinterpret_cast<const float4*>(kpool + row)[e % (D / 4)];
      vdst[e] = reinterpret_cast<const float4*>(vpool + row)[e % (D / 4)];
    }
    __syncthreads();

    // scores s[r][j] = q_r . k_j * scale, one warp per key
    for (int j = warp; j < n; j += kW) {
      float kf[kPer];
#pragma unroll
      for (int e = 0; e < kPer; ++e)
        kf[e] = in_d(lane, e) ? k_s[j * D + lane * kPer + e] : 0.f;
      for (int r = 0; r < nr; ++r) {
        float s = 0.f;
#pragma unroll
        for (int e = 0; e < kPer; ++e)
          if (in_d(lane, e)) s += q_s[r * D + lane * kPer + e] * kf[e];
        s = warp_sum(s);
        if (lane == 0) p_s[r * kTile + j] = s * sm_scale;
      }
    }
    __syncthreads();

    // online softmax, one warp per query row; n >= 1, so m_cur is finite
    for (int r = warp; r < nr; r += kW) {
      float mx = -INFINITY;
      for (int j = lane; j < n; j += 32) mx = fmaxf(mx, p_s[r * kTile + j]);
      mx = warp_max(mx);
      const float m_prev = m_s[r];
      const float m_cur = fmaxf(m_prev, mx);
      float sum = 0.f;
      for (int j = lane; j < n; j += 32) {
        const float p = expf(p_s[r * kTile + j] - m_cur);
        sum += p;
        p_s[r * kTile + j] = p;
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
    for (int r = 0; r < kRows; ++r) {
      if (r < nr && (D % 32 == 0 || t < D)) {
        float o = acc[r] * a_s[r];
        for (int j = 0; j < n; ++j) o += p_s[r * kTile + j] * v_s[j * D + t];
        acc[r] = o;
      }
    }
    __syncthreads();  // the next tile overwrites k_s, v_s and p_s
  }

  if (D % 32 != 0 && t >= D) return;
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    if (r < nr) {
      const size_t row = ((size_t)b * nh + g * rep + r0 + r) * n_chunks + c;
      part_o[row * D + t] = acc[r];
      if (t == 0) {
        part_ml[row * 2] = m_s[r];
        part_ml[row * 2 + 1] = l_s[r];
      }
    }
  }
}

// Pass 2.  Grid B * nh, D threads: out[b, h] = sum_c acc_c * e^(m_c - m) /
// sum_c l_c * e^(m_c - m) over the chunks pass 1 wrote; zeros when
// lens[b] == 0.
template <int D>
__global__ void __launch_bounds__(D) paged_f32_combine_kernel(
    const float* __restrict__ part_ml, const float* __restrict__ part_o,
    const int* __restrict__ lens, float* __restrict__ out, int nh, int span,
    int n_chunks) {
  const int bh = blockIdx.x;
  const int t = threadIdx.x;
  const int hi = max(0, min(lens[bh / nh], span));
  const int nc = (hi + kChunkF32 - 1) / kChunkF32;
  const float* pml = part_ml + (size_t)bh * n_chunks * 2;
  const float* pa = part_o + (size_t)bh * n_chunks * D;
  float m = -INFINITY;
  for (int c = 0; c < nc; ++c) m = fmaxf(m, pml[2 * c]);
  float l = 0.f, o = 0.f;
  for (int c = 0; c < nc; ++c) {
    const float w = expf(pml[2 * c] - m);
    l += pml[2 * c + 1] * w;
    o += pa[(size_t)c * D + t] * w;
  }
  out[(size_t)bh * D + t] = nc > 0 ? o / l : 0.f;
}

template <int D>
int launch_f32(const void* q, const void* kpool, const void* vpool,
               const void* table, const void* lens, void* out, void* part_ml,
               void* part_o, int B, int kvh, int rep, int ps, int W,
               int n_chunks, float sm_scale, cudaStream_t stream) {
  const int smem =
      (2 * kTile * D + kRows * D + kRows * kTile + 3 * kRows) * 4;
  auto partial = paged_f32_partial_kernel<D>;
  cudaError_t err = cudaFuncSetAttribute(
      partial, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  partial<<<dim3(n_chunks, B * kvh, (rep + kRows - 1) / kRows),
            kF32Threads<D>, smem, stream>>>(static_cast<const float*>(q),
                      static_cast<const float*>(kpool),
                      static_cast<const float*>(vpool),
                      static_cast<const int*>(table),
                      static_cast<const int*>(lens),
                      static_cast<float*>(part_ml),
                      static_cast<float*>(part_o), kvh, rep, ps, W, n_chunks,
                      sm_scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  paged_f32_combine_kernel<D><<<B * kvh * rep, D, 0, stream>>>(
      static_cast<const float*>(part_ml), static_cast<const float*>(part_o),
      static_cast<const int*>(lens), static_cast<float*>(out), kvh * rep,
      W * ps, n_chunks);
  return (int)cudaGetLastError();
}

template <int D>
int launch(int dtype, const void* q, const void* kpool, const void* vpool,
           const void* table, const void* lens, void* out, void* part_ml,
           void* part_o, void* tickets, int B, int kvh, int rep, int ps,
           int W, int n_split, int chunk, float sm_scale,
           cudaStream_t stream) {
  if (dtype == 0)
    return launch_f32<D>(q, kpool, vpool, table, lens, out, part_ml, part_o,
                         B, kvh, rep, ps, W, n_split, sm_scale, stream);
  return launch_mma<D>(q, kpool, vpool, table, lens, out, part_ml, part_o,
                       tickets, B, kvh, rep, ps, W, n_split, chunk, sm_scale,
                       stream);
}

// ------------------------------------------ the CUDA-core body, any D
// The head dims that no mma.sync instance serves (not a multiple of 16,
// or above 256), in float32 and bfloat16, with D a run-time argument.
// The same two passes as the f32 instances: pass 1 takes one chunk of
// ``chunk`` keys of one (sequence, kv head) for up to ``rows`` query
// heads, in tiles of ``tile`` keys gathered row by row from the pages;
// pass 2 merges the chunks in chunk order (so reruns give the same
// bits).  K, V, Q and the accumulators sit in shared memory as f32
// (the wrapper picks ``tile`` and ``rows`` so that they fit); scores
// and the online softmax are f32, and in bf16 p is rounded to bf16
// before P.V while l sums the unrounded p, as the mma body does.
// Threads: D rounded up to whole warps, at most 256; lanes past D idle
// in the loops over D.  Bytes bound it as they bound every K3 body; this
// one spends no effort on reaching that bound (one key's dot product per
// warp, or per thread below D 32).
template <typename T>
__device__ __forceinline__ float to_f32(T x);
template <>
__device__ __forceinline__ float to_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

constexpr int kAnyThreads = 256;   // threads of a CTA, at most

// Pass 1.  Grid (n_chunks, B * kvh, ceil(rep / rows)); part_ml [B * nh,
// n_chunks, 2] (m, l), part_o [B * nh, n_chunks, D] (acc, unnormalised).
template <typename T>
__global__ void __launch_bounds__(kAnyThreads) paged_any_partial_kernel(
    const T* __restrict__ q, const T* __restrict__ kpool,
    const T* __restrict__ vpool, const int* __restrict__ table,
    const int* __restrict__ lens, float* __restrict__ part_ml,
    float* __restrict__ part_o, int D, int kvh, int rep, int ps, int W,
    int n_chunks, int chunk, int tile, int rows, float sm_scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  float* k_s = reinterpret_cast<float*>(smem);   // [tile][D]
  float* v_s = k_s + tile * D;                   // [tile][D]
  float* q_s = v_s + tile * D;                   // [rows][D]
  float* o_s = q_s + rows * D;                   // [rows][D]
  float* p_s = o_s + rows * D;                   // [rows][tile]
  float* m_s = p_s + rows * tile;                // [rows]
  float* l_s = m_s + rows;                       // [rows]
  float* a_s = l_s + rows;                       // [rows] alpha
  const int c = blockIdx.x;
  const int b = blockIdx.y / kvh, g = blockIdx.y % kvh;
  const int r0 = blockIdx.z * rows;
  const int nr = min(rows, rep - r0);
  const int nt = blockDim.x, t = threadIdx.x;
  const int lane = t & 31, warp = t >> 5, nw = nt >> 5;
  const int nh = kvh * rep;
  const int lo = c * chunk;
  const int hi = min(lo + chunk, min(lens[b], W * ps));
  if (lo >= hi) return;  // wholly past lens[b]: pass 2 never reads it

  const size_t q0 = ((size_t)b * nh + g * rep + r0) * D;
  for (int e = t; e < nr * D; e += nt) {
    q_s[e] = to_f32(q[q0 + e]);
    o_s[e] = 0.f;
  }
  if (t < nr) {
    m_s[t] = -INFINITY;
    l_s[t] = 0.f;
  }
  __syncthreads();

  const int* trow = table + (size_t)b * W;
  for (int t0 = lo; t0 < hi; t0 += tile) {
    const int n = min(tile, hi - t0);  // keys of this tile, all visible
    for (int e = t; e < n * D; e += nt) {
      const int j = e / D, d = e - j * D, tok = t0 + j, pi = tok / ps;
      const size_t row = (((size_t)trow[pi] * kvh + g) * ps + tok - pi * ps) * D;
      k_s[e] = to_f32(kpool[row + d]);
      v_s[e] = to_f32(vpool[row + d]);
    }
    __syncthreads();

    // scores s[r][j] = q_r . k_j * scale
    if (D >= 32) {  // one warp per (row, key), lanes over the head dim
      for (int pr = warp; pr < nr * n; pr += nw) {
        const int r = pr / n, j = pr - r * n;
        float s = 0.f;
        for (int d = lane; d < D; d += 32) s += q_s[r * D + d] * k_s[j * D + d];
        s = warp_sum(s);
        if (lane == 0) p_s[r * tile + j] = s * sm_scale;
      }
    } else {  // one thread per (row, key)
      for (int pr = t; pr < nr * n; pr += nt) {
        const int r = pr / n, j = pr - r * n;
        float s = 0.f;
        for (int d = 0; d < D; ++d) s += q_s[r * D + d] * k_s[j * D + d];
        p_s[r * tile + j] = s * sm_scale;
      }
    }
    __syncthreads();

    // online softmax, one warp per query row; n >= 1, so m_cur is finite
    for (int r = warp; r < nr; r += nw) {
      float mx = -INFINITY;
      for (int j = lane; j < n; j += 32) mx = fmaxf(mx, p_s[r * tile + j]);
      mx = warp_max(mx);
      const float m_prev = m_s[r];
      const float m_cur = fmaxf(m_prev, mx);
      float sum = 0.f;
      for (int j = lane; j < n; j += 32) {
        const float p = expf(p_s[r * tile + j] - m_cur);
        sum += p;
        p_s[r * tile + j] = to_f32(from_f32<T>(p));   // p in v's dtype
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

    // acc[r][d] = acc * alpha + sum_j p[r][j] * v[j][d]
    for (int e = t; e < nr * D; e += nt) {
      const int r = e / D, d = e - r * D;
      float o = o_s[e] * a_s[r];
      for (int j = 0; j < n; ++j) o += p_s[r * tile + j] * v_s[j * D + d];
      o_s[e] = o;
    }
    __syncthreads();  // the next tile overwrites k_s, v_s and p_s
  }

  const size_t row0 = ((size_t)b * nh + g * rep + r0) * n_chunks + c;
  for (int e = t; e < nr * D; e += nt) {
    const int r = e / D, d = e - r * D;
    part_o[(row0 + (size_t)r * n_chunks) * D + d] = o_s[e];
  }
  if (t < nr) {
    part_ml[(row0 + (size_t)t * n_chunks) * 2] = m_s[t];
    part_ml[(row0 + (size_t)t * n_chunks) * 2 + 1] = l_s[t];
  }
}

// Pass 2.  Grid B * nh: out[b, h] = sum_c acc_c e^(m_c - m) / sum_c l_c
// e^(m_c - m) over the chunks pass 1 wrote, in chunk order; zeros when
// lens[b] == 0.
template <typename T>
__global__ void __launch_bounds__(kAnyThreads) paged_any_combine_kernel(
    const float* __restrict__ part_ml, const float* __restrict__ part_o,
    const int* __restrict__ lens, T* __restrict__ out, int D, int nh,
    int span, int n_chunks, int chunk) {
  const int bh = blockIdx.x;
  const int hi = max(0, min(lens[bh / nh], span));
  const int nc = (hi + chunk - 1) / chunk;
  const float* pml = part_ml + (size_t)bh * n_chunks * 2;
  const float* pa = part_o + (size_t)bh * n_chunks * D;
  float m = -INFINITY;
  for (int c = 0; c < nc; ++c) m = fmaxf(m, pml[2 * c]);
  for (int d = threadIdx.x; d < D; d += blockDim.x) {
    float l = 0.f, o = 0.f;
    for (int c = 0; c < nc; ++c) {
      const float w = expf(pml[2 * c] - m);
      l += pml[2 * c + 1] * w;
      o += pa[(size_t)c * D + d] * w;
    }
    out[(size_t)bh * D + d] = from_f32<T>(nc > 0 ? o / l : 0.f);
  }
}

template <typename T>
int launch_any(const void* q, const void* kpool, const void* vpool,
               const void* table, const void* lens, void* out, void* part_ml,
               void* part_o, int D, int B, int kvh, int rep, int ps, int W,
               int n_chunks, int chunk, int tile, int rows, float sm_scale,
               cudaStream_t stream) {
  const int threads = min((D + 31) / 32 * 32, kAnyThreads);
  const int smem = (2 * tile * D + 2 * rows * D + rows * tile + 3 * rows) * 4;
  auto partial = paged_any_partial_kernel<T>;
  cudaError_t err = cudaFuncSetAttribute(
      partial, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  partial<<<dim3(n_chunks, B * kvh, (rep + rows - 1) / rows), threads, smem,
            stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(kpool),
      static_cast<const T*>(vpool), static_cast<const int*>(table),
      static_cast<const int*>(lens), static_cast<float*>(part_ml),
      static_cast<float*>(part_o), D, kvh, rep, ps, W, n_chunks, chunk, tile,
      rows, sm_scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  paged_any_combine_kernel<T><<<B * kvh * rep, threads, 0, stream>>>(
      static_cast<const float*>(part_ml), static_cast<const float*>(part_o),
      static_cast<const int*>(lens), static_cast<T*>(out), D, kvh * rep,
      W * ps, n_chunks, chunk);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16; head_dim a multiple of 16, 16 to 256.
// Returns a cudaError_t code (0 = launched).  Shapes are validated by
// the Python wrapper (paddle_tpu_torch/ops/pallas/paged_attention.py),
// which also picks n_split and chunk over the table span W * ps.
// bfloat16: n_split key splits of ``chunk`` keys (a multiple of 64;
// n_split = ceil(W * ps / chunk) <= 64), part_ml / part_o / tickets as
// paged_mma_kernel takes them (unused with one split).  float32:
// n_split = ceil(W * ps / 256) chunks of 256, part_ml [B * nh, n_split,
// 2] and part_o [B * nh, n_split, D] f32; tickets unused.
int paged_attention_fwd(int dtype, int head_dim, const void* q,
                        const void* kpool, const void* vpool,
                        const void* table, const void* lens, void* out,
                        void* part_ml, void* part_o, void* tickets, int B,
                        int kvh, int rep, int ps, int W, int n_split,
                        int chunk, float sm_scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long span = (long)W * ps;
  if (rep < 1 || B < 1 || kvh < 1 || ps < 1 || W < 1 || span > (1L << 30) ||
      (dtype != 0 && dtype != 1) || (rep + kRows - 1) / kRows > 65535)
    return (int)cudaErrorInvalidValue;
  if (dtype == 0) {
    if (chunk != kChunkF32 || n_split != (span + kChunkF32 - 1) / kChunkF32 ||
        (long)B * kvh > 65535)
      return (int)cudaErrorInvalidValue;
  } else if (chunk < 1 || chunk % kTile || n_split < 1 ||
             n_split > kMaxSplit || n_split != (span + chunk - 1) / chunk ||
             (n_split > 1 && (!part_ml || !part_o || !tickets))) {
    return (int)cudaErrorInvalidValue;
  }
  switch (head_dim) {
#define PAGED_HEAD_DIM(D)                                                   \
  case D:                                                                   \
    return launch<D>(dtype, q, kpool, vpool, table, lens, out, part_ml,     \
                     part_o, tickets, B, kvh, rep, ps, W, n_split, chunk,   \
                     sm_scale, s);
    PAGED_HEAD_DIM(16)
    PAGED_HEAD_DIM(32)
    PAGED_HEAD_DIM(48)
    PAGED_HEAD_DIM(64)
    PAGED_HEAD_DIM(80)
    PAGED_HEAD_DIM(96)
    PAGED_HEAD_DIM(112)
    PAGED_HEAD_DIM(128)
    PAGED_HEAD_DIM(144)
    PAGED_HEAD_DIM(160)
    PAGED_HEAD_DIM(176)
    PAGED_HEAD_DIM(192)
    PAGED_HEAD_DIM(208)
    PAGED_HEAD_DIM(224)
    PAGED_HEAD_DIM(240)
    PAGED_HEAD_DIM(256)
#undef PAGED_HEAD_DIM
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// The CUDA-core body at any head dim (the wrapper sends it the head dims
// that paged_attention_fwd has no instance for): dtype 0 = float32, 1 =
// bfloat16; n_chunks = ceil(W * ps / chunk) chunks of ``chunk`` keys,
// ``tile`` keys a tile and ``rows`` query heads a CTA, which the wrapper
// picks so that the shared memory fits; part_ml [B * nh, n_chunks, 2]
// and part_o [B * nh, n_chunks, D] f32.
int paged_attention_any_fwd(int dtype, int head_dim, const void* q,
                            const void* kpool, const void* vpool,
                            const void* table, const void* lens, void* out,
                            void* part_ml, void* part_o, int B, int kvh,
                            int rep, int ps, int W, int n_chunks, int chunk,
                            int tile, int rows, float sm_scale,
                            void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long span = (long)W * ps;
  const long smem =
      (2L * tile * head_dim + 2L * rows * head_dim + (long)rows * tile +
       3L * rows) * 4;
  if (head_dim < 1 || rep < 1 || B < 1 || kvh < 1 || ps < 1 || W < 1 ||
      span > (1L << 30) || chunk < 1 || tile < 1 || rows < 1 ||
      rows > rep || n_chunks != (span + chunk - 1) / chunk ||
      (long)B * kvh > 65535 || (rep + rows - 1) / rows > 65535 ||
      smem > 232448 || !part_ml || !part_o)
    return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return launch_any<float>(q, kpool, vpool, table, lens, out, part_ml,
                             part_o, head_dim, B, kvh, rep, ps, W, n_chunks,
                             chunk, tile, rows, sm_scale, s);
  if (dtype == 1)
    return launch_any<__nv_bfloat16>(q, kpool, vpool, table, lens, out,
                                     part_ml, part_o, head_dim, B, kvh, rep,
                                     ps, W, n_chunks, chunk, tile, rows,
                                     sm_scale, s);
  return (int)cudaErrorInvalidValue;
}

const char* paged_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
