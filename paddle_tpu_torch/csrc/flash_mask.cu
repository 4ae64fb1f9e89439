// Masked and biased flash attention (K8) for Hopper (sm_90a): forward,
// dq, dk/dv and dbias.
//
// Replaces, in paddle_tpu/ops/pallas/flash_mask.py:
//   * the forward: _masked_fwd -> _fwd_kernel (:141, :193) and its
//     streamed long-sequence twin _masked_fwd_stream (:565), with the
//     flashmask intervals and/or the dense bias, lse optional;
//   * the backward: _masked_bwd (:888) -> _bwd_dq_kernel (:748),
//     _bwd_dkv_kernel (:791) and _bwd_dbias_kernel (:843), with the
//     broadcast-dim sum of :984-998, and the streamed twin
//     _masked_bwd_stream (:613), whose dbias kernel reduces the
//     broadcast dims in-kernel (:455-528) as this one does.
// One kernel of each kind takes every length: the TPU's 128-padding
// (and the -1e9 bias tail it needs) and its streamed switch past 4096
// tokens are VMEM limits; here the ragged edge is masked in-kernel.
//
// Bodies: the bf16 forward, dq, dk/dv and dbias are flash_sm90.cuh's
// Hopper kernels (wgmma, a TMA ring, register accumulators), which skip
// the tiles that the intervals hide whole, using a tile table that this
// file's table kernel writes just before (tile_table_kernel, in the same
// C entry); the float32 forward, dq, dk/dv and dbias are the bodies of
// flash_common.cuh.  Each runs in the kIntervals mode (no bias) or the
// kBiased mode (a bias, intervals optional).
//
// Head dims 64, 128 and 256, each its own set of instances (the C entries
// dispatch on head_dim); flash_sm90.cuh states how the bf16 kernels
// change with it.
//
// Semantics: a logit is q.k * scale + bias, and a key is invisible past
// Sk, right of the bottom-right aligned causal diagonal, or inside one
// of its column's masked row intervals.  Rows with no visible key give
// zero output, lse = LSE_INVALID (the reference's -inf, made safe) and
// zero gradients.  dk/dv of a GQA group are summed in f32 before the one
// rounding to k's dtype (the reference rounds per q head, then sums:
// identical in float32).  dbias is ds without the scale, p * (dp -
// delta) in f32, summed over the bias's broadcast batch/head dims in a
// fixed order and cast to the bias dtype; key blocks past the causal
// trip count are written as zeros.
//
// Numerics: p is rounded to v's dtype before P.V; lse is in natural-log
// units (the backward kernels read it).  The bf16 forward adds the bias
// in log2 units (s * scale * log2 e + bias * log2 e), so that the row
// max and the exp2 see the biased logit.
//
// What bounds them on the H100: operations for the forward (4 * pairs
// * D flops; the biased forward reads the bias at the visible pairs,
// whose bytes bound it: ALiBi's [1, 16, 2048, 2048] f32, causal, with
// q, k, v, out and lse takes 0.060 ms at 3.35 TB/s), dq (6)
// and dk/dv (8); dbias does 4 * pairs * D flops but writes Sq * Sk * 4
// bytes per bias (batch, head), so bytes bound it at short head dims or
// wide broadcast.
//
// The dbias kernels (the float32 one here, the bf16 one in
// flash_sm90.cuh): one CTA per (query block, bias head, bias batch)
// walks the (batch, head) members that broadcast onto it in order,
// recomputing S and dP per member and key block, and adds each member's
// ds into the output (or an f32 accumulator for a bf16/f16 bias) at the
// same elements from the same thread: deterministic, no atomics.
#include "flash_common.cuh"
#include "flash_sm90.cuh"

using namespace flash;

namespace {

// The float32 forward, one instance per mode and head dim D; bfloat16
// runs the flash_sm90.cuh forward.
template <Mode kMode, int D>
__global__ void __launch_bounds__(NT) masked_fwd_kernel(Params p) {
  extern __shared__ __align__(128) unsigned char smem[];
  fwd_body<float, kMode, D>(p, smem);
}

// The bf16 forward's tile table: {min, max} of each interval vector over
// each 64-key block (columns past Sk left out), [Bm, Hm, nvec, nblk]
// int2 with Bm = B where the intervals have a batch stride, else 1 (Hm
// likewise).  One warp per (vector row, block): grid (ceil(nblk / 4),
// Bm * Hm * nvec), 128 threads.  Reads the intervals once (4 * nvec * Sk
// bytes per (Bm, Hm) member).
__global__ void __launch_bounds__(128)
    tile_table_kernel(const int* mask, int nvec, int hm, long long sb,
                      long long sh, long long sv, int sk, int nblk,
                      int2* tbl) {
  const int blk = blockIdx.x * 4 + (threadIdx.x >> 5);
  if (blk >= nblk) return;                      // the whole warp
  const int lane = threadIdx.x & 31;
  const int r = blockIdx.y;                     // (bt * hm + ht) * nvec + i
  const int i = r % nvec, ht = r / nvec % hm, bt = r / nvec / hm;
  const int* row = mask + bt * sb + ht * sh + i * sv;
  int lo = INT_MAX, hi = INT_MIN;
  for (int c = blk * 64 + lane; c < min(blk * 64 + 64, sk); c += 32) {
    const int x = row[c];
    lo = min(lo, x);
    hi = max(hi, x);
  }
  lo = __reduce_min_sync(0xffffffffu, lo);
  hi = __reduce_max_sync(0xffffffffu, hi);
  if (lane == 0) tbl[(long long)r * nblk + blk] = make_int2(lo, hi);
}

// Launch tile_table_kernel for p's intervals (p.nvec > 0) into p.tbl;
// ``nh`` is the q-head count (the dk/dv entry's p.H counts kv heads).
int launch_tile_table(const Params& p, int nh, cudaStream_t s) {
  const int nblk = (p.sk + 63) / 64;
  const int bm = p.m_s[0] ? p.B : 1, hm = p.m_s[1] ? nh : 1;
  tile_table_kernel<<<dim3((nblk + 3) / 4, bm * hm * p.nvec), 128, 0, s>>>(
      p.mask, p.nvec, hm, p.m_s[0], p.m_s[1], p.m_s[2], p.sk, nblk,
      const_cast<int2*>(p.tbl));
  return (int)cudaGetLastError();
}

// The float32 dq and dk/dv; bfloat16 runs the flash_sm90.cuh kernels.
template <Mode kMode, int D>
__global__ void __launch_bounds__(NT) masked_bwd_dq_kernel(Params p) {
  extern __shared__ __align__(128) unsigned char smem[];
  dq_body<float, kMode, D>(p, smem);
}

template <Mode kMode, int D>
__global__ void __launch_bounds__(NT) masked_bwd_dkv_kernel(Params p) {
  extern __shared__ __align__(128) unsigned char smem[];
  dkv_body<float, kMode, D>(p, smem);
}

template <int D>
struct DbiasSmem {
  static constexpr int BM = kBM<D>;
  static constexpr size_t kT = tile_bytes<float, D>(BM);   // q, do, k, v
  static constexpr size_t kS = score_bytes<D>(BM);         // s, dp
  static constexpr size_t kLD = 2 * BM * sizeof(float);
  static constexpr size_t bytes = 4 * kT + 2 * kS + kLD;
};

// The float32 dbias; bfloat16 runs flash_sm90.cuh's dbias_kernel.  Grid
// (ceil(Sq / kBM<D>), Hb, Bb), 128 threads; Hb/Bb are the bias's head and
// batch dims (1 = broadcast over p.H / p.B).
template <int D>
__global__ void __launch_bounds__(NT) masked_bwd_dbias_kernel(Params p) {
  using T = float;
  using S = DbiasSmem<D>;
  constexpr int BM = kBM<D>, BN = kBM<D>;
  constexpr int LS = Ld<T, D>::S;
  extern __shared__ __align__(128) unsigned char smem[];
  T* q_t = reinterpret_cast<T*>(smem);
  T* do_t = reinterpret_cast<T*>(smem + S::kT);
  T* k_t = reinterpret_cast<T*>(smem + 2 * S::kT);
  T* v_t = reinterpret_cast<T*>(smem + 3 * S::kT);
  float* s_t = reinterpret_cast<float*>(smem + 4 * S::kT);
  float* dp_t = reinterpret_cast<float*>(smem + 4 * S::kT + S::kS);
  float* lse_t = reinterpret_cast<float*>(smem + 4 * S::kT + 2 * S::kS);
  float* delta_t = lse_t + BM;

  const int q0 = blockIdx.x * BM;
  const int t = threadIdx.x;
  const int n_h = gridDim.y == 1 ? p.H : 1;
  const int h_first = gridDim.y == 1 ? 0 : blockIdx.y;
  const int n_b = gridDim.z == 1 ? p.B : 1;
  const int b_first = gridDim.z == 1 ? 0 : blockIdx.z;
  const int members = n_b * n_h;
  const long long out_base =
      ((long long)blockIdx.z * gridDim.y + blockIdx.y) * p.sq * p.sk;
  // f32 bias: the output is its own accumulator
  float* acc = p.bias_dt == 0 ? static_cast<float*>(p.dbias) : p.dbias_acc;
  const int upper = q_trip_count<D>(q0, p);
  const int nblk = (p.sk + BN - 1) / BN;

  for (int kb = upper; kb < nblk; ++kb) {  // past the causal trip count
    for (int e = t; e < BM * BN; e += NT) {
      const int qi = q0 + e / BN;
      const int kj = kb * BN + e % BN;
      if (qi < p.sq && kj < p.sk)
        store_any(p.dbias, out_base + (long long)qi * p.sk + kj, 0.f,
                  p.bias_dt);
    }
  }

  for (int mi = 0; mi < members; ++mi) {
    const int b = b_first + mi / n_h;
    const int h = h_first + mi % n_h;
    const int hk = h / p.group;
    const T* qg = static_cast<const T*>(p.q) + b * p.q_s[0] + h * p.q_s[1];
    const T* dog =
        static_cast<const T*>(p.dout) + b * p.do_s[0] + h * p.do_s[1];
    const T* kg = static_cast<const T*>(p.k) + b * p.k_s[0] + hk * p.k_s[1];
    const T* vg = static_cast<const T*>(p.v) + b * p.v_s[0] + hk * p.v_s[1];
    const Vis m = vis_for(p, b, h);
    const long long row_base = ((long long)b * p.H + h) * p.sq;
    __syncthreads();  // the previous member is done with q_t, do_t, lse_t
    load_tile<T, D, BM>(q_t, qg, p.q_s[2], q0, p.sq);
    load_tile<T, D, BM>(do_t, dog, p.do_s[2], q0, p.sq);
    if (t < BM) {
      const int qi = q0 + t;
      lse_t[t] = qi < p.sq ? p.lse[row_base + qi] : kLseInvalid;
      delta_t[t] = qi < p.sq ? p.delta[row_base + qi] : 0.f;
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
      // element (r, c) belongs to the same thread for every member, so
      // the running sum needs no synchronisation
      for (int e = t; e < BM * BN; e += NT) {
        const int r = e / BN;
        const int c = e % BN;
        const int qi = q0 + r;
        const int kj = k0 + c;
        if (qi >= p.sq || kj >= p.sk) continue;
        const float pr =
            visible<kBiased>(qi, kj, p, m)
                ? expf(scaled<kBiased>(s_t[r * LS + c], qi, kj, p, m) -
                       lse_t[r])
                : 0.f;
        float ds = pr * (dp_t[r * LS + c] - delta_t[r]);
        const long long i = out_base + (long long)qi * p.sk + kj;
        if (mi > 0) ds += acc[i];
        if (mi == members - 1) {
          store_any(p.dbias, i, ds, p.bias_dt);
        } else {
          acc[i] = ds;
        }
      }
    }
  }
}

// The fields every K8 entry shares.
void set_common(Params& p, int B, int H, int group, int sq, int sk,
                int causal, float scale, const void* mask, int nvec,
                const void* bias, int bias_dt, const long long* mb) {
  p.B = B;
  p.H = H;
  p.group = group;
  p.sq = sq;
  p.sk = sk;
  p.causal = causal;
  p.scale = scale;
  p.mask = nvec ? static_cast<const int*>(mask) : nullptr;
  p.nvec = nvec;
  set3(p.m_s, mb);
  p.bias = bias;
  p.bias_dt = bias_dt;
  set3(p.b_s, mb + 3);
}

bool bad_mask(int nvec, const void* mask, int bias_dt) {
  return (nvec != 0 && nvec != 2 && nvec != 4) || (nvec && !mask) ||
         bias_dt < 0 || bias_dt > 2;
}

}  // namespace

extern "C" {

// All entries: dtype 0 = float32, 1 = bfloat16 (q/k/v/out/dout); head_dim
// 64, 128 or 256; nvec 0 (no intervals), 2 or 4; bias null or of bias_dtype
// 0 = float32, 1 = bfloat16, 2 = float16.  strides are int64 element
// strides (batch, head, sequence) per tensor in the order of the tensor
// arguments, then the intervals' (batch, head, vector) and the bias's
// (batch, head, row), 0 for a broadcast dim.  lse/delta are contiguous
// [B, H, Sq] float32.  Each returns a cudaError_t code (0 = launched).
// Shapes are validated by the Python wrappers
// (paddle_tpu_torch/ops/pallas/flash_mask.py).

// strides: q, k, v, out, mask, bias (18); lse may be null (not written).
// bfloat16 with intervals needs tbl, an int32 buffer of Bm * Hm * nvec *
// ceil(Sk / 64) * 2 (Bm = B where the intervals' batch stride is not 0,
// else 1; Hm likewise): the tile table, written here before the forward.
int flash_mask_fwd(int dtype, int head_dim, const void* q, const void* k,
                   const void* v, const void* mask, int nvec,
                   const void* bias, int bias_dtype, void* out, void* lse,
                   void* tbl, int B, int H, int group, int sq, int sk,
                   int causal, float scale, const long long* strides,
                   void* stream) {
  if (bad_args(dtype, head_dim, B, H, group, sq, sk) ||
      bad_mask(nvec, mask, bias_dtype) || (dtype == 1 && nvec && !tbl))
    return (int)cudaErrorInvalidValue;
  Params p = {};
  set_common(p, B, H, group, sq, sk, causal, scale, mask, nvec, bias,
             bias_dtype, strides + 12);
  p.q = q;
  p.k = k;
  p.v = v;
  p.out = out;
  p.lse = static_cast<float*>(lse);
  set3(p.q_s, strides);
  set3(p.k_s, strides + 3);
  set3(p.v_s, strides + 6);
  set3(p.o_s, strides + 9);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  p.tbl = static_cast<const int2*>(tbl);
  if (dtype == 1 && nvec) {
    const int err = launch_tile_table(p, H, s);
    if (err) return err;
  }
  return by_head_dim(head_dim, [&](auto d) {
    constexpr int D = decltype(d)::value;
    if (dtype == 0)
      return launch(bias ? masked_fwd_kernel<kBiased, D>
                         : masked_fwd_kernel<kIntervals, D>,
                    FwdSmem<float, D>::bytes,
                    dim3((sq + kBM<D> - 1) / kBM<D>, H, B), p, s);
    return bias ? flash_sm90::launch_fwd<kBiased, D>(p, s)
                : flash_sm90::launch_fwd<kIntervals, D>(p, s);
  });
}

// The bf16 forward's tile table alone (for its check against the plain
// version): mask [B|1, H|1, nvec, Sk] with element strides (batch, head,
// vector) in strides[0..3), 0 on a broadcast dim; tbl as flash_mask_fwd
// takes it.
int flash_mask_tile_table(const void* mask, int nvec, int B, int H, int sk,
                          const long long* strides, void* tbl,
                          void* stream) {
  if ((nvec != 2 && nvec != 4) || !mask || !tbl || B < 1 || H < 1 || sk < 1)
    return (int)cudaErrorInvalidValue;
  const long long st[6] = {strides[0], strides[1], strides[2], 0, 0, 0};
  Params p = {};
  set_common(p, B, H, 1, 1, sk, 0, 1.f, mask, nvec, nullptr, 0, st);
  p.tbl = static_cast<const int2*>(tbl);
  return launch_tile_table(p, H, static_cast<cudaStream_t>(stream));
}

// strides: q, k, v, out, dout, dq, mask, bias (24); writes dq and delta.
// tbl as flash_mask_fwd takes it (bfloat16 with intervals; written here
// before dq).
int flash_mask_bwd_dq(int dtype, int head_dim, const void* q, const void* k,
                      const void* v, const void* out, const void* dout,
                      const void* lse, void* delta, void* dq,
                      const void* mask, int nvec, const void* bias,
                      int bias_dtype, void* tbl, int B, int H, int group,
                      int sq, int sk, int causal, float scale,
                      const long long* strides, void* stream) {
  if (bad_args(dtype, head_dim, B, H, group, sq, sk) ||
      bad_mask(nvec, mask, bias_dtype) || (dtype == 1 && nvec && !tbl))
    return (int)cudaErrorInvalidValue;
  Params p = {};
  set_common(p, B, H, group, sq, sk, causal, scale, mask, nvec, bias,
             bias_dtype, strides + 18);
  p.q = q;
  p.k = k;
  p.v = v;
  p.o = out;
  p.dout = dout;
  p.lse = const_cast<float*>(static_cast<const float*>(lse));
  p.delta = static_cast<float*>(delta);
  p.dq = dq;
  set3(p.q_s, strides);
  set3(p.k_s, strides + 3);
  set3(p.v_s, strides + 6);
  set3(p.o_s, strides + 9);
  set3(p.do_s, strides + 12);
  set3(p.dq_s, strides + 15);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  p.tbl = static_cast<const int2*>(tbl);
  if (dtype == 1 && nvec) {
    const int err = launch_tile_table(p, H, s);
    if (err) return err;
  }
  return by_head_dim(head_dim, [&](auto d) {
    constexpr int D = decltype(d)::value;
    if (dtype == 0)
      return launch(bias ? masked_bwd_dq_kernel<kBiased, D>
                         : masked_bwd_dq_kernel<kIntervals, D>,
                    DqSmem<float, D>::bytes,
                    dim3((sq + kBM<D> - 1) / kBM<D>, H, B), p, s);
    return bias ? flash_sm90::launch_dq<kBiased, D>(p, s)
                : flash_sm90::launch_dq<kIntervals, D>(p, s);
  });
}

// strides: q, k, v, dout, dk, dv, mask, bias (24); kvH kv heads, group q
// heads each (the intervals, the bias and tbl are indexed by q head:
// tbl as flash_mask_fwd takes it with H = kvH * group)
int flash_mask_bwd_dkv(int dtype, int head_dim, const void* q, const void* k,
                       const void* v, const void* dout, const void* lse,
                       const void* delta, void* dk, void* dv,
                       const void* mask, int nvec, const void* bias,
                       int bias_dtype, void* tbl, int B, int kvH, int group,
                       int sq, int sk, int causal, float scale,
                       const long long* strides, void* stream) {
  if (bad_args(dtype, head_dim, B, kvH, group, sq, sk) ||
      bad_mask(nvec, mask, bias_dtype) || (dtype == 1 && nvec && !tbl))
    return (int)cudaErrorInvalidValue;
  Params p = {};
  // the kernels index lse/delta as (b * kvH * group + h)
  set_common(p, B, kvH, group, sq, sk, causal, scale, mask, nvec, bias,
             bias_dtype, strides + 18);
  p.q = q;
  p.k = k;
  p.v = v;
  p.dout = dout;
  p.lse = const_cast<float*>(static_cast<const float*>(lse));
  p.delta = const_cast<float*>(static_cast<const float*>(delta));
  p.dk = dk;
  p.dv = dv;
  set3(p.q_s, strides);
  set3(p.k_s, strides + 3);
  set3(p.v_s, strides + 6);
  set3(p.do_s, strides + 9);
  set3(p.dk_s, strides + 12);
  set3(p.dv_s, strides + 15);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  p.tbl = static_cast<const int2*>(tbl);
  if (dtype == 1 && nvec) {
    const int err = launch_tile_table(p, kvH * group, s);
    if (err) return err;
  }
  return by_head_dim(head_dim, [&](auto d) {
    constexpr int D = decltype(d)::value;
    if (dtype == 0)
      return launch(bias ? masked_bwd_dkv_kernel<kBiased, D>
                         : masked_bwd_dkv_kernel<kIntervals, D>,
                    DkvCfg<float, D>::bytes,
                    dim3((sk + kBM<D> - 1) / kBM<D>, kvH, B), p, s);
    return bias ? flash_sm90::launch_dkv<kBiased, D>(p, s)
                : flash_sm90::launch_dkv<kIntervals, D>(p, s);
  });
}

// strides: q, k, v, dout, mask, bias (18).  dbias: contiguous [Bb, Hb,
// Sq, Sk] of bias_dtype (Bb in {1, B}, Hb in {1, H}); dbias_acc: a
// contiguous f32 buffer of the same shape when bias_dtype != 0 and Bb *
// Hb < B * H, else null.  Reads the delta the dq entry wrote.  tbl as
// flash_mask_fwd takes it (bfloat16 with intervals; written here before
// dbias).
int flash_mask_bwd_dbias(int dtype, int head_dim, const void* q,
                         const void* k, const void* v, const void* dout,
                         const void* lse, const void* delta,
                         const void* mask, int nvec, const void* bias,
                         int bias_dtype, void* dbias, void* dbias_acc,
                         void* tbl, int B, int H, int group, int Bb, int Hb,
                         int sq, int sk, int causal, float scale,
                         const long long* strides, void* stream) {
  if (bad_args(dtype, head_dim, B, H, group, sq, sk) ||
      bad_mask(nvec, mask, bias_dtype) || !bias || !dbias ||
      (Bb != 1 && Bb != B) || (Hb != 1 && Hb != H) ||
      (bias_dtype != 0 && Bb * Hb < B * H && !dbias_acc) ||
      (dtype == 1 && nvec && !tbl))
    return (int)cudaErrorInvalidValue;
  Params p = {};
  set_common(p, B, H, group, sq, sk, causal, scale, mask, nvec, bias,
             bias_dtype, strides + 12);
  p.q = q;
  p.k = k;
  p.v = v;
  p.dout = dout;
  p.lse = const_cast<float*>(static_cast<const float*>(lse));
  p.delta = const_cast<float*>(static_cast<const float*>(delta));
  p.dbias = dbias;
  p.dbias_acc = static_cast<float*>(dbias_acc);
  set3(p.q_s, strides);
  set3(p.k_s, strides + 3);
  set3(p.v_s, strides + 6);
  set3(p.do_s, strides + 9);
  // Bb / Hb == 1 makes the kernel loop over the broadcast members; with
  // B == 1 (or H == 1) that loop has one member either way
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  p.tbl = static_cast<const int2*>(tbl);
  if (dtype == 1 && nvec) {
    const int err = launch_tile_table(p, H, s);
    if (err) return err;
  }
  return by_head_dim(head_dim, [&](auto d) {
    constexpr int D = decltype(d)::value;
    if (dtype == 0)
      return launch(masked_bwd_dbias_kernel<D>, DbiasSmem<D>::bytes,
                    dim3((sq + kBM<D> - 1) / kBM<D>, Hb, Bb), p, s);
    return flash_sm90::launch_dbias<kBiased, D>(p, Hb, Bb, s);
  });
}

const char* flash_mask_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
