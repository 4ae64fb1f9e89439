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
// Head dims 64, 128 and 256 (the reference's sdpa sends these to its
// kernels), each its own set of instances; the C entries dispatch on
// head_dim (by_head_dim).
//
// What bounds them on the H100: operations.  At a training shape
// (seq 2048, head_dim 128) the forward does 4 * pairs * D flops per
// head against O(S * D) bytes, the dq kernel 6 * pairs * D and the
// dk/dv kernel 8 * pairs * D, all far above the ~295 flop/byte ridge;
// the floor is the visible flops over the 989 TFLOP/s bf16 peak (at b 8,
// h 16, s 2048, causal: 0.139, 0.209 and 0.278 ms).
//
// Two sets of bodies:
//   * bfloat16 (the training path): flash_sm90.cuh, built for Hopper:
//     warp-specialised CTAs (a TMA producer warp, consumer warpgroups),
//     a two-stage TMA ring with mbarriers, wgmma with f32 accumulators
//     in registers, P and dS fed from registers as the A operand of the
//     next product, softmax on the accumulator registers; forward and
//     dq take 128-row query blocks, dk/dv 128-key blocks.  That header
//     states their design, their bounds and what is left for later
//     (softmax/wgmma overlap inside a warpgroup, persistent CTAs, fp8);
//   * float32: the bodies of flash_common.cuh (shared with the K8
//     kernels of flash_mask.cu), whose float32 products run on
//     CUDA-core FMA, so card and CPU agree to f32 rounding.  Forward and
//     dq run one CTA per (64-row query block, q head, batch); dk/dv one
//     CTA per (64-key block, kv head, batch); 32 rows or keys at head_dim
//     256.
// Both write delta [B, H, Sq] from the dq kernel (so the dk/dv kernel
// never reads O) and sum the GQA group's dk/dv in f32 in place of the
// reference's per-q-head [B, H, Sk, D] intermediates (fewer CTAs under
// GQA: kvH instead of H per key block).
#include "flash_common.cuh"
#include "flash_sm90.cuh"

using namespace flash;

namespace {

// The float32 kernels, one instance per head dim D; bfloat16 runs the
// flash_sm90.cuh kernels.
template <int D>
__global__ void __launch_bounds__(NT) flash_fwd_kernel(Params p) {
  extern __shared__ __align__(128) unsigned char smem[];
  fwd_body<float, kPlain, D>(p, smem);
}

template <int D>
__global__ void __launch_bounds__(NT) flash_bwd_dq_kernel(Params p) {
  extern __shared__ __align__(128) unsigned char smem[];
  dq_body<float, kPlain, D>(p, smem);
}

template <int D>
__global__ void __launch_bounds__(NT) flash_bwd_dkv_kernel(Params p) {
  extern __shared__ __align__(128) unsigned char smem[];
  dkv_body<float, kPlain, D>(p, smem);
}

}  // namespace

extern "C" {

// All entries: dtype 0 = float32, 1 = bfloat16; head_dim 64, 128 or 256;
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
  p.B = B;
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
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return by_head_dim(head_dim, [&](auto d) {
    constexpr int D = decltype(d)::value;
    if (dtype == 0)
      return launch(flash_fwd_kernel<D>, FwdSmem<float, D>::bytes,
                    dim3((sq + kBM<D> - 1) / kBM<D>, H, B), p, s);
    return flash_sm90::launch_fwd<kPlain, D>(p, s);
  });
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
  p.B = B;
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
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return by_head_dim(head_dim, [&](auto d) {
    constexpr int D = decltype(d)::value;
    if (dtype == 0)
      return launch(flash_bwd_dq_kernel<D>, DqSmem<float, D>::bytes,
                    dim3((sq + kBM<D> - 1) / kBM<D>, H, B), p, s);
    return flash_sm90::launch_dq<kPlain, D>(p, s);
  });
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
  p.B = B;
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
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return by_head_dim(head_dim, [&](auto d) {
    constexpr int D = decltype(d)::value;
    if (dtype == 0)
      return launch(flash_bwd_dkv_kernel<D>, DkvCfg<float, D>::bytes,
                    dim3((sk + kBM<D> - 1) / kBM<D>, kvH, B), p, s);
    return flash_sm90::launch_dkv<kPlain, D>(p, s);
  });
}

const char* flash_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
