"""Masked and biased flash attention (K8): flashmask column intervals
and/or a dense additive bias, differentiable.

Ports ``paddle_tpu/ops/pallas/flash_mask.py``: the interval helpers,
``flash_mha_masked`` and ``flash_mha_biased`` (the reference's two
``custom_vjp``s become one ``torch.autograd.Function``).  The flashmask
encoding: for key column j, query rows in [lts[j], lte[j]) are MASKED
(and, for nvec == 4, also [uts[j], ute[j])), passed as one int32 array
mask_vecs [B|1, H|1, nvec, Sk] — O(S) memory.  The bias is an additive
[B|1, H|1, Sq, Sk] float term (float32, bfloat16 or float16 on the
card), added in f32 after the scale.  Both compose with ``causal``
(bottom-right aligned).  Rows with no visible key give zero output and
zero gradients.

Kernels (``csrc/flash_mask.cu``, the port of the TPU kernel K8, both its
resident and its streamed variants): the forward, which writes lse only
when a gradient will be taken; the dq kernel, which also writes delta =
rowsum(out * dout); the dk/dv kernel, one CTA per key block summing its
GQA group in f32 (the reference rounds per q head, then sums —
identical in float32); and the dbias kernel, which runs only when the
bias needs a gradient (the reference always emits it and lets XLA drop
it) and sums over the bias's broadcast dims in-kernel.  In bf16 the
forward, dq, dk/dv and dbias are the Hopper kernels of
``csrc/flash_sm90.cuh``, which skip the tiles that the intervals hide
whole (the forward's 128-row query blocks x 128-key tiles, 64-key at
head_dim 256; dq's 128-row blocks x 64-key tiles, 64-row at head_dim
256; dbias's 128 x 64; dk/dv's 64-row query tiles x 64-key blocks), by
a table of each interval
vector's minimum and maximum over 64-key blocks that each C entry writes
first: :func:`_tile_table_xla` and :func:`_tile_classes` are its plain
versions.

On CPU tensors every entry runs its plain version; on CUDA tensors it
launches the kernel (built for head dims 64, 128 and 256) or raises,
except for the head dims that the reference routes to XLA
(``flash_attention._route``: d outside {64, 128, 256}), which run the
plain versions on the card too.  The plain versions
(:func:`_masked_fwd_xla`, :func:`_masked_bwd_dq_xla`,
:func:`_masked_bwd_dkv_xla`, :func:`_masked_bwd_dbias_xla`) follow the
Pallas bodies, not the XLA path: f32 logits with -inf at masked keys;
unnormalised probabilities rounded to v's dtype before P.V; lse =
LSE_INVALID for rows with no visible key; the backward recomputes p
from lse and rounds ds to the input dtype before the dq and dk
products.
"""
from __future__ import annotations

import ctypes

import torch

from ... import resolve_device
from .. import cuda_lib
from .flash_attention import (LSE_INVALID, _bshd_empty_like, _bwd_inputs,
                              _check, _expand_kv, _group_sum, _route,
                              _stream, _strided_ok, _strides)

__all__ = ["flash_mha_masked", "flash_mha_biased", "flash_mha_masked_xla",
           "padding_mask_to_intervals", "sliding_window_intervals",
           "segment_intervals", "pad_intervals",
           "dense_mask_from_intervals"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# dtype, head_dim, q, k, v, mask, nvec, bias, bias_dtype, out, lse, tbl,
# B, H, group, sq, sk, causal, scale, strides, stream
_FWD_ARGS = (_I, _I, _P, _P, _P, _P, _I, _P, _I, _P, _P, _P, _I, _I, _I, _I,
             _I, _I, _F, _P, _P)
# mask, nvec, B, H, sk, strides, tbl, stream
_TABLE_ARGS = (_P, _I, _I, _I, _I, _P, _P, _P)
TABLE_BLOCK = 64               # keys per block of the tile table
TILE = 128                     # query rows and keys of a bf16 forward tile
# the bf16 backward's tiles: dq (query rows, keys), dk/dv (query rows,
# keys of a consumer warpgroup's block)
DQ_TILE, DKV_TILE = (128, 64), (64, 64)
# dtype, head_dim, q, k, v, out|dout, dout|lse, lse|delta, delta|dk,
# dq|dv, mask, nvec, bias, bias_dtype, tbl, B, H|kvH, group, sq, sk,
# causal, scale, strides, stream
_BWD_ARGS = (_I, _I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _P, _I, _P, _I,
             _I, _I, _I, _I, _I, _F, _P, _P)
# dtype, head_dim, q, k, v, dout, lse, delta, mask, nvec, bias,
# bias_dtype, dbias, dbias_acc, tbl, B, H, group, Bb, Hb, sq, sk, causal,
# scale, strides, stream
_DBIAS_ARGS = (_I, _I, _P, _P, _P, _P, _P, _P, _P, _I, _P, _I, _P, _P, _P, _I,
               _I, _I, _I, _I, _I, _I, _I, _F, _P, _P)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_KERNEL = "flash_mha_masked (K8)"    # the name its checks raise with
_BIAS_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_entries = {}                  # C entry name -> ctypes function


def _entry(symbol, argtypes):
    fn = _entries.get(symbol)
    if fn is None:
        fn = _entries[symbol] = cuda_lib.kernel("flash_mask", symbol,
                                                argtypes)
    return fn


# ------------------------------------------------------------ mask helpers
def padding_mask_to_intervals(key_mask, sq):
    """[B, Sk] or [B, H, Sk] bool key-padding mask (True = attend) ->
    mask_vecs [B, 1|H, 2, Sk]: masked columns exclude every query row
    ([0, sq)), valid columns none ([sq, sq))."""
    if key_mask.dim() == 2:
        key_mask = key_mask[:, None, :]
    lts = torch.where(key_mask, sq, 0).to(torch.int32)
    lte = torch.full_like(lts, sq)
    return torch.stack([lts, lte], dim=2)


def sliding_window_intervals(sk, window, batch=1, device=None):
    """Causal sliding-window attention (combine with causal=True): row r
    attends keys [r - window, r] — paddle's window convention (window + 1
    keys with the diagonal), so column j masks rows > j + window.  The
    intervals are made on ``device`` (default CUDA, like every entry
    point of the port; ``device="cpu"`` for the plain path)."""
    j = torch.arange(sk, dtype=torch.int32, device=resolve_device(device))
    lts = (j + window + 1).expand(batch, 1, sk)
    lte = torch.full_like(lts, sk)
    return torch.stack([lts, lte], dim=2)


def segment_intervals(segment_ids, causal=True):
    """[B, S] int segment ids (contiguous packing) -> mask_vecs keeping
    attention within each segment (the flashmask 'document mask').
    causal=True yields nvec=2; causal=False yields nvec=4."""
    seg = torch.as_tensor(segment_ids)
    b, s = seg.shape
    pos = torch.arange(s, dtype=torch.int32, device=seg.device)
    same = seg[:, :, None] == seg[:, None, :]          # [B, S, S] bool
    first = torch.where(same, pos[None, :, None], s).amin(dim=1)
    last1 = torch.where(same, pos[None, :, None], -1).amax(dim=1) + 1
    lts = last1.to(torch.int32)            # mask rows at/after seg end
    lte = torch.full_like(lts, s)
    if causal:
        vec = torch.stack([lts, lte], dim=1)
    else:
        uts = torch.zeros_like(lts)        # mask rows before seg start
        ute = first.to(torch.int32)
        vec = torch.stack([lts, lte, uts, ute], dim=1)
    return vec[:, None]


def pad_intervals(mask_vecs, sk_padded):
    """Extend mask_vecs [B|1, H|1, nvec, Sk] to a padded key length (tail
    values are irrelevant: the kernel masks keys >= Sk itself)."""
    pad = sk_padded - mask_vecs.shape[-1]
    if pad <= 0:
        return mask_vecs
    return torch.nn.functional.pad(mask_vecs, (0, pad))


def dense_mask_from_intervals(mask_vecs, sq, sk):
    """Dense bool mask [B|1, H|1, Sq, Sk] (True = attend) equivalent to
    mask_vecs."""
    b, h, nvec, _ = mask_vecs.shape
    r = torch.arange(sq, device=mask_vecs.device)[:, None]
    allowed = torch.ones((b, h, sq, sk), dtype=torch.bool,
                         device=mask_vecs.device)
    for i in range(nvec // 2):
        start = mask_vecs[:, :, 2 * i][:, :, None, :]
        end = mask_vecs[:, :, 2 * i + 1][:, :, None, :]
        allowed &= ~((r[None, None] >= start) & (r[None, None] < end))
    return allowed


# ------------------------------------------------------ the tile table
def _tile_table_xla(mask_vecs, sk):
    """Plain version of the bf16 forward's tile table: [B|1, H|1, nvec,
    ceil(Sk / 64), 2] int32, the minimum and maximum of each interval
    vector over each 64-key block (columns past Sk left out)."""
    x = mask_vecs[..., :sk].to(torch.int32)
    nblk = -(-sk // TABLE_BLOCK)
    pad = nblk * TABLE_BLOCK - sk
    info = torch.iinfo(torch.int32)
    lo = torch.nn.functional.pad(x, (0, pad), value=info.max)
    hi = torch.nn.functional.pad(x, (0, pad), value=info.min)
    return torch.stack(
        [lo.unflatten(-1, (nblk, TABLE_BLOCK)).amin(-1),
         hi.unflatten(-1, (nblk, TABLE_BLOCK)).amax(-1)], dim=-1)


def _tile_table(mask_vecs):
    """The tile table of ``mask_vecs`` [B|1, H|1, nvec, Sk]: CPU tensors
    take :func:`_tile_table_xla`; CUDA tensors launch the table kernel
    that the bf16 forward runs first (its own C entry, for its check)."""
    if mask_vecs.device.type == "cpu":
        return _tile_table_xla(mask_vecs, mask_vecs.shape[-1])
    vecs = mask_vecs.to(torch.int32).contiguous()
    bm, hm, nvec, sk = vecs.shape
    tbl = torch.empty((bm, hm, nvec, -(-sk // TABLE_BLOCK), 2),
                      dtype=torch.int32, device=vecs.device)
    strides = (ctypes.c_longlong * 3)(*_vec_strides(vecs, None)[:3])
    err = _entry("flash_mask_tile_table", _TABLE_ARGS)(
        vecs.data_ptr(), nvec, bm, hm, sk, strides, tbl.data_ptr(),
        _stream(vecs))
    cuda_lib.check("flash_mask", err, "flash_mask tile table launch")
    _tile_table.launches += 1
    return tbl


def _tile_classes(table, sq, rows=TILE, keys=TILE):
    """How the bf16 kernels class each (``rows``-row query tile,
    ``keys``-key tile) from a tile table (``flash_sm90.cuh:tile_class``):
    the interval forward takes 128 x 128 (the defaults; 128 x 64 at
    head_dim 256), the biased forward 128 x 64, dq 128 x 64 (``DQ_TILE``;
    64 x 64 at head_dim 256) and dk/dv 64 x 64 (``DKV_TILE``, a consumer
    warpgroup's key block).  0 skip (one
    interval hides every key of the tile from every row it covers), 1
    partial, 2 clean (no interval touches it); [Bm, Hm, ceil(Sq / rows),
    ceil(Sk / keys)] int64.  Keys past Sk and causality are the kernel's
    per-element test, not the table's."""
    bm, hm, nvec, nblk, _ = table.shape
    per = keys // TABLE_BLOCK
    pad = -nblk % per
    info = torch.iinfo(torch.int32)
    lo = torch.nn.functional.pad(table[..., 0], (0, pad), value=info.max)
    hi = torch.nn.functional.pad(table[..., 1], (0, pad), value=info.min)
    lo = lo.unflatten(-1, (-1, per)).amin(-1)[:, :, :, None]
    hi = hi.unflatten(-1, (-1, per)).amax(-1)[:, :, :, None]
    q0 = torch.arange(0, sq, rows, device=table.device)[:, None]
    qe = torch.clamp(q0 + rows, max=sq)
    hidden = touched = torch.zeros((), dtype=torch.bool)
    for i in range(0, nvec, 2):        # [Bm, Hm, query blocks, tiles]
        smin, smax, emin, emax = lo[:, :, i], hi[:, :, i], lo[:, :, i + 1], \
            hi[:, :, i + 1]
        hidden = hidden | ((smax <= q0) & (emin >= qe))
        touched = touched | ((smin < qe) & (emax > q0) & (smin < emax))
    shape = (bm, hm, q0.shape[0], lo.shape[-1])
    return torch.where(hidden, 0, torch.where(touched, 1, 2)).expand(shape)


# ------------------------------------------------------ plain versions
def _masked_logits(q, k, mask_vecs, bias, causal, sm_scale):
    """f32 logits [B, H, Sq, Sk] = q . k * sm_scale + bias, -inf where
    the key is invisible (``_visible`` and ``_mask_block``)."""
    sq, sk = q.shape[2], k.shape[2]
    kf = _expand_kv(k, q.shape[1] // k.shape[1]).float()
    s = torch.matmul(q.float(), kf.transpose(-1, -2)).mul_(sm_scale)
    if bias is not None:
        s.add_(bias.float())
    allowed = None
    if causal:
        allowed = torch.ones(sq, sk, dtype=torch.bool,
                             device=q.device).tril(sk - sq)
    if mask_vecs is not None:
        dense = dense_mask_from_intervals(mask_vecs, sq, sk)
        allowed = dense if allowed is None else dense & allowed
    if allowed is not None:
        s.masked_fill_(~allowed, -torch.inf)
    return s


def _masked_fwd_xla(q, k, v, mask_vecs, bias, causal, sm_scale):
    """Plain version of the K8 forward (``_fwd_kernel``): (out [B, H, Sq,
    D] in q's dtype, lse [B, H, Sq] f32).  Rows with no visible key:
    zeros, LSE_INVALID."""
    s = _masked_logits(q, k, mask_vecs, bias, causal, sm_scale)
    m = s.amax(dim=-1, keepdim=True)
    p = s.sub_(torch.where(torch.isfinite(m), m, 0.0)).exp_()
    l = p.sum(dim=-1, keepdim=True)
    vv = _expand_kv(v, q.shape[1] // k.shape[1])
    acc = torch.matmul(p.to(v.dtype).float(), vv.float())
    del p
    row_ok = l > 0
    l_safe = torch.where(row_ok, l, 1.0)
    out = torch.where(row_ok, acc / l_safe, 0.0)
    lse = torch.where(row_ok, m + torch.log(l_safe), LSE_INVALID)
    return out.to(q.dtype), lse[..., 0]


def flash_mha_masked_xla(q, k, v, mask_vecs, causal, sm_scale):
    """The plain version of the masked forward's output: [B, H, Sq, D]."""
    return _masked_fwd_xla(q, k, v, mask_vecs, None, causal, sm_scale)[0]


def _masked_p_ds(q, k, v, out, lse, dout, mask_vecs, bias, causal,
                 sm_scale):
    """p = exp(s - lse) and the unscaled ds = p * (dp - delta), both f32
    [B, H, Sq, Sk]; delta = rowsum(out * dout) in f32."""
    p = _masked_logits(q, k, mask_vecs, bias, causal, sm_scale)
    p.sub_(lse[..., None]).exp_()
    vv = _expand_kv(v, q.shape[1] // k.shape[1])
    dp = torch.matmul(dout.float(), vv.float().transpose(-1, -2))
    delta = (out.float() * dout.float()).sum(dim=-1, keepdim=True)
    return p, dp.sub_(delta).mul_(p)


def _masked_bwd_dq_xla(q, k, v, out, lse, dout, mask_vecs, bias, causal,
                       sm_scale):
    """Plain version of the K8 dq kernel (``_bwd_dq_kernel``)."""
    _, ds = _masked_p_ds(q, k, v, out, lse, dout, mask_vecs, bias, causal,
                         sm_scale)
    kf = _expand_kv(k, q.shape[1] // k.shape[1]).float()
    return torch.matmul(ds.mul_(sm_scale).to(k.dtype).float(),
                        kf).to(q.dtype)


def _masked_bwd_dkv_xla(q, k, v, out, lse, dout, mask_vecs, bias, causal,
                        sm_scale):
    """Plain version of the K8 dk/dv kernel (``_bwd_dkv_kernel``, with
    the group sum of ``:970-972`` taken in f32): (dk, dv) [B, kvH, Sk,
    D]."""
    p, ds = _masked_p_ds(q, k, v, out, lse, dout, mask_vecs, bias, causal,
                         sm_scale)
    kvh = k.shape[1]
    dv = torch.matmul(p.to(dout.dtype).float().transpose(-1, -2),
                      dout.float())
    del p
    dk = torch.matmul(ds.mul_(sm_scale).to(q.dtype).float()
                      .transpose(-1, -2), q.float())
    return (_group_sum(dk, kvh).to(k.dtype), _group_sum(dv, kvh).to(v.dtype))


def _masked_bwd_dbias_xla(q, k, v, out, lse, dout, mask_vecs, bias, causal,
                          sm_scale):
    """Plain version of the K8 dbias kernel (``_bwd_dbias_kernel``, then
    ``:984-998``): ds without the scale, summed over the bias's
    broadcast dims, in the bias dtype."""
    _, ds = _masked_p_ds(q, k, v, out, lse, dout, mask_vecs, bias, causal,
                         sm_scale)
    red = [i for i in (0, 1) if bias.shape[i] == 1 and ds.shape[i] > 1]
    if red:
        ds = ds.sum(dim=red, keepdim=True)
    return ds.to(bias.dtype)


# ------------------------------------------------------ kernel wrappers
def _check_mask(mask_vecs, b, h, sk):
    if mask_vecs is None:
        return 0
    if mask_vecs.device.type != "cuda":
        raise ValueError(f"flash_mha_masked: mask_vecs on "
                         f"{mask_vecs.device}, q on the card")
    if (mask_vecs.dtype != torch.int32 or mask_vecs.dim() != 4
            or mask_vecs.shape[0] not in (1, b)
            or mask_vecs.shape[1] not in (1, h)
            or mask_vecs.shape[2] not in (2, 4)
            or mask_vecs.shape[3] != sk or mask_vecs.stride(3) != 1):
        raise ValueError(
            "flash_mha_masked: mask_vecs must be int32 [B|1, H|1, 2|4, Sk]"
            f" with a contiguous last dim, got {mask_vecs.dtype} "
            f"{tuple(mask_vecs.shape)}")
    return mask_vecs.shape[2]


def _check_bias(bias, b, h, sq, sk):
    """The bias as the kernels take it (columns contiguous)."""
    if bias is None:
        return None
    if bias.device.type != "cuda":
        raise ValueError(f"flash_mha_biased: bias on {bias.device}, q on "
                         "the card")
    if bias.dtype not in _BIAS_DTYPES:
        raise TypeError("flash_mha_biased kernel takes a float32, bfloat16 "
                        f"or float16 bias, got {bias.dtype}")
    if (bias.dim() != 4 or bias.shape[0] not in (1, b)
            or bias.shape[1] not in (1, h) or bias.shape[2:] != (sq, sk)):
        raise ValueError(f"flash_mha_biased: bias must be [B|1, H|1, Sq, "
                         f"Sk] = [{b}|1, {h}|1, {sq}, {sk}], got "
                         f"{tuple(bias.shape)}")
    return bias if bias.stride(3) == 1 else bias.contiguous()


def _vec_strides(mask_vecs, bias):
    """(batch, head, vector) of the intervals and (batch, head, row) of
    the bias, 0 for a broadcast dim or a missing operand."""
    out = []
    for t in (mask_vecs, bias):
        if t is None:
            out += [0, 0, 0]
        else:
            out += [t.stride(0) if t.shape[0] > 1 else 0,
                    t.stride(1) if t.shape[1] > 1 else 0, t.stride(2)]
    return out


def _ptr(t):
    return t.data_ptr() if t is not None else None


def _operands(mask_vecs, bias):
    """The kernels' (mask, nvec, bias, bias_dtype) arguments."""
    return (_ptr(mask_vecs),
            mask_vecs.shape[2] if mask_vecs is not None else 0,
            _ptr(bias), _BIAS_DTYPES[bias.dtype] if bias is not None else 0)


def _all_strides(tensors, mask_vecs, bias):
    return (ctypes.c_longlong * (3 * len(tensors) + 6))(
        *_strides(*tensors), *_vec_strides(mask_vecs, bias))


def _table_scratch(q, mask_vecs, b, h, sk):
    """The tile table's buffer that a bf16 C entry with intervals writes
    before its kernel (Bm * Hm * nvec * ceil(Sk / 64) int2, Bm = b where
    the intervals have a batch stride, else 1; Hm likewise, h the q
    heads), or None."""
    if mask_vecs is None or q.dtype != torch.bfloat16:
        return None
    sb, sh, _ = _vec_strides(mask_vecs, None)[:3]
    return torch.empty(((b if sb else 1) * (h if sh else 1)
                        * mask_vecs.shape[2] * -(-sk // TABLE_BLOCK) * 2,),
                       dtype=torch.int32, device=q.device)


def _masked_fwd(q, k, v, mask_vecs, bias, causal, sm_scale, need_lse):
    """K8 forward: (out [B, H, Sq, D], lse [B, H, Sq] f32 or None).  CPU
    tensors take :func:`_masked_fwd_xla`; CUDA tensors launch the kernel,
    which writes lse only when ``need_lse``."""
    if q.device.type == "cpu" or _route(q.shape[-1]) == "plain":
        out, lse = _masked_fwd_xla(q, k, v, mask_vecs, bias, causal,
                                   sm_scale)
        return out, (lse if need_lse else None)
    b, h, sq, d, kvh, sk = _check(q, k, v, name=_KERNEL)
    _check_mask(mask_vecs, b, h, sk)
    bias = _check_bias(bias, b, h, sq, sk)
    out = _bshd_empty_like(q)
    lse = (torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
           if need_lse else None)
    tbl = _table_scratch(q, mask_vecs, b, h, sk)
    err = _entry("flash_mask_fwd", _FWD_ARGS)(
        _DTYPES[q.dtype], d, q.data_ptr(), k.data_ptr(), v.data_ptr(),
        *_operands(mask_vecs, bias), out.data_ptr(),
        _ptr(lse), _ptr(tbl), b, h, h // kvh, sq, sk,
        int(bool(causal)), float(sm_scale),
        _all_strides((q, k, v, out), mask_vecs, bias), _stream(q))
    cuda_lib.check("flash_mask", err, "flash_mha_masked forward launch")
    if bias is None:
        flash_mha_masked.launches += 1
    else:
        flash_mha_biased.launches += 1
    if need_lse:
        flash_mha_masked.lse_launches += 1
    return out, lse


def _masked_bwd_dq(q, k, v, out, lse, dout, mask_vecs, bias, causal,
                   sm_scale):
    """K8 dq kernel: (dq, delta [B, H, Sq] f32); delta is for the dk/dv
    and dbias kernels."""
    (b, h, sq, d, kvh, sk), lse, dout = _bwd_inputs(q, k, v, lse, dout)
    if (out.device != q.device or out.dtype != q.dtype
            or out.shape != q.shape or not _strided_ok(out)):
        raise ValueError(f"flash_mha_masked backward: out must be like q, "
                         f"got {out.dtype} {tuple(out.shape)} {out.stride()}")
    dq = _bshd_empty_like(q)
    delta = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    tbl = _table_scratch(q, mask_vecs, b, h, sk)
    err = _entry("flash_mask_bwd_dq", _BWD_ARGS)(
        _DTYPES[q.dtype], d, q.data_ptr(), k.data_ptr(), v.data_ptr(),
        out.data_ptr(), dout.data_ptr(), lse.data_ptr(), delta.data_ptr(),
        dq.data_ptr(), *_operands(mask_vecs, bias), _ptr(tbl), b, h,
        h // kvh, sq, sk, int(bool(causal)), float(sm_scale),
        _all_strides((q, k, v, out, dout, dq), mask_vecs, bias), _stream(q))
    cuda_lib.check("flash_mask", err, "flash_mha_masked dq launch")
    flash_mha_masked.dq_launches += 1
    return dq, delta


def _masked_bwd_dkv(q, k, v, lse, delta, dout, mask_vecs, bias, causal,
                    sm_scale):
    """K8 dk/dv kernel: (dk, dv) [B, kvH, Sk, D], summed per GQA group."""
    (b, h, sq, d, kvh, sk), lse, dout, delta = _bwd_inputs(q, k, v, lse,
                                                           dout, delta)
    dk, dv = _bshd_empty_like(k), _bshd_empty_like(v)
    tbl = _table_scratch(q, mask_vecs, b, h, sk)
    err = _entry("flash_mask_bwd_dkv", _BWD_ARGS)(
        _DTYPES[q.dtype], d, q.data_ptr(), k.data_ptr(), v.data_ptr(),
        dout.data_ptr(), lse.data_ptr(), delta.data_ptr(), dk.data_ptr(),
        dv.data_ptr(), *_operands(mask_vecs, bias), _ptr(tbl), b, kvh,
        h // kvh, sq, sk, int(bool(causal)), float(sm_scale),
        _all_strides((q, k, v, dout, dk, dv), mask_vecs, bias), _stream(q))
    cuda_lib.check("flash_mask", err, "flash_mha_masked dkv launch")
    flash_mha_masked.dkv_launches += 1
    return dk, dv


def _masked_bwd_dbias(q, k, v, lse, delta, dout, mask_vecs, bias, causal,
                      sm_scale):
    """K8 dbias kernel: dbias in the bias's shape and dtype, summed over
    its broadcast dims in-kernel (an f32 scratch of that shape carries
    the sum for a bf16/f16 bias with broadcast dims)."""
    (b, h, sq, d, kvh, sk), lse, dout, delta = _bwd_inputs(q, k, v, lse,
                                                           dout, delta)
    bb, hb = bias.shape[0], bias.shape[1]
    dbias = torch.empty((bb, hb, sq, sk), dtype=bias.dtype, device=q.device)
    acc = None
    if bias.dtype != torch.float32 and bb * hb < b * h:
        acc = torch.empty((bb, hb, sq, sk), dtype=torch.float32,
                          device=q.device)
    tbl = _table_scratch(q, mask_vecs, b, h, sk)
    err = _entry("flash_mask_bwd_dbias", _DBIAS_ARGS)(
        _DTYPES[q.dtype], d, q.data_ptr(), k.data_ptr(), v.data_ptr(),
        dout.data_ptr(), lse.data_ptr(), delta.data_ptr(),
        *_operands(mask_vecs, bias), dbias.data_ptr(),
        _ptr(acc), _ptr(tbl), b, h, h // kvh, bb, hb,
        sq, sk, int(bool(causal)), float(sm_scale),
        _all_strides((q, k, v, dout), mask_vecs, bias), _stream(q))
    cuda_lib.check("flash_mask", err, "flash_mha_biased dbias launch")
    flash_mha_masked.dbias_launches += 1
    return dbias


def _masked_bwd(q, k, v, out, lse, dout, mask_vecs, bias, causal, sm_scale,
                need_dbias):
    """K8 backward: (dq, dk, dv, dbias or None).  CPU tensors take the
    plain versions; CUDA tensors launch the dq kernel (which writes
    delta), the dk/dv kernel and, when ``need_dbias``, the dbias
    kernel."""
    if q.device.type == "cpu" or _route(q.shape[-1]) == "plain":
        full = (q, k, v, out, lse, dout, mask_vecs, bias, causal, sm_scale)
        return (_masked_bwd_dq_xla(*full), *_masked_bwd_dkv_xla(*full),
                _masked_bwd_dbias_xla(*full) if need_dbias else None)
    bias = _check_bias(bias, q.shape[0], q.shape[1], q.shape[2], k.shape[2])
    _check_mask(mask_vecs, q.shape[0], q.shape[1], k.shape[2])
    args = (mask_vecs, bias, causal, sm_scale)
    dq, delta = _masked_bwd_dq(q, k, v, out, lse, dout, *args)
    dk, dv = _masked_bwd_dkv(q, k, v, lse, delta, dout, *args)
    dbias = (_masked_bwd_dbias(q, k, v, lse, delta, dout, *args)
             if need_dbias else None)
    return dq, dk, dv, dbias


class _FlashMask(torch.autograd.Function):
    """The counterpart of the reference's ``custom_vjp``s
    (``flash_mha_masked`` ``:1010-1049``, ``flash_mha_biased``
    ``:1052-1090``): the forward writes lse and saves (q, k, v,
    mask_vecs, bias, out, lse); the backward recomputes p from lse.
    ``mask_vecs`` takes no gradient; dbias is computed only when the
    bias needs one."""

    @staticmethod
    def forward(ctx, q, k, v, mask_vecs, bias, causal, sm_scale):
        out, lse = _masked_fwd(q, k, v, mask_vecs, bias, causal, sm_scale,
                               need_lse=True)
        ctx.save_for_backward(q, k, v, mask_vecs, bias, out, lse)
        ctx.causal, ctx.sm_scale = causal, sm_scale
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, mask_vecs, bias, out, lse = ctx.saved_tensors
        dq, dk, dv, dbias = _masked_bwd(
            q, k, v, out, lse, dout, mask_vecs, bias, ctx.causal,
            ctx.sm_scale, need_dbias=ctx.needs_input_grad[4])
        return dq, dk, dv, None, dbias, None, None


def _attention(q, k, v, mask_vecs, bias, causal, sm_scale):
    """The autograd Function where a gradient will be taken, else the
    forward alone (no lse: serving's prefill)."""
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in (q, k, v, bias)):
        return _FlashMask.apply(q, k, v, mask_vecs, bias, bool(causal),
                                float(sm_scale))
    return _masked_fwd(q, k, v, mask_vecs, bias, causal, sm_scale,
                       need_lse=False)[0]


def flash_mha_masked(q, k, v, mask_vecs, causal, sm_scale):
    """[B, H, Sq, D] flash attention under flashmask intervals mask_vecs
    [B|1, H|1, 2 or 4, Sk] int32, differentiable in q, k and v; k/v [B,
    kvH, Sk, D] with H % kvH == 0 (GQA).  Any Sq, Sk; causal is
    bottom-right aligned.  Inputs may be strided views whose head dim is
    contiguous (the dispatcher passes transposed [B, S, H, D] tensors).
    CUDA inputs run the K8 kernels (float32 or bfloat16, head_dim 64, 128
    or 256); CPU inputs, and other head dims, run the plain versions.
    Returns [B, H, Sq, D] in q's dtype."""
    return _attention(q, k, v, mask_vecs, None, causal, sm_scale)


def flash_mha_biased(q, k, v, bias, causal, sm_scale):
    """[B, H, Sq, D] flash attention with an additive bias [B|1, H|1, Sq,
    Sk] (H the q heads), differentiable in q, k, v and the bias; as
    :func:`flash_mha_masked` otherwise."""
    return _attention(q, k, v, None, bias, causal, sm_scale)


# kernel launches (the main-path witnesses), counted by the wrappers:
# forwards without and with a bias, forwards that wrote lse (of either
# kind), and the backward kernels they share
flash_mha_masked.launches = 0
flash_mha_biased.launches = 0
flash_mha_masked.lse_launches = 0
flash_mha_masked.dq_launches = 0
flash_mha_masked.dkv_launches = 0
flash_mha_masked.dbias_launches = 0
_tile_table.launches = 0       # the table kernel alone (its check)
