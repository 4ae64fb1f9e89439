"""Paged (block-table) KV-cache attention — the serving decode kernel.

Ports ``paddle_tpu/ops/pallas/paged_attention.py``.  Each sequence owns
a list of fixed-size pages in one shared pool, so device memory scales
with the tokens resident, not batch * max_len.  Table padding points at
a shared DUMP page (never a real one); only the first
``ceil(lens / page_size)`` pages of a row are read.

Layout: pool [num_pages, kvH, page_size, D], table [B, max_pages]
int32, lens [B] int32 = tokens visible per sequence.  Inference only.

:func:`paged_attention` is the wrapper of the CUDA kernel
``csrc/paged_attention.cu`` (the port of the TPU kernel K3).  On CPU
tensors it runs :func:`paged_attention_xla`, the plain dense-gather
version; on CUDA tensors it launches the kernel or raises.  The
reference runs its kernel at every head dim and group
(``select_paged_attention``, ``:58-61``), and so does the port, with
two bodies (:func:`_body`): the ``mma.sync`` kernel at every head dim
that is a multiple of 16 from 16 to 256, and a CUDA-core body at every
other head dim (:func:`_any_plan`), any GQA group and page size both.

The ``mma.sync`` kernel makes one launch per call.  It splits the table span W *
page_size of each (sequence, kv head, group of 16 query heads) into
:func:`_splits` chunks; the last CTA of a row to finish merges the
splits of that row, using a counter per row that it leaves at zero.
The split count comes from shapes only, never from ``lens``, which stays
on the device (no sync, so a CUDA graph can capture the call): enough
splits that the grid holds ``_WAVES`` (4) times the CTAs the card runs
at once, in chunks of at least 256 keys.  That serves the serving path,
whose table spans the model's whole length (8192 keys at llama3_8b)
while its rows hold a few hundred to a few thousand tokens: short
chunks let a ragged batch spread its live keys over the card, the
splits past a row's ``lens`` return at once, and a batch of full rows
still runs in about four waves with a small last one.  The partials and
counters live in buffers kept per device and stream
(:func:`cuda_lib.scratch`), so calls on one device must run on one
stream at a time.  The CUDA-core body makes two launches per call (the
chunks of 256 keys, then their merge in chunk order) and counts as one
call in :attr:`paged_attention.launches`.

The two differ where the reference's two paths differ: the kernel
rounds the unnormalised probabilities to v's dtype before P.V (as the
TPU kernel does), the plain version rounds the normalised ones.  In
float32 that is no difference; in bf16 it is within one bf16 rounding
of the output, which the kernel-vs-plain tolerance covers.  With
``lens == 0`` the kernel writes zeros and the plain version gives NaN;
the engine never passes 0 (an idle slot runs with lens = pos + 1 = 1).

The int8 KV page mode (:func:`quantize_kv_rows`,
:func:`gather_kv_pages_quant`, :func:`paged_attention_quant`) is plain
PyTorch: the reference runs it on XLA and has no kernel for it.

Under serving tensor parallelism each rank holds ``kvH / tp`` heads of
the pools and ``nh / tp`` query heads: ``select_paged_attention(tp_axis=
group)`` and ``paged_attention_quant(..., tp_axis=group)`` check that the
local q heads group onto the local kv heads and run the same body on
them.  No collective runs inside attention.
"""
from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

from .. import cuda_lib

__all__ = ["paged_attention", "paged_attention_xla", "PagedPool",
           "select_paged_attention", "gather_kv_pages",
           "gather_kv_pages_quant", "gather_scale_pages",
           "paged_attention_quant", "quantize_kv_rows"]

KERNEL_HEAD_DIMS = tuple(range(16, 257, 16))   # the kernel's instances
# head dims whose shared-memory rows take the XOR swizzle (kXorRows); the
# others carry one 16-byte chunk of padding a row
_XOR_ROW_DIMS = (32, 64, 128, 256)
_TILE = 64                     # kTile: keys per ring stage
_MIN_CHUNK = 256               # keys of a split, at least
_MAX_SPLIT = 64                # kMaxSplit
_WAVES = 4                     # grid CTAs per CTA slot of the card
_F32_CHUNK = 256               # kChunkF32: keys per CTA of the f32 pass
_SMEM_PER_SM = 228 * 1024      # shared memory of an sm_90 SM
_SMEM_STATIC = 2 * 1024        # per CTA beside it: the page-row table, and
                               # the 1 KB the card reserves
_MAX_SPAN = 1 << 30            # W * page_size, at most
_P = ctypes.c_void_p
_I = ctypes.c_int
_ARGTYPES = (_I, _I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
             _I, _I, ctypes.c_float, _P)
_ANY_ARGTYPES = (_I, _I, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                 _I, _I, _I, _I, ctypes.c_float, _P)
_ANY_CHUNK = 256               # keys per CTA of the CUDA-core body
_ANY_TILE = 64                 # keys per tile of it, at most
_ANY_ROWS = 16                 # query heads per CTA of it, at most
_ANY_SMEM = 227 * 1024         # the shared memory a block may take
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_launch = None                 # the C entries, resolved at first CUDA use
_launch_any = None


def _check_local_heads(q, kpool):
    """The head-parallel precondition: this rank's q heads group onto
    its kv heads (tp divides both head counts)."""
    nh_l, kvh_l = q.shape[1], kpool.shape[1]
    if kvh_l == 0 or nh_l % kvh_l:
        raise ValueError(
            f"head-parallel paged attention: local q heads {nh_l} do not "
            f"group onto local KV heads {kvh_l}: the tp size must divide "
            "both head counts")


def select_paged_attention(tp_axis=None):
    """The paged-attention callable shared by every decode path.
    ``tp_axis`` (the tensor-parallel group) selects the head-parallel
    variant: the pools hold this rank's kv heads, so the same kernel
    runs on the local heads after :func:`_check_local_heads`."""
    if tp_axis is None:
        return paged_attention

    def head_parallel(q, kpool, vpool, table, lens):
        _check_local_heads(q, kpool)
        return paged_attention(q, kpool, vpool, table, lens)

    return head_parallel


def paged_attention(q, kpool, vpool, table, lens):
    """q [B, nh, D]; pools [P, kvH, page_size, D]; table [B, max_pages]
    int32 page ids (padding = the dump page); lens [B] int32 visible
    tokens.  Returns [B, nh, D] in q's dtype."""
    global _launch
    if q.device.type == "cpu":
        return paged_attention_xla(q, kpool, vpool, table, lens)
    b, nh, d = _check(q, kpool, vpool, table, lens)
    kvh, ps, w = kpool.shape[1], kpool.shape[2], table.shape[1]
    rep = nh // kvh
    dev = q.device
    stream = torch.cuda.current_stream(dev).cuda_stream
    span = w * ps
    out = torch.empty_like(q)
    if _body(d) == "any":
        _launch_any_body(q, kpool, vpool, table, lens, out, rep, stream)
        paged_attention.launches += 1
        return out
    part_ml = part_o = tickets = None
    if q.dtype == torch.float32:
        n_split, chunk = -(-span // _F32_CHUNK), _F32_CHUNK
        n_ml, n_o = b * nh * n_split * 2, b * nh * n_split * d
    else:
        ctas = b * kvh * -(-rep // 16)
        n_split, chunk = _splits(ctas, span, cuda_lib.sm_count(dev), d)
        n_ml, n_o = ctas * n_split * 16 * 2, ctas * n_split * 16 * d
        if n_split > 1:
            tickets = cuda_lib.scratch("paged_attention.tickets", dev,
                                       stream, ctas, torch.int32,
                                       zeroed=True).data_ptr()
    if q.dtype == torch.float32 or n_split > 1:
        part = cuda_lib.scratch("paged_attention.partials", dev, stream,
                                n_ml + n_o, torch.float32)
        part_ml, part_o = part.data_ptr(), part.data_ptr() + 4 * n_ml
    if _launch is None:
        _launch = cuda_lib.kernel("paged_attention", "paged_attention_fwd",
                                  _ARGTYPES)
    err = _launch(_DTYPES[q.dtype], d, q.data_ptr(), kpool.data_ptr(),
                  vpool.data_ptr(), table.data_ptr(), lens.data_ptr(),
                  out.data_ptr(), part_ml, part_o, tickets, b, kvh, rep, ps,
                  w, n_split, chunk, 1.0 / math.sqrt(d), stream)
    cuda_lib.check("paged_attention", err, "paged_attention launch")
    paged_attention.launches += 1
    return out


paged_attention.launches = 0   # kernel launches (the main-path witness)


def _route(head_dim, group):
    """"kernel" at every head dim and group, as the reference runs its
    kernel at every shape (no plain route exists on the card); which
    body serves a head dim is :func:`_body`'s choice."""
    if head_dim < 1 or group < 1:
        raise ValueError(f"paged_attention (K3): head_dim {head_dim}, "
                         f"group {group}: both must be at least 1")
    return "kernel"


def _body(head_dim):
    """"mma" where a ``mma.sync`` instance is built (every multiple of
    16 from 16 to 256), "any" (the CUDA-core body) at every other head
    dim."""
    return "mma" if head_dim in KERNEL_HEAD_DIMS else "any"


def _any_smem(d, tile, rows):
    """The CUDA-core body's dynamic shared memory: K and V tiles, Q and
    the accumulators, the tile's probabilities and (m, l, alpha), f32."""
    return (2 * tile * d + 2 * rows * d + rows * tile + 3 * rows) * 4


def _any_plan(d, rep):
    """(tile, rows) of the CUDA-core body at head_dim ``d`` and group
    ``rep``: 64 keys a tile and up to 16 query heads a CTA, halved (tile
    first, down to 8 keys, then the rows, then the tile again) until the
    shared memory fits a block; a head dim too wide for even one key and
    one row (above 14,527) raises."""
    tile, rows = _ANY_TILE, min(_ANY_ROWS, rep)
    while _any_smem(d, tile, rows) > _ANY_SMEM and tile > 8:
        tile //= 2
    while _any_smem(d, tile, rows) > _ANY_SMEM and rows > 1:
        rows = -(-rows // 2)
    while _any_smem(d, tile, rows) > _ANY_SMEM and tile > 1:
        tile //= 2
    if _any_smem(d, tile, rows) > _ANY_SMEM:
        raise ValueError(f"paged_attention: head_dim {d} leaves no room "
                         "for one key and one query head in a block's "
                         "shared memory")
    return tile, rows


def launch_splits(b, nh, kvh, ps, w, d, dtype, sms):
    """The key splits (chunks) one call makes at these shapes: the
    mma kernel's :func:`_splits` in bf16, 256-key chunks in f32 and in
    the CUDA-core body."""
    if dtype == torch.bfloat16 and _body(d) == "mma":
        return _splits(b * kvh * -(-(nh // kvh) // 16), w * ps, sms, d)[0]
    return -(-(w * ps) // _ANY_CHUNK)


def _launch_any_body(q, kpool, vpool, table, lens, out, rep, stream):
    """Launch the CUDA-core body (two kernels) into ``out``."""
    global _launch_any
    b, nh, d = q.shape
    kvh, ps, w = kpool.shape[1], kpool.shape[2], table.shape[1]
    tile, rows = _any_plan(d, rep)
    n_chunks = -(-(w * ps) // _ANY_CHUNK)
    n_ml, n_o = b * nh * n_chunks * 2, b * nh * n_chunks * d
    part = cuda_lib.scratch("paged_attention.partials", q.device, stream,
                            n_ml + n_o, torch.float32)
    if _launch_any is None:
        _launch_any = cuda_lib.kernel("paged_attention",
                                      "paged_attention_any_fwd",
                                      _ANY_ARGTYPES)
    err = _launch_any(_DTYPES[q.dtype], d, q.data_ptr(), kpool.data_ptr(),
                      vpool.data_ptr(), table.data_ptr(), lens.data_ptr(),
                      out.data_ptr(), part.data_ptr(),
                      part.data_ptr() + 4 * n_ml, b, kvh, rep, ps, w,
                      n_chunks, _ANY_CHUNK, tile, rows, 1.0 / math.sqrt(d),
                      stream)
    cuda_lib.check("paged_attention", err, "paged_attention launch")


def _smem(d):
    """The bf16 kernel's dynamic shared memory at head_dim d, whatever
    the page size (Smem<D>::kBytes): Q [16, d] and three stages of K and
    V [64, d] tiles, each row 2d bytes, or d / 8 + 1 16-byte chunks
    where it is padded; at most 200 KB (d 256), within the 227 KB a
    block may take."""
    row = 2 * d if d in _XOR_ROW_DIMS else (d // 8 + 1) * 16
    return (16 + 3 * 2 * _TILE) * row


def _splits(ctas, span, sms, d):
    """(n_split, chunk) for the bf16 kernel: key splits of ``chunk``
    keys (a multiple of 64) over a table span of ``span`` keys for
    ``ctas`` (sequence, kv head, group) rows.  As many splits as put
    ``_WAVES`` times the card's CTA slots in the grid (``sms`` times the
    CTAs an SM holds at head_dim ``d``, by shared memory: 8, 4, 2 and 1
    at d 32, 64, 128 and 256), chunks of at least ``_MIN_CHUNK`` keys,
    at most ``_MAX_SPLIT`` splits; one split where the rows fill that
    many slots already."""
    slots = sms * (_SMEM_PER_SM // (_smem(d) + _SMEM_STATIC))
    want = max(1, min(_WAVES * slots // ctas, -(-span // _MIN_CHUNK),
                      _MAX_SPLIT))
    chunk = -(-(-(-span // want)) // _TILE) * _TILE
    return -(-span // chunk), chunk


def _check(q, kpool, vpool, table, lens):
    """Validate what the kernel takes; raise on anything else."""
    tensors = (q, kpool, vpool, table, lens)
    if any(t.device != q.device for t in tensors):
        raise ValueError("paged_attention: all inputs must be on one "
                         f"device, got {[str(t.device) for t in tensors]}")
    if q.dtype not in _DTYPES or kpool.dtype != q.dtype \
            or vpool.dtype != q.dtype:
        raise TypeError(
            "paged_attention kernel takes float32 or bfloat16 q/k/v of one "
            f"dtype, got {q.dtype}/{kpool.dtype}/{vpool.dtype}")
    if table.dtype != torch.int32 or lens.dtype != torch.int32:
        raise TypeError("paged_attention: table and lens must be int32, "
                        f"got {table.dtype}/{lens.dtype}")
    if q.dim() != 3 or kpool.dim() != 4 or kpool.shape != vpool.shape:
        raise ValueError(
            f"paged_attention: q {tuple(q.shape)} must be [B, nh, D] and "
            f"pools {tuple(kpool.shape)}/{tuple(vpool.shape)} equal "
            "[P, kvH, page_size, D]")
    b, nh, d = q.shape
    kvh, ps = kpool.shape[1], kpool.shape[2]
    if kpool.shape[3] != d or nh % kvh:
        raise ValueError(f"paged_attention: q {tuple(q.shape)} must match "
                         f"the pools' head_dim and group onto their kv "
                         f"heads, got pools {tuple(kpool.shape)}")
    _route(d, nh // kvh)
    if _body(d) == "any":
        _any_plan(d, nh // kvh)          # raises past the widest head dim
        if b * kvh > 65535:
            raise ValueError(f"paged_attention: B * kvH = {b * kvh} rows, "
                             f"at most 65535 at head_dim {d}")
    if table.dim() != 2 or table.shape[0] != b or tuple(lens.shape) != (b,):
        raise ValueError(
            f"paged_attention: table {tuple(table.shape)} must be [B, W] "
            f"and lens {tuple(lens.shape)} [B] for B={b}")
    if table.shape[1] * ps > _MAX_SPAN or table.shape[1] < 1:
        raise ValueError(f"paged_attention: a table of {table.shape[1]} "
                         f"pages of {ps} tokens: 1 to {_MAX_SPAN} tokens")
    if kpool.shape[0] * kvh * ps >= 1 << 32:
        raise ValueError(f"paged_attention: pools of {kpool.shape[0]} "
                         f"pages x {kvh} heads x {ps} rows: fewer than "
                         "2^32 rows")
    if q.dtype == torch.float32 and b * kvh > 65535:
        raise ValueError(f"paged_attention: B * kvH = {b * kvh} rows, at "
                         "most 65535 in float32")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("paged_attention kernel takes contiguous inputs")
    if _body(d) == "mma" and (q.data_ptr() % 16 or kpool.data_ptr() % 16
                              or vpool.data_ptr() % 16):
        raise ValueError("paged_attention: q and pools must be 16-byte "
                         "aligned")
    return b, nh, d


def gather_kv_pages(pool, table):
    """Materialize a block table's pages token-major: ``pool``
    [P, kvH, page_size, D], ``table`` [..., W] int32 page ids
    (dump-padded) -> [..., W * page_size, kvH, D].  The dense-gather
    building block shared by :func:`paged_attention_xla` and the serving
    engine's cached prefill."""
    kvh, ps, d = pool.shape[1:]
    g = pool[table.long()]                      # [..., W, kvh, ps, d]
    g = g.transpose(-3, -2)                     # [..., W, ps, kvh, d]
    return g.reshape(tuple(table.shape[:-1]) + (table.shape[-1] * ps, kvh, d))


def paged_attention_xla(q, kpool, vpool, table, lens):
    """The plain PyTorch version (the reference's dense-gather XLA path,
    whose name it keeps): materializes each sequence's pages —
    O(B * max_pages * page_size) memory."""
    b, nh, d = q.shape
    kvh = kpool.shape[1]
    rep = nh // kvh
    # [B, W*ps, kvh, D] -> [B, kvh, W*ps, D]
    kb = gather_kv_pages(kpool, table).transpose(1, 2)
    vb = gather_kv_pages(vpool, table).transpose(1, 2)
    kq = kb.repeat_interleave(rep, dim=1)
    vq = vb.repeat_interleave(rep, dim=1)
    logits = torch.einsum("bhd,bhtd->bht", q.float(), kq.float()) \
        / math.sqrt(d)
    tpos = torch.arange(kb.shape[2], device=q.device)
    valid = tpos[None, None, :] < lens.to(q.device)[:, None, None]
    logits = logits.masked_fill(~valid, -math.inf)
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum("bht,bhtd->bhd", probs, vq)


# --------------------------------------------------- int8 KV page mode
def quantize_kv_rows(x):
    """Symmetric per-(token, head) int8 quantization of new KV rows:
    ``x`` [..., D] float -> (q int8 [..., D], scale f32 [...]).  The
    amax runs on the float input, the scale is floored so all-zero rows
    divide cleanly, and values round (half to even) into [-127, 127]."""
    xf = x.float()
    amax = xf.abs().amax(dim=-1)
    scale = torch.clamp(amax / 127.0, min=1e-8)
    q = torch.clamp(torch.round(xf / scale[..., None]), -127.0, 127.0)
    return q.to(torch.int8), scale


def gather_scale_pages(scale, table):
    """Scale-pool mirror of :func:`gather_kv_pages`: ``scale``
    [P, kvH, page_size] f32, ``table`` [..., W] int32 ->
    [..., W * page_size, kvH] token-major."""
    kvh, ps = scale.shape[1:]
    g = scale[table.long()].transpose(-2, -1)     # [..., W, ps, kvh]
    return g.reshape(tuple(table.shape[:-1]) + (table.shape[-1] * ps, kvh))


def gather_kv_pages_quant(pool, scale, table, dtype=torch.float32):
    """Dequantizing gather: int8 ``pool`` + per-row ``scale`` -> float
    token-major [..., W * page_size, kvH, D] in ``dtype``."""
    g = gather_kv_pages(pool, table).float()
    s = gather_scale_pages(scale, table)
    return (g * s[..., None]).to(dtype)


def paged_attention_quant(q, kpool, vpool, kscale, vscale, table, lens,
                          tp_axis=None):
    """Paged attention over int8 KV pools with per-(page-row, head) f32
    scales: the dense-gather formulation of :func:`paged_attention_xla`
    with the dequantization fused into the page gather.  It gathers the
    whole table width of every row (the reference's XLA path); there is
    no kernel for int8 pages.  ``tp_axis`` (the tensor-parallel group)
    marks a head-parallel caller whose pools hold its own kv heads: the
    local head grouping is checked, and attention needs no collective."""
    if tp_axis is not None:
        _check_local_heads(q, kpool)
    b, nh, d = q.shape
    kvh = kpool.shape[1]
    rep = nh // kvh
    # [B, W*ps, kvh, D] -> [B, kvh, W*ps, D], dequantized at the gather;
    # q heads group onto their kv head ([B, kvh, rep, D]) instead of the
    # reference's repeat of K/V (the same products)
    kb = gather_kv_pages_quant(kpool, kscale, table, q.dtype).transpose(1, 2)
    vb = gather_kv_pages_quant(vpool, vscale, table, q.dtype).transpose(1, 2)
    qg = q.reshape(b, kvh, rep, d)
    logits = torch.einsum("bgrd,bgtd->bgrt", qg.float(), kb.float()) \
        / math.sqrt(d)
    tpos = torch.arange(kb.shape[2], device=q.device)
    valid = tpos[None, None, None, :] < lens.to(q.device)[:, None, None,
                                                          None]
    logits = logits.masked_fill(~valid, -math.inf)
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum("bgrt,bgtd->bgrd", probs, vb).reshape(b, nh, d)


class PagedPool:
    """Host-side page allocator for one static batch (the one-shot paged
    generate): each sequence reserves ceil((len + max_new) / page_size)
    pages up front; the shared pool holds exactly the reserved pages
    plus one dump page that absorbs writes through table padding."""

    def __init__(self, lengths, max_new_tokens, page_size=128,
                 min_table_width=0):
        lengths = np.asarray(lengths, np.int64)
        self.page_size = int(page_size)
        need = -(-(lengths + max_new_tokens) // self.page_size)
        self.dump_page = int(need.sum())
        self.num_pages = self.dump_page + 1
        self.max_pages = max(int(need.max()), int(min_table_width))
        table = np.full((len(lengths), self.max_pages), self.dump_page,
                        np.int32)
        start = 0
        for i, n in enumerate(need):
            table[i, :n] = np.arange(start, start + n)
            start += n
        self.table = table
        self.reserved = need
