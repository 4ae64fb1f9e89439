"""Dropless grouped expert FFN over a tile-aligned token buffer.

Ports ``paddle_tpu/ops/pallas/grouped_ffn.py``.  Tokens come sorted by
expert into a buffer ``x_buf [R, D]`` whose expert runs are padded to
``TILE``-row tiles (``R % TILE == 0``), so every row tile belongs to one
expert, ``emap[tile]``.  Per tile::

    out = act(x_t @ w1[e] + b1[e]) @ w2[e] + b2[e]

with act = silu, or (``gated=True``, swiglu) silu of the first half of
``w1``'s output times the second half.  ``TILE`` is the buffer's layout
contract (each expert's rows start on a 128-row boundary, ``emap`` has
one entry per 128 rows), kept so that buffers and ``emap`` are the
reference's; the CUDA kernels tile as they like.  ``emap`` is
non-decreasing (each expert's tiles are contiguous, trailing padding
tiles clipped to expert ``E - 1``), as the dispatch builds it.

:func:`grouped_ffn` is differentiable (a ``torch.autograd.Function``).
On CUDA tensors its forward and backward launch the kernels of
``csrc/grouped_ffn.cu`` (the port of the TPU kernel K9, ``_call_fwd``
and ``_call_bwd``) or raise; on CPU tensors they run the plain versions,
:func:`grouped_ffn_xla` (the reference's XLA path, whose name it keeps)
and :func:`_plain_bwd`, which repeats ``_bwd_kernel``'s numerics:

* f32 products and sums throughout; ``h`` rounded to x's dtype before
  the second product (forward) and before ``dw2`` (backward);
* ``ds`` rounded to x's dtype (``dsx``) for ``dx`` and ``dw1``, while
  ``db1`` sums the unrounded ``ds`` and ``db2`` sums ``dy``, in f32;
* experts that own no tile get zero gradients; each gradient comes out
  in its primal's dtype (biases may be float32 beside bf16 weights).

The kernels and the plain versions differ only in the order of their
f32 sums (and, in bf16, the last bits of the f32 sigmoid, which the
kernels take from the card's fast exp and reciprocal before rounding h
and ds to bf16).  On the card a forward call is two kernel launches and
a backward call eight (seven in float32; ``csrc/grouped_ffn.cu``);
``grouped_ffn.fwd_launches`` and ``grouped_ffn.bwd_launches`` count
calls, one per forward and one per backward.
"""
from __future__ import annotations

import ctypes

import torch

from .. import cuda_lib

__all__ = ["TILE", "grouped_ffn", "grouped_ffn_xla"]

TILE = 128
_P = ctypes.c_void_p
_I = ctypes.c_int
_FWD_ARGTYPES = (_I, _I, _I, _I, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                 _I, _I, _P)
_BWD_ARGTYPES = (_I, _I, _I, _I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                 _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_launch = {}                   # C entries, resolved at first CUDA use


# ------------------------------------------------------------ plain versions
def _silu_grad_parts(s):
    sig = torch.sigmoid(s)
    return s * sig, sig * (1.0 + s * (1.0 - sig))


def _act(s, gated):
    if gated:
        half = s.shape[-1] // 2
        u = s[:, :half]
        return u * torch.sigmoid(u) * s[:, half:]
    return s * torch.sigmoid(s)


def _expert_rows(emap, device):
    """``[(expert, row indices of its tiles)]`` for every expert that owns
    a tile, in expert order (one host read of ``emap``)."""
    owned = {}
    for t, e in enumerate(emap.tolist()):
        owned.setdefault(e, []).append(t)
    lane = torch.arange(TILE, device=device)
    return [(e, (torch.tensor(tiles, device=device)[:, None] * TILE
                 + lane).reshape(-1)) for e, tiles in sorted(owned.items())]


def grouped_ffn_xla(x_buf, w1, b1, w2, b2, emap, gated=False):
    """The plain forward (differentiable by autograd): per expert, f32
    products, ``h`` rounded to x's dtype, the output cast once."""
    xdt = x_buf.dtype
    out = x_buf.new_zeros((x_buf.shape[0], w2.shape[2]))
    for e, rows in _expert_rows(emap, x_buf.device):
        s = x_buf[rows].float() @ w1[e].float() + b1[e].float()
        h = _act(s, gated).to(xdt)
        o = h.float() @ w2[e].float() + b2[e].float()
        out = out.index_copy(0, rows, o.to(xdt))
    return out


def _plain_bwd(x_buf, dy, w1, b1, w2, b2_dtype, emap, gated):
    """The plain backward, ``_bwd_kernel``'s numerics: (dx, dw1, db1,
    dw2, db2), each in its primal's dtype."""
    xdt = x_buf.dtype
    e_n, d, f2 = w1.shape
    f, dout = w2.shape[1], w2.shape[2]
    f32 = dict(dtype=torch.float32, device=x_buf.device)
    dx = torch.zeros_like(x_buf)
    dw1 = torch.zeros((e_n, d, f2), **f32)
    dw2 = torch.zeros((e_n, f, dout), **f32)
    db1 = torch.zeros((e_n, f2), **f32)
    db2 = torch.zeros((e_n, dout), **f32)
    for e, rows in _expert_rows(emap, x_buf.device):
        xe, dye = x_buf[rows].float(), dy[rows].float()
        s = xe @ w1[e].float() + b1[e].float()
        dh = dye @ w2[e].float().T
        if gated:
            u, g = s[:, :f], s[:, f:]
            su, du = _silu_grad_parts(u)
            h = su * g
            ds = torch.cat([dh * g * du, dh * su], dim=-1)
        else:
            h, du = _silu_grad_parts(s)
            ds = dh * du
        dsx = ds.to(xdt).float()
        dx[rows] = (dsx @ w1[e].float().T).to(xdt)
        dw1[e] = xe.T @ dsx
        dw2[e] = h.to(xdt).float().T @ dye
        db1[e] = ds.sum(0)
        db2[e] = dye.sum(0)
    return (dx, dw1.to(w1.dtype), db1.to(b1.dtype), dw2.to(w2.dtype),
            db2.to(b2_dtype))


# ------------------------------------------------------------------ kernels
def _check(x_buf, w1, b1, w2, b2, emap, gated, dy=None):
    """Shapes, dtypes and layout the CUDA kernels take; returns
    (R, D, F, Dout, E)."""
    tensors = [x_buf, w1, b1, w2, b2, emap] + ([dy] if dy is not None
                                                else [])
    if any(t.device != x_buf.device for t in tensors):
        raise ValueError("grouped_ffn: all inputs must be on one device, "
                         f"got {[str(t.device) for t in tensors]}")
    xdt = x_buf.dtype
    if xdt not in _DTYPES or w1.dtype != xdt or w2.dtype != xdt \
            or (dy is not None and dy.dtype != xdt):
        raise TypeError("grouped_ffn kernels take float32 or bfloat16 x, "
                        "with w1, w2 (and dy) of x's dtype, got "
                        f"{xdt}/{w1.dtype}/{w2.dtype}")
    if b1.dtype not in (torch.float32, xdt) or \
            b2.dtype not in (torch.float32, xdt):
        raise TypeError("grouped_ffn: biases must be float32 or x's dtype, "
                        f"got {b1.dtype}/{b2.dtype}")
    if emap.dtype != torch.int32:
        raise TypeError(f"grouped_ffn: emap must be int32, got {emap.dtype}")
    r, d = x_buf.shape
    e, f = w2.shape[0], w2.shape[1]
    dout = w2.shape[2]
    f2 = 2 * f if gated else f
    if r % TILE or r == 0:
        raise ValueError(f"grouped_ffn: R = {r} must be a positive multiple "
                         f"of {TILE}")
    want = {"w1": (e, d, f2), "b1": (e, f2), "b2": (e, dout),
            "emap": (r // TILE,)}
    got = {"w1": w1.shape, "b1": b1.shape, "b2": b2.shape,
           "emap": emap.shape}
    if dy is not None:
        want["dy"], got["dy"] = (r, dout), dy.shape
    bad = {k: tuple(got[k]) for k in want if tuple(got[k]) != want[k]}
    if bad:
        raise ValueError(f"grouped_ffn: shapes {bad} do not match x_buf "
                         f"{tuple(x_buf.shape)} and w2 {tuple(w2.shape)} "
                         f"(gated={gated}): want {want}")
    if d % 8 or f % 8 or dout % 8:
        raise ValueError(f"grouped_ffn kernels take D, F, D' in multiples "
                         f"of 8, got {d}, {f}, {dout}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("grouped_ffn kernels take contiguous inputs")
    if any(t.data_ptr() % 16 for t in (x_buf, w1, w2, dy)
           if t is not None):
        raise ValueError("grouped_ffn kernels take 16-byte aligned x_buf, "
                         "w1, w2 and dy")
    return r, d, f, dout, e


def _entry(symbol, argtypes):
    if symbol not in _launch:
        _launch[symbol] = cuda_lib.kernel("grouped_ffn", symbol, argtypes)
    return _launch[symbol]


def _kernel_fwd(x_buf, w1, b1, w2, b2, emap, gated):
    r, d, f, dout, e = _check(x_buf, w1, b1, w2, b2, emap, gated)
    h = torch.empty((r, f), dtype=x_buf.dtype, device=x_buf.device)
    out = torch.empty((r, dout), dtype=x_buf.dtype, device=x_buf.device)
    err = _entry("grouped_ffn_fwd", _FWD_ARGTYPES)(
        _DTYPES[x_buf.dtype], _DTYPES[b1.dtype], _DTYPES[b2.dtype],
        int(gated), x_buf.data_ptr(), w1.data_ptr(), b1.data_ptr(),
        w2.data_ptr(), b2.data_ptr(), emap.data_ptr(), h.data_ptr(),
        out.data_ptr(), r, d, f, dout, e,
        torch.cuda.current_stream(x_buf.device).cuda_stream)
    cuda_lib.check("grouped_ffn", err, "grouped_ffn forward launch")
    grouped_ffn.fwd_launches += 1
    return out


def _kernel_bwd(x_buf, dy, w1, b1, w2, b2, emap, gated):
    r, d, f, dout, e = _check(x_buf, w1, b1, w2, b2, emap, gated, dy)
    f2 = w1.shape[2]
    dev = x_buf.device
    dsx = torch.empty((r, f2), dtype=x_buf.dtype, device=dev)
    hx = torch.empty((r, f), dtype=x_buf.dtype, device=dev)
    db1_part = torch.empty((r // TILE, f2), dtype=torch.float32, device=dev)
    db2_part = torch.empty((r // TILE, dout), dtype=torch.float32, device=dev)
    tiles = torch.empty(e * (r // TILE + 1), dtype=torch.int32, device=dev)
    dx = torch.empty_like(x_buf)
    dw1 = torch.empty_like(w1)
    dw2 = torch.empty_like(w2)
    db1 = torch.empty_like(b1)
    db2 = torch.empty_like(b2)
    err = _entry("grouped_ffn_bwd", _BWD_ARGTYPES)(
        _DTYPES[x_buf.dtype], _DTYPES[b1.dtype], _DTYPES[b2.dtype],
        int(gated), x_buf.data_ptr(), dy.data_ptr(), w1.data_ptr(),
        b1.data_ptr(), w2.data_ptr(), emap.data_ptr(), dsx.data_ptr(),
        hx.data_ptr(), db1_part.data_ptr(), db2_part.data_ptr(),
        tiles.data_ptr(), dx.data_ptr(), dw1.data_ptr(), dw2.data_ptr(),
        db1.data_ptr(), db2.data_ptr(), r, d, f, dout, e,
        torch.cuda.current_stream(dev).cuda_stream)
    cuda_lib.check("grouped_ffn", err, "grouped_ffn backward launch")
    grouped_ffn.bwd_launches += 1
    return dx, dw1, db1, dw2, db2


def _forward(x_buf, w1, b1, w2, b2, emap, gated):
    if x_buf.device.type == "cpu":
        return grouped_ffn_xla(x_buf, w1, b1, w2, b2, emap, gated)
    return _kernel_fwd(x_buf, w1, b1, w2, b2, emap, gated)


def _backward(x_buf, dy, w1, b1, w2, b2, emap, gated):
    if x_buf.device.type == "cpu":
        return _plain_bwd(x_buf, dy, w1, b1, w2, b2.dtype, emap, gated)
    return _kernel_bwd(x_buf, dy, w1, b1, w2, b2, emap, gated)


class _GroupedFFN(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x_buf, w1, b1, w2, b2, emap, gated):
        ctx.save_for_backward(x_buf, w1, b1, w2, b2, emap)
        ctx.gated = gated
        return _forward(x_buf, w1, b1, w2, b2, emap, gated)

    @staticmethod
    def backward(ctx, dy):
        x_buf, w1, b1, w2, b2, emap = ctx.saved_tensors
        grads = _backward(x_buf, dy.contiguous(), w1, b1, w2, b2, emap,
                          ctx.gated)
        return (*grads, None, None)


def grouped_ffn(x_buf, w1, b1, w2, b2, emap, gated=False):
    """Tile-aligned grouped expert FFN: x_buf [R, D] (R % 128 == 0, the
    rows of row tile t belong to expert emap[t], int32), w1 [E, D, F(*2)],
    b1 [E, F(*2)], w2 [E, F, D'], b2 [E, D'].  gated=True treats w1's
    output as [up | gate] halves (swiglu).  Returns [R, D'] in x's
    dtype; differentiable in x_buf, w1, b1, w2 and b2."""
    return _GroupedFFN.apply(x_buf, w1, b1, w2, b2, emap, gated)


grouped_ffn.fwd_launches = 0   # forward calls on the card (main-path witness)
grouped_ffn.bwd_launches = 0   # backward calls on the card
