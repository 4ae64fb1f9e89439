"""Weight-only int8/int4 matmul for the memory-bound decode path.

Ports ``paddle_tpu/ops/pallas/quant_matmul.py``.  A
:class:`QuantizedWeight` holds int8 values (nibble-packed ``[K/2, N]``
for int4: row 2k in the low nibble, row 2k+1 in the high one) and a
per-output-channel f32 scale; ``x @ dequant(w)`` accumulates in f32,
multiplies the accumulator by the scale and casts once to x's dtype.

:func:`weight_only_matmul` keeps the reference's routing rule
(``quant_matmul.py:230-236``): decode-shaped calls (``M <= 64`` rows,
N a multiple of 128, an even K for int4) take the GEMV kernel, the
others the dequant-matmul path.

  * On CPU tensors every call runs :func:`_xla_fallback`, the plain
    version (the reference's XLA path, whose name it keeps).
  * On CUDA tensors the kernel route launches ``csrc/quant_matmul.cu``
    (the port of the TPU kernel K4, ``_pallas_int8``/``_pallas_int4``)
    or raises; there is no probe and no quiet fallback.  The other
    route is one ``torch.matmul`` against ``q`` cast to x's dtype, the
    f32 scale on the result, cast back (the reference's XLA route;
    counted in ``weight_only_matmul.matmul_calls``).

An int8 or int4 value is exact in bf16 and in f32.  For bf16 x the
kernel widens the weights to bf16 and runs them through the tensor cores
with an f32 accumulator, as the Pallas body's bf16 dot does; for f32 x
it runs f32 FMAs on the CUDA cores.  Either way the kernel and the plain
version differ only in summation order (and, for bf16 x, in the one
rounding of the output).

The kernel makes one launch per call.  The wrapper splits K (:func:`
_mma_splits`) until the grid holds about two CTAs per SM; the last CTA
of a column block sums the splits in order, using a counter per block
that it leaves at zero.  The partial sums and counters live in buffers
kept per device and stream (:func:`cuda_lib.scratch`), so calls on one
device must run on one stream at a time.
"""
from __future__ import annotations

import ctypes

import torch

from .. import cuda_lib

__all__ = ["QuantizedWeight", "pack_int4", "unpack_int4",
           "weight_only_matmul"]

# decode-shaped calls (M rows at most this) take the GEMV kernel;
# larger M is compute-bound and runs the dequant-matmul path
_GEMV_MAX_ROWS = 64
_BN = 128                      # kBN / kMmaBN in the kernel: columns per CTA
_MT = 8                        # kMT: rows of x per CTA (f32)
_MIN_SPLIT_ROWS = 64           # the fewest q rows a K split takes (f32)
_STAGE_ROWS = 64               # kQRows: q rows per ring stage (bf16)
_MIN_SPLIT_STAGES = 2          # the fewest stages a K split takes (bf16)
_CTAS_PER_SM = 2               # the bf16 grid's aim
_MAX_SPLIT = 16                # K splits at most (bf16)
_P = ctypes.c_void_p
_I = ctypes.c_int
_ARGTYPES = (_I, _I, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_launch = None                 # the C entry, resolved at first CUDA use


class QuantizedWeight:
    """A weight-only-quantized matmul weight: int8 values (nibble-packed
    ``[K/2, N]`` for int4) + per-output-channel f32 scale ``[N]``, with
    the logical ``k``.  ``.to(device)`` moves both tensors, so the
    serving runner places it like the dense weight it replaces."""

    def __init__(self, q, scale, kind="int8", k=None):
        self.q = q
        self.scale = scale
        self.kind = kind                      # "int8" | "int4"
        self.k = int(k if k is not None else q.shape[0])   # logical K

    @property
    def shape(self):
        return (self.k, self.q.shape[1])

    def to(self, device):
        return QuantizedWeight(self.q.to(device), self.scale.to(device),
                               kind=self.kind, k=self.k)

    def dequantize(self, dtype=torch.bfloat16):
        q = unpack_int4(self.q, self.k) if self.kind == "int4" else self.q
        return (q.float() * self.scale.float()).to(dtype)


def pack_int4(q):
    """[K, N] int8 values in [-8, 7] -> [K/2, N] int8, row 2k in the low
    nibble and row 2k+1 in the high nibble."""
    k = q.shape[0]
    if k % 2:
        raise ValueError(f"int4 packing needs even K, got {k}")
    lo = q[0::2].to(torch.int16) & 0xF
    hi = (q[1::2].to(torch.int16) & 0xF) << 4
    return (lo | hi).to(torch.uint8).view(torch.int8)


def unpack_int4(packed, k=None):
    """Inverse of :func:`pack_int4` -> [K, N] int8 (sign-extended): an
    arithmetic right shift of the int8 byte sign-extends its high nibble,
    and of the byte shifted left by 4, its low one."""
    lo = (packed << 4) >> 4
    hi = packed >> 4
    out = torch.stack([lo, hi], dim=1).reshape(-1, packed.shape[1])
    return out if k is None else out[:k]


def _block_n(n, cap=2048):
    """Largest multiple of 128 that divides n, capped — the reference's
    column-block rule, which this port keeps as its routing rule (0 =
    no kernel).  The reference's int4 cap (``_block_n_int4``) is never
    below 128, so the rule is the same for both kinds."""
    best = 0
    for m in range(128, cap + 1, 128):
        if n % m == 0:
            best = m
    return best


def _xla_fallback(x, w: QuantizedWeight):
    """The plain version: exact int -> f32 weights, f32 accumulation,
    per-column scale on the result, cast to x's dtype."""
    q = unpack_int4(w.q, w.k) if w.kind == "int4" else w.q
    out = torch.matmul(x.float(), q.float())
    return (out * w.scale.float()).to(x.dtype)


def _splits(m, rows, n, sms):
    """K splits of the f32 kernel, so that one call puts >= 2 CTAs per SM
    in flight (the k/v projections have only N/128 = 8 column blocks at
    llama3_8b), each split taking at least ``_MIN_SPLIT_ROWS`` q rows."""
    blocks = (n // _BN) * -(-m // _MT)
    want = -(-2 * sms // blocks)
    splits = max(1, min(want, rows // _MIN_SPLIT_ROWS))
    return splits, -(-rows // splits)


def _mma_splits(m, rows, n, sms):
    """(splits, rows_per_split) of the bf16 kernel: enough K splits that
    the grid holds ``_CTAS_PER_SM`` CTAs per SM (one CTA per 128 columns
    and split, whatever M is), each split a whole number of 64-row
    stages and at least ``_MIN_SPLIT_STAGES`` of them, at most
    ``_MAX_SPLIT``, and so few that the f32 partial sums (written and
    read back: 8 * M bytes per column and split) stay within half the
    weight bytes (``rows`` per column).  The constants are a sweep's
    best on the H100 (``PERF.md`` §6)."""
    blocks = n // _BN
    stages = -(-rows // _STAGE_ROWS)
    want = max(1, min(-(-_CTAS_PER_SM * sms // blocks),
                      stages // _MIN_SPLIT_STAGES, _MAX_SPLIT,
                      rows // (16 * m)))
    per = -(-stages // want) * _STAGE_ROWS
    return -(-rows // per), per


def _check(x2, w):
    q, scale = w.q, w.scale
    if q.device != x2.device or scale.device != x2.device:
        raise ValueError("weight_only_matmul: x, q and scale must be on one "
                         f"device, got {x2.device}/{q.device}/"
                         f"{scale.device}")
    if x2.dtype not in _DTYPES:
        raise TypeError("weight_only_matmul kernel takes float32 or "
                        f"bfloat16 x, got {x2.dtype}")
    if q.dtype != torch.int8 or scale.dtype != torch.float32:
        raise TypeError("weight_only_matmul kernel takes int8 q and a "
                        f"float32 scale, got {q.dtype}/{scale.dtype}")
    rows = w.k // 2 if w.kind == "int4" else w.k
    if q.dim() != 2 or q.shape[0] != rows or tuple(scale.shape) != (
            q.shape[1],):
        raise ValueError(
            f"weight_only_matmul: {w.kind} q {tuple(q.shape)} must be "
            f"[{rows}, N] and scale {tuple(scale.shape)} [N] for K={w.k}")
    if not (x2.is_contiguous() and q.is_contiguous()
            and scale.is_contiguous()):
        raise ValueError("weight_only_matmul kernel takes contiguous x, q "
                         "and scale")
    if q.data_ptr() % 16 or scale.data_ptr() % 16:
        raise ValueError("weight_only_matmul: q and scale must be 16-byte "
                         "aligned")
    return rows


def _kernel(x2, w):
    """Launch the K4 GEMV: x2 [M <= 64, K] @ w -> [M, N] in x's dtype."""
    global _launch
    rows = _check(x2, w)
    m, k = x2.shape
    n = w.q.shape[1]
    dev = x2.device
    out = torch.empty((m, n), dtype=x2.dtype, device=dev)
    if m == 0:
        return out
    stream = torch.cuda.current_stream(dev).cuda_stream
    ws = tickets = None
    if x2.dtype == torch.float32:
        splits, per_split = _splits(m, rows, n, cuda_lib.sm_count(dev))
    else:
        splits, per_split = _mma_splits(m, rows, n, cuda_lib.sm_count(dev))
        if k % 8 or x2.data_ptr() % 16:      # 16-byte rows for cp.async
            xp = torch.zeros((m, k + -k % 8), dtype=x2.dtype, device=dev)
            xp[:, :k] = x2
            x2, k = xp, xp.shape[1]
        if splits > 1:
            tickets = cuda_lib.scratch("quant_matmul.tickets", dev, stream,
                                       n // _BN, torch.int32,
                                       zeroed=True).data_ptr()
    if splits > 1:
        ws = cuda_lib.scratch("quant_matmul.partials", dev, stream,
                              splits * m * n, torch.float32).data_ptr()
    if _launch is None:
        _launch = cuda_lib.kernel("quant_matmul", "quant_matmul_fwd",
                                  _ARGTYPES)
    err = _launch(_DTYPES[x2.dtype], int(w.kind == "int4"), x2.data_ptr(),
                  w.q.data_ptr(), w.scale.data_ptr(), out.data_ptr(), ws,
                  tickets, m, k, rows, n, splits, per_split, stream)
    cuda_lib.check("quant_matmul", err, "weight_only_matmul launch")
    if w.kind == "int4":
        weight_only_matmul.int4_launches += 1
    else:
        weight_only_matmul.int8_launches += 1
    return out


def weight_only_matmul(x, w: QuantizedWeight):
    """x [..., K] @ dequant(w) -> [..., N] in x's dtype: the K4 GEMV
    kernel at decode shapes on CUDA, the dequant-matmul otherwise, the
    plain version on the CPU."""
    if w.kind not in ("int8", "int4"):
        raise ValueError(f"unsupported quant kind {w.kind!r}")
    lead = x.shape[:-1]
    k = x.shape[-1]
    if k != w.shape[0]:
        raise ValueError(f"matmul K mismatch: x has {k}, weight "
                         f"{w.shape[0]}")
    n = w.shape[1]
    x2 = x.reshape(-1, k)
    if x.device.type == "cpu":
        return _xla_fallback(x2, w).reshape(*lead, n)
    kernel_route = (_block_n(n) > 0 and x2.shape[0] <= _GEMV_MAX_ROWS
                    and (w.kind == "int8" or k % 2 == 0))
    if kernel_route:
        return _kernel(x2, w).reshape(*lead, n)
    q = unpack_int4(w.q, w.k) if w.kind == "int4" else w.q
    out = torch.matmul(x2, q.to(x2.dtype))
    weight_only_matmul.matmul_calls += 1
    return (out.float() * w.scale.float()).to(x.dtype).reshape(*lead, n)


# kernel launches by kind (the main-path witnesses) and calls of the
# dequant-matmul route on CUDA (M > 64, the reference's XLA route)
weight_only_matmul.int8_launches = 0
weight_only_matmul.int4_launches = 0
weight_only_matmul.matmul_calls = 0
