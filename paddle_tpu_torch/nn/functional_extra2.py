"""``flashmask_attention``, Paddle's FlashMask API, on torch tensors.

Ports ``flashmask_attention`` from ``paddle_tpu/nn/functional_extra2.py``
(``:347-441``), the entry that packed SFT and DPO training use.  The
start/end row indices per key column (``startend_row_indices`` [B, H|1,
Sk, 1|2|4]) become flashmask intervals ``mask_vecs`` [B, H|1, nvec, Sk]
for ``sdpa``, which runs the masked flash attention (the K8 kernels on
the card, differentiable).  A causal ``window_size`` adds the sliding
window's interval.  Dropout goes to ``sdpa``, whose dropout route draws
from the explicit ``generator``.
"""
from __future__ import annotations

import torch

from ..ops.pallas import flash_attention as _fa

__all__ = ["flashmask_attention"]


def flashmask_attention(query, key, value, startend_row_indices=None, *,
                        dropout=0.0, causal=False, window_size=None,
                        return_softmax_lse=False, return_seed_offset=False,
                        fixed_seed_offset=None, rng_name="", training=True,
                        name=None, generator=None):
    """FlashMask attention: [B, Sq, H, D] query, [B, Sk, kvH, D] key and
    value.  For key column j, ``startend_row_indices[..., j, :]`` gives
    the masked query rows: causal with 1 index, rows >= LTS; causal with
    2, rows in [LTS, LTE); non-causal with 2, rows >= LTS or < UTE;
    non-causal with 4, rows in [LTS, LTE) or [UTS, UTE).  ``window_size``
    (an int or (left, right), causal only) also masks rows > j + left.
    ``fixed_seed_offset``, ``rng_name`` and ``name`` are accepted and
    ignored, as in the reference; ``generator`` seeds the dropout."""
    if return_softmax_lse or return_seed_offset:
        raise NotImplementedError("lse/seed outputs not supported")
    sq, sk = query.shape[1], key.shape[1]
    if startend_row_indices is None:
        return _fa.sdpa(query, key, value, dropout_p=dropout,
                        is_causal=causal, training=training,
                        generator=generator)
    idx = startend_row_indices                 # [B, H|1, Sk, k]
    kdim = idx.shape[-1]
    moved = idx.movedim(-1, 2)                 # [B, H|1, k, Sk]
    vecs = None
    if causal and kdim == 1:
        lts = moved[:, :, 0]
        vecs = torch.stack([lts, torch.full_like(lts, sq)], dim=2)
    elif causal and kdim == 2:
        vecs = moved
    elif not causal and kdim == 2:
        lts, ute = moved[:, :, 0], moved[:, :, 1]
        vecs = torch.stack([lts, torch.full_like(lts, sq),
                            torch.zeros_like(lts), ute], dim=2)
    elif not causal and kdim == 4:
        vecs = moved
    if vecs is not None and window_size is not None and causal:
        # causal sliding window: column j masked for rows > j + left
        left = window_size if isinstance(window_size, int) else \
            window_size[0]
        col = torch.arange(sk, dtype=vecs.dtype, device=vecs.device)
        col = col.expand(*vecs.shape[:2], sk)
        vecs = torch.cat([vecs, torch.stack(
            [col + left + 1, torch.full_like(col, sq)], dim=2)], dim=2)
    if window_size is not None and not causal:
        raise NotImplementedError(
            "flashmask_attention window_size requires causal=True "
            "(the reference's sliding windows are causal)")
    if vecs is None:
        raise ValueError("causal flashmask expects 1 or 2 indices" if causal
                         else "non-causal flashmask expects 2 or 4 indices")
    return _fa.sdpa(query, key, value, dropout_p=dropout, is_causal=causal,
                    training=training, generator=generator,
                    flashmask=vecs.to(torch.int32).contiguous())
