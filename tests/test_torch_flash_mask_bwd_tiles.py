"""The tile classes of paddle_tpu_torch's bf16 K8 backward, on the CPU.

The bf16 dq and dk/dv kernels (``csrc/flash_sm90.cuh``) skip the tiles
that the flashmask intervals hide whole, from the same table of
per-64-key-block minima and maxima of the interval ends as the forward:
dq walks 128-row query blocks over 64-key tiles (``DQ_TILE``), dk/dv
64-row query tiles over each consumer warpgroup's 64-key block
(``DKV_TILE``), both through ``tile_class``, whose plain version is
``_tile_classes(table, sq, rows, keys)``.  Here the classes of both walks
are held against the dense mask of the JAX package's
``dense_mask_from_intervals`` over seeded padding, document (nvec 2 and
4), sliding-window and random intervals, and per-q-head intervals [B,
H, nvec, Sk]: every tile classed skip is all masked for the rows it
covers, every tile classed clean is all visible.  And a float32
emulation of each walk (skipped tiles left out, the interval test only
on partial tiles, the causal/Sk test only where a tile crosses them,
dk/dv of a GQA group summed over its q heads, each head's tiles classed
by its own intervals) gives the JAX ``_masked_bwd``'s dq, dk and dv in
interpret mode to 1e-5 (summation order), on the JAX forward's out and
lse.  The CUDA kernels are held against the plain versions on the card
(tests/test_torch_cuda_kernels.py).
"""
import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from paddle_tpu.ops.pallas import flash_mask as JFM
from paddle_tpu_torch.ops.pallas import flash_mask as TFM

ATOL = 1e-5
WALKS = {"dq": TFM.DQ_TILE, "dkv": TFM.DKV_TILE}


def _intervals(kind, seed, b, h, sq, sk):
    """int32 mask_vecs [B|1, 1|H, nvec, Sk] of one kind, from a seed;
    ``per_head_*`` draws one row set per q head."""
    rng = np.random.RandomState(seed)
    if kind.startswith("per_head_"):
        return torch.cat([_intervals(kind[9:], seed + i, b, 1, sq, sk)
                          for i in range(h)], dim=1)
    if kind == "padding":
        real = rng.randint(1, sk + 1, b)
        real[0] = sk
        keep = np.arange(sk)[None] < real[:, None]
        return TFM.padding_mask_to_intervals(torch.from_numpy(keep), sq)
    if kind in ("docs2", "docs4"):
        cuts = np.sort(rng.choice(np.arange(1, sk), 4, replace=False))
        seg = np.searchsorted(cuts, np.arange(sk), side="right")
        seg = torch.from_numpy(np.broadcast_to(seg, (b, sk)).copy())
        return TFM.segment_intervals(seg, causal=kind == "docs2")
    if kind == "window":
        return TFM.sliding_window_intervals(sk, int(rng.randint(60, 300)), b,
                                            device="cpu")
    # random: ends drawn independently per column (some intervals empty)
    # over a few runs of columns, so that tiles of every class occur
    runs = rng.randint(0, sq + 1, (b, 1, 4, 6))
    cols = np.sort(rng.choice(np.arange(1, sk), 5, replace=False))
    idx = np.searchsorted(cols, np.arange(sk), side="right")
    vecs = runs[..., idx] + rng.randint(-3, 4, (b, 1, 4, sk))
    return torch.from_numpy(np.clip(vecs, 0, sq).astype(np.int32))


KINDS = ["padding", "docs2", "docs4", "window", "random", "per_head_random",
         "per_head_window"]
SHAPES = [(2, 700, 700), (1, 300, 1000), (2, 1000, 333)]   # b, sq, sk


@pytest.mark.parametrize("walk", sorted(WALKS))
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("kind", KINDS)
def test_backward_tile_classes_hold_against_the_dense_mask(kind, shape,
                                                           walk):
    b, sq, sk = shape
    rows, keys = WALKS[walk]
    vecs = _intervals(kind, sum(shape), b, 4, sq, sk)
    cls = TFM._tile_classes(TFM._tile_table_xla(vecs, sk), sq, rows,
                            keys).numpy()
    dense = np.asarray(JFM.dense_mask_from_intervals(
        jnp.asarray(vecs.numpy()), sq, sk))
    assert cls.shape == (*vecs.shape[:2], -(-sq // rows), -(-sk // keys))
    for (bi, hi, qi, ki), c in np.ndenumerate(cls):
        tile = dense[bi, hi, qi * rows:(qi + 1) * rows,
                     ki * keys:(ki + 1) * keys]
        if c == 0:
            assert not tile.any(), (bi, hi, qi, ki)
        elif c == 2:
            assert tile.all(), (bi, hi, qi, ki)
    if kind in ("padding", "window") and sq == sk:
        assert (cls == 0).any() and (cls == 2).any()


def _walk_setup(q, k, vecs, causal, walk):
    """(classes [Bm, Hm, query tiles, key tiles] or None, dense interval
    mask or None, the causal/Sk mask [Sq, Sk]) for one walk."""
    sq, sk = q.shape[2], k.shape[2]
    cls = dense = None
    if vecs is not None:
        cls = TFM._tile_classes(TFM._tile_table_xla(vecs, sk), sq,
                                *WALKS[walk])
        dense = TFM.dense_mask_from_intervals(vecs, sq, sk)
    base = torch.ones(sq, sk, dtype=torch.bool)
    if causal:
        base = base.tril(sk - sq)
    return cls, dense, base


def _tile_ds(q, k, v, do, lse, delta, bias, dense, base, c, bi, hi, r, kc,
             scale):
    """(p, ds) of one tile of (batch bi, q head hi): rows r, keys kc; the
    causal/Sk test where the tile crosses them, the interval test on a
    partial tile (c == 1)."""
    hk = hi // (q.shape[1] // k.shape[1])
    s = q[bi, hi, r] @ k[bi, hk, kc].T * scale
    if bias is not None:
        s = s + bias[min(bi, bias.shape[0] - 1), min(hi, bias.shape[1] - 1),
                     r, kc]
    p = torch.exp(s - lse[bi, hi, r, None])
    ok = base[r, kc]
    if not bool(ok.all()):
        p = torch.where(ok, p, 0.0)
    if c == 1:
        p = torch.where(dense[min(bi, dense.shape[0] - 1),
                              min(hi, dense.shape[1] - 1), r, kc], p, 0.0)
    dp = do[bi, hi, r] @ v[bi, hk, kc].T
    return p, p * (dp - delta[bi, hi, r, None]) * scale


def _cls(cls, bi, hi, qb, kb):
    if cls is None:
        return 2
    return int(cls[min(bi, cls.shape[0] - 1), min(hi, cls.shape[1] - 1), qb,
                   kb])


def _dq_walk(q, k, v, do, lse, delta, vecs, bias, causal, scale):
    """float32 emulation of the bf16 dq kernel's walk over [B, H, S, D]
    tensors: per 128-row query block, the 64-key tiles up to the causal
    bound that are not classed skip."""
    b, h, sq, _ = q.shape
    sk = k.shape[2]
    rows, keys = TFM.DQ_TILE
    cls, dense, base = _walk_setup(q, k, vecs, causal, "dq")
    dq = torch.zeros_like(q)
    for bi in range(b):
        for hi in range(h):
            hk = hi // (h // k.shape[1])
            for qb in range(-(-sq // rows)):
                r = slice(qb * rows, min(qb * rows + rows, sq))
                for kb in range(-(-sk // keys)):
                    if causal and kb * keys > r.stop - 1 + sk - sq:
                        break
                    c = _cls(cls, bi, hi, qb, kb)
                    if c == 0:
                        continue
                    kc = slice(kb * keys, min(kb * keys + keys, sk))
                    _, ds = _tile_ds(q, k, v, do, lse, delta, bias, dense,
                                     base, c, bi, hi, r, kc, scale)
                    dq[bi, hi, r] += ds @ k[bi, hk, kc]
    return dq


def _dkv_walk(q, k, v, do, lse, delta, vecs, bias, causal, scale):
    """float32 emulation of the bf16 dk/dv kernel's walk: per 128-key
    block and GQA group, each q head's 64-row query tiles from the causal
    lower bound, each 64-key half of the block skipping the tiles its own
    class (by that q head's intervals) or the causal diagonal hides; the
    group's sums taken in f32 in head order."""
    b, h, sq, _ = q.shape
    kvh, sk = k.shape[1], k.shape[2]
    grp = h // kvh
    rows, keys = TFM.DKV_TILE
    nq = -(-sq // rows)
    cls, dense, base = _walk_setup(q, k, vecs, causal, "dkv")
    dk, dv = torch.zeros_like(k), torch.zeros_like(v)
    for bi in range(b):
        for hk in range(kvh):
            for k0 in range(0, sk, 2 * keys):
                x = k0 - (sk - sq)
                lower = 0 if not causal or x <= 0 else min(x // rows, nq)
                for hi in range(hk * grp, hk * grp + grp):
                    for qb in range(lower, nq):
                        r = slice(qb * rows, min(qb * rows + rows, sq))
                        for kb in range(k0 // keys, min(k0 // keys + 2,
                                                        -(-sk // keys))):
                            if causal and qb * rows + rows - 1 + sk - sq \
                                    < kb * keys:
                                continue
                            c = _cls(cls, bi, hi, qb, kb)
                            if c == 0:
                                continue
                            kc = slice(kb * keys, min(kb * keys + keys, sk))
                            p, ds = _tile_ds(q, k, v, do, lse, delta, bias,
                                             dense, base, c, bi, hi, r, kc,
                                             scale)
                            dv[bi, hk, kc] += p.T @ do[bi, hi, r]
                            dk[bi, hk, kc] += ds.T @ q[bi, hi, r]
    return dk, dv


BWD_CASES = [  # kind, causal, h, kvh, bias
    ("padding", True, 2, 2, False),
    ("docs4", False, 2, 2, False),
    ("window", True, 2, 1, False),
    ("random", True, 2, 2, False),
    ("per_head_random", True, 4, 2, False),
    ("docs2", True, 2, 2, True),
]


@pytest.mark.parametrize("kind,causal,h,kvh,with_bias", BWD_CASES)
def test_skipping_tiles_keeps_the_reference_gradients(kind, causal, h, kvh,
                                                      with_bias):
    """Both backward walks with their skips give the JAX masked
    backward's dq, dk and dv (interpret mode), on the JAX forward's out
    and lse; per-q-head intervals under GQA class each head's tiles by
    its own intervals."""
    b, s, d = 1, 384, 64
    rng = np.random.RandomState(len(kind) + h)
    q = (rng.randn(b, h, s, d) * 0.5).astype(np.float32)
    k, v = ((rng.randn(b, kvh, s, d) * 0.5).astype(np.float32)
            for _ in range(2))
    g = rng.randn(b, h, s, d).astype(np.float32)
    bias = (rng.randn(1, h, s, s) * 0.5).astype(np.float32) if with_bias \
        else None
    vecs = _intervals(kind, 9, b, h, s, s)
    scale = 1.0 / math.sqrt(d)
    jargs = [jnp.asarray(x) for x in (q, k, v)]
    jvecs = jnp.asarray(vecs.numpy())
    jbias = None if bias is None else jnp.asarray(bias)
    out, lse = JFM._masked_fwd(*jargs, jvecs, jbias, causal, scale, s, s, s,
                               s, interpret=True)
    lse = lse[..., 0]
    jdq, jdk, jdv, _ = JFM._masked_bwd(*jargs, out, lse, jnp.asarray(g),
                                       jvecs, jbias, causal, scale, s, s, s, s,
                                       need_dbias=False, interpret=True)
    tq, tk, tv, tg = (torch.from_numpy(x) for x in (q, k, v, g))
    tout = torch.from_numpy(np.array(out))
    tlse = torch.from_numpy(np.array(lse))
    tbias = None if bias is None else torch.from_numpy(bias)
    delta = (tout * tg).sum(-1)
    args = (tq, tk, tv, tg, tlse, delta, vecs, tbias, causal, scale)
    np.testing.assert_allclose(_dq_walk(*args).numpy(), np.asarray(jdq),
                               atol=ATOL, rtol=0)
    dk, dv = _dkv_walk(*args)
    np.testing.assert_allclose(dk.numpy(), np.asarray(jdk), atol=ATOL, rtol=0)
    np.testing.assert_allclose(dv.numpy(), np.asarray(jdv), atol=ATOL, rtol=0)
