"""The tile table and tile classes of paddle_tpu_torch's bf16 K8 forward,
on the CPU.

The bf16 masked forward (``csrc/flash_sm90.cuh``) classes each (128-row
query block, 128-key tile) from a table of per-64-key-block minima and
maxima of the flashmask interval ends: skip (no key of the tile is
visible to any row it covers: neither loaded nor computed), clean (no
interval touches it: no per-element interval test) or partial.  The
plain versions (``_tile_table_xla``, ``_tile_classes``) compute what the
table kernel and ``tile_class`` compute; here they are held against the
dense mask of the JAX package's ``dense_mask_from_intervals`` over
seeded padding, document (nvec 2 and 4), sliding-window and random
intervals: every tile classed skip is all masked for the rows it
covers, every tile classed clean is all visible.  And a float32
emulation of the kernel's walk (skipped tiles left out, the interval
test only on partial tiles, the causal/Sk test only where a tile
crosses them) agrees with the JAX masked kernel in interpret mode to
1e-5 (summation order).  The CUDA table kernel is held bit for bit
against ``_tile_table_xla`` on the card (tests/test_torch_cuda_kernels.py).
"""
import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from paddle_tpu.ops.pallas import flash_attention as JFA
from paddle_tpu.ops.pallas import flash_mask as JFM
from paddle_tpu_torch.ops.pallas import flash_mask as TFM

TILE = TFM.TILE
ATOL = 1e-5


@pytest.fixture
def interpret():
    JFM._INTERPRET, saved = True, JFM._INTERPRET
    yield
    JFM._INTERPRET = saved


def _intervals(kind, seed, b, sq, sk):
    """int32 mask_vecs [B|1, 1, nvec, Sk] of one kind, from a seed."""
    rng = np.random.RandomState(seed)
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
    # over a few runs of columns, so that blocks of every class occur
    runs = rng.randint(0, sq + 1, (b, 1, 4, 6))
    cols = np.sort(rng.choice(np.arange(1, sk), 5, replace=False))
    idx = np.searchsorted(cols, np.arange(sk), side="right")
    vecs = runs[..., idx] + rng.randint(-3, 4, (b, 1, 4, sk))
    return torch.from_numpy(np.clip(vecs, 0, sq).astype(np.int32))


KINDS = ["padding", "docs2", "docs4", "window", "random"]
SHAPES = [(2, 700, 700), (1, 300, 1000), (2, 1000, 333)]   # b, sq, sk


def _dense(vecs, sq, sk):
    """The JAX package's dense mask [B|1, H|1, Sq, Sk] (True = attend);
    the port's helper must give the same."""
    dense = np.asarray(JFM.dense_mask_from_intervals(
        jnp.asarray(vecs.numpy()), sq, sk))
    np.testing.assert_array_equal(
        TFM.dense_mask_from_intervals(vecs, sq, sk).numpy(), dense)
    return dense


@pytest.mark.parametrize("kind", KINDS)
def test_tile_table_is_the_block_minmax(kind):
    b, sq, sk = 2, 500, 333
    vecs = _intervals(kind, 1, b, sq, sk)
    tbl = TFM._tile_table(vecs)                       # CPU: plain version
    nblk = -(-sk // TFM.TABLE_BLOCK)
    assert tbl.shape == (*vecs.shape[:3], nblk, 2)
    assert tbl.dtype == torch.int32
    v = vecs.numpy()
    for c in range(nblk):
        cols = v[..., c * 64:min(c * 64 + 64, sk)]
        np.testing.assert_array_equal(tbl[..., c, 0].numpy(), cols.min(-1))
        np.testing.assert_array_equal(tbl[..., c, 1].numpy(), cols.max(-1))


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("kind", KINDS)
def test_tile_classes_hold_against_the_dense_mask(kind, shape):
    b, sq, sk = shape
    vecs = _intervals(kind, sum(shape), b, sq, sk)
    cls = TFM._tile_classes(TFM._tile_table_xla(vecs, sk), sq).numpy()
    dense = _dense(vecs, sq, sk)
    assert cls.shape == (*vecs.shape[:2], -(-sq // TILE), -(-sk // TILE))
    for (bi, hi, qi, ki), c in np.ndenumerate(cls):
        tile = dense[bi, hi, qi * TILE:(qi + 1) * TILE,
                     ki * TILE:(ki + 1) * TILE]
        if c == 0:
            assert not tile.any(), (bi, hi, qi, ki)
        elif c == 2:
            assert tile.all(), (bi, hi, qi, ki)
    if kind != "random" and sq == sk:
        assert (cls == 0).any()                 # skipping happens


@pytest.mark.parametrize("kind", ["padding", "window"])
def test_tile_classes_are_exact_for_monotone_masks(kind):
    """Key padding and a causal window mask each column over one interval
    whose ends move monotonically, so the classes are exact: every tile
    that the mask hides whole is skipped, every one it leaves whole is
    clean."""
    b, sq, sk = 3, 2048, 2048
    vecs = _intervals(kind, 5, b, sq, sk)
    cls = TFM._tile_classes(TFM._tile_table_xla(vecs, sk), sq).numpy()
    dense = _dense(vecs, sq, sk)
    tiles = dense.reshape(*dense.shape[:2], sq // TILE, TILE, sk // TILE,
                          TILE)
    np.testing.assert_array_equal(cls == 0, ~tiles.any(axis=(3, 5)))
    np.testing.assert_array_equal(cls == 2, tiles.all(axis=(3, 5)))


def _tiled_forward(q, k, v, vecs, causal, scale):
    """float32 emulation of the bf16 forward's walk over [B, H, S, D]
    tensors: per 128-row query block, only the tiles not classed skip,
    the interval test only on partial tiles, the causal/Sk test only on
    tiles that cross the diagonal or Sk, online softmax."""
    b, h, sq, d = q.shape
    sk = k.shape[2]
    cls = TFM._tile_classes(TFM._tile_table_xla(vecs, sk), sq)
    dense = TFM.dense_mask_from_intervals(vecs, sq, sk)
    rows = torch.arange(sq)[:, None]
    cols = torch.arange(sk)[None]
    base = cols < sk
    if causal:
        base = base & (cols <= rows + (sk - sq))
    out = torch.zeros_like(q)
    for bi in range(b):
        for hi in range(h):
            mb, mh = min(bi, cls.shape[0] - 1), min(hi, cls.shape[1] - 1)
            for qb in range(cls.shape[2]):
                r = slice(qb * TILE, min(qb * TILE + TILE, sq))
                m = torch.full((r.stop - r.start,), -math.inf)
                l = torch.zeros(r.stop - r.start)
                acc = torch.zeros(r.stop - r.start, d)
                for kb in range(cls.shape[3]):
                    c = int(cls[mb, mh, qb, kb])
                    if c == 0:
                        continue
                    kc = slice(kb * TILE, min(kb * TILE + TILE, sk))
                    s = q[bi, hi, r] @ k[bi, hi, kc].T * scale
                    ok = base[r, kc]
                    if not bool(ok.all()):
                        s = s.masked_fill(~ok, -math.inf)
                    if c == 1:
                        s = s.masked_fill(~dense[mb, mh, r, kc], -math.inf)
                    m_new = torch.maximum(m, s.amax(-1))
                    safe = torch.where(torch.isfinite(m_new), m_new, 0.0)
                    alpha = torch.where(torch.isfinite(m_new),
                                        torch.exp(m - safe), 1.0)
                    p = torch.exp(s - safe[:, None])
                    l = l * alpha + p.sum(-1)
                    acc = acc * alpha[:, None] + p @ v[bi, hi, kc]
                    m = m_new
                out[bi, hi, r] = torch.where(
                    (l > 0)[:, None], acc / torch.clamp(l, min=1e-30)[:, None],
                    0.0)
    return out


@pytest.mark.parametrize("kind,causal", [("padding", True), ("docs2", True),
                                         ("docs4", False), ("window", True),
                                         ("random", True)])
def test_skipping_tiles_keeps_the_reference_output(interpret, kind, causal):
    """The tile walk with its skips gives the JAX masked kernel's output."""
    b, s, h, d = 1, 400, 2, 64
    rng = np.random.RandomState(len(kind))
    q, k, v = (rng.randn(b, s, h, d).astype(np.float32) * 0.5
               for _ in range(3))
    vecs = _intervals(kind, 9, b, s, s)
    j_out = np.asarray(JFA._pallas_sdpa_masked(
        *(jnp.asarray(x) for x in (q, k, v)), jnp.asarray(vecs.numpy()),
        causal))
    tq, tk, tv = (torch.from_numpy(x).transpose(1, 2) for x in (q, k, v))
    t_out = _tiled_forward(tq, tk, tv, vecs, causal, 1.0 / math.sqrt(d))
    np.testing.assert_allclose(t_out.transpose(1, 2).numpy(), j_out,
                               atol=ATOL, rtol=0)
