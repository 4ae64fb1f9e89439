"""paddle_tpu_torch paged attention (K3 port) against the JAX package.

The same numpy inputs (from a seed) go through the JAX Pallas kernel in
interpret mode, the JAX dense-gather reference ``paged_attention_xla``
and the port's ``paged_attention`` (on CPU tensors: its plain version).
float32 throughout; tolerance 1e-5 absolute — the paths differ only in
summation order and in online vs. one-pass softmax.  The cases cover the
head dims the port's kernel is built for (32, 64, 128, 256), GQA groups
of 1 to 32 and pages of 8, 16 and 24 tokens.  The CUDA kernel is held
against the same plain version on the card (chip_smoke.py and
tests/test_torch_cuda_kernels.py).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from paddle_tpu.ops.pallas import paged_attention as JPA
from paddle_tpu_torch.ops.pallas import paged_attention as TPA

ATOL = 1e-5
HEAD_DIMS = (32, 64, 128, 256)     # the port kernel's instances
GROUPS = (1, 4, 8, 32)
PAGES = (8, 16, 24)


def _case(rep, ps, seed, d=64):
    """B=4 sequences whose lens cover 1 token, exactly one page, a
    ragged middle and the full table; unused table slots point at the
    dump page (the last pool row)."""
    rng = np.random.RandomState(seed)
    kvh, w = 2, 4
    nh = kvh * rep
    lens = np.array([1, ps, 2 * ps + 3, w * ps], np.int32)
    n_pool = 4 * w + 1
    dump = n_pool - 1
    perm = rng.permutation(4 * w).reshape(4, w).astype(np.int32)
    need = -(-lens // ps)
    table = np.where(np.arange(w)[None] < need[:, None], perm,
                     dump).astype(np.int32)
    q = rng.randn(4, nh, d).astype(np.float32)
    kpool = rng.randn(n_pool, kvh, ps, d).astype(np.float32)
    vpool = rng.randn(n_pool, kvh, ps, d).astype(np.float32)
    return q, kpool, vpool, table, lens


@pytest.fixture
def interpret():
    JPA._INTERPRET, saved = True, JPA._INTERPRET
    yield
    JPA._INTERPRET = saved


@pytest.mark.parametrize("ps", PAGES)
@pytest.mark.parametrize("rep", GROUPS)
@pytest.mark.parametrize("d", HEAD_DIMS)
def test_matches_jax_kernel_and_reference(interpret, d, rep, ps):
    args = _case(rep, ps, seed=rep * 100 + ps + d, d=d)
    jargs = [jnp.asarray(a) for a in args]
    j_kernel = np.asarray(JPA.paged_attention(*jargs))
    j_xla = np.asarray(JPA.paged_attention_xla(*jargs))
    targs = [torch.from_numpy(a) for a in args]
    before = TPA.paged_attention.launches
    t_out = TPA.paged_attention(*targs).numpy()
    t_xla = TPA.paged_attention_xla(*targs).numpy()
    assert TPA.paged_attention.launches == before   # CPU: plain version
    np.testing.assert_allclose(t_out, j_kernel, atol=ATOL, rtol=0)
    np.testing.assert_allclose(t_out, j_xla, atol=ATOL, rtol=0)
    np.testing.assert_array_equal(t_out, t_xla)


def test_gather_kv_pages_matches_jax():
    q, kpool, _, table, _ = _case(2, 8, seed=3)
    j = np.asarray(JPA.gather_kv_pages(jnp.asarray(kpool),
                                       jnp.asarray(table)))
    t = TPA.gather_kv_pages(torch.from_numpy(kpool),
                            torch.from_numpy(table)).numpy()
    np.testing.assert_array_equal(t, j)


def test_paged_pool_matches_jax():
    for lengths, new, ps, width in (([100, 300, 50], 28, 128, 0),
                                    ([10], 5, 128, 4), ([7, 9], 3, 8, 0)):
        j = JPA.PagedPool(lengths, new, page_size=ps, min_table_width=width)
        t = TPA.PagedPool(lengths, new, page_size=ps, min_table_width=width)
        assert (t.dump_page, t.num_pages, t.max_pages) == \
            (j.dump_page, j.num_pages, j.max_pages)
        np.testing.assert_array_equal(t.table, j.table)
        np.testing.assert_array_equal(t.reserved, j.reserved)


def test_select_paged_attention():
    """The head-parallel variant (a tp group as ``tp_axis``) runs the
    same body on a rank's local heads, as the reference's does inside
    its ``shard_map``, and refuses local heads that do not group."""
    assert TPA.select_paged_attention() is TPA.paged_attention
    rng = np.random.default_rng(3)
    q = torch.from_numpy(rng.standard_normal((2, 4, 8)).astype(np.float32))
    kp = torch.from_numpy(rng.standard_normal((5, 2, 4, 8)).astype(
        np.float32))
    vp = torch.from_numpy(rng.standard_normal((5, 2, 4, 8)).astype(
        np.float32))
    table = torch.tensor([[0, 1, 4], [2, 3, 4]], dtype=torch.int32)
    lens = torch.tensor([7, 5], dtype=torch.int32)
    got = TPA.select_paged_attention("tp")(q, kp, vp, table, lens)
    want = JPA.select_paged_attention(tp_axis="tp")(
        *(jnp.asarray(x.numpy()) for x in (q, kp, vp, table, lens)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    with pytest.raises(ValueError, match="group onto local KV heads"):
        TPA.select_paged_attention("tp")(q[:, :3], kp, vp, table, lens)
    with pytest.raises(ValueError, match="group onto local KV heads"):
        TPA.paged_attention_quant(q[:, :3], kp.to(torch.int8),
                                  vp.to(torch.int8), kp[..., 0], vp[..., 0],
                                  table, lens, tp_axis="tp")
