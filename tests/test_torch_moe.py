"""paddle_tpu_torch's MoE dispatch (``distributed/moe``) against the JAX
package's ``paddle_tpu.distributed.moe``, on the CPU, from seeded numpy
inputs in float32.

Covered: the gating utilities, ``top_k_gating``, ``_topk_choices`` on
exactly tied logits (lower index first, as ``lax.top_k``), the
counting-sort dispatch at a capacity that drops entries (forward and
the hand-written gather gradients), and the reference's errors.  The
grouped dispatch on K9 and the three modes of ``moe_dispatch_combine``
are in ``test_torch_moe_grouped.py`` and ``test_torch_moe_modes.py``.

Tolerances: integer outputs exact; float32 values 1e-5 relative + 1e-5
absolute (f32 sums in another order: a gradient entry sums O(S) terms
of O(1) that can cancel; routing is identical, the logits
are far from ties except where a test makes them tie exactly).
"""
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp

from paddle_tpu.distributed import moe as JM
from paddle_tpu_torch.distributed import moe as TM

TOL = dict(rtol=1e-5, atol=1e-5)


def _np(t):
    if isinstance(t, torch.Tensor):
        return t.detach().numpy()
    return np.asarray(t)


def test_gating_utilities_match():
    rng = np.random.default_rng(0)
    idx = rng.integers(-1, 6, (40,)).astype(np.int64)
    cnt_j = JM.number_count(jnp.asarray(idx), 6)
    cnt_t = TM.number_count(torch.from_numpy(idx), 6)
    np.testing.assert_array_equal(_np(cnt_t), _np(cnt_j))
    np.testing.assert_array_equal(
        _np(TM.limit_by_capacity(cnt_t, 3, n_worker=2)),
        _np(JM.limit_by_capacity(cnt_j, 3, n_worker=2)))
    np.testing.assert_array_equal(
        _np(TM.prune_gate_by_capacity(torch.from_numpy(idx), cnt_t, 4)),
        _np(JM.prune_gate_by_capacity(jnp.asarray(idx), cnt_j, 4)))


@pytest.mark.parametrize("capacity", [None, 3])
def test_top_k_gating_matches(capacity):
    logits = np.random.default_rng(1).standard_normal((24, 4)).astype(
        np.float32)
    cj, dj, aj = JM.top_k_gating(jnp.asarray(logits), top_k=2,
                                 capacity=capacity)
    ct, dt, at = TM.top_k_gating(torch.from_numpy(logits), top_k=2,
                                 capacity=capacity)
    np.testing.assert_allclose(_np(ct), _np(cj), **TOL)
    np.testing.assert_array_equal(_np(dt), _np(dj))
    np.testing.assert_allclose(float(at), float(aj), **TOL)


def test_topk_ties_go_to_the_lower_index():
    logits = np.array([[1.0, 1.0, 1.0, 1.0], [0.0, 2.0, 2.0, 1.0],
                       [3.0, -1.0, 3.0, 3.0], [0.5, 0.5, 0.2, 0.5]],
                      np.float32)
    ij, gj, aj = JM._topk_choices(jnp.asarray(logits), 2, False, None)
    it, gt, at = TM._topk_choices(torch.from_numpy(logits), 2, False, None)
    np.testing.assert_array_equal(_np(it), _np(ij))
    np.testing.assert_array_equal(_np(it), [[0, 1], [1, 2], [0, 2], [0, 1]])
    np.testing.assert_allclose(_np(gt), _np(gj), **TOL)
    np.testing.assert_allclose(float(at), float(aj), **TOL)


def _ffn_pair(rng, e, m):
    w = rng.standard_normal((e, m, m)).astype(np.float32) * 0.2

    def jffn(t):
        return jnp.tanh(jnp.einsum("ecm,emn->ecn", t, jnp.asarray(w)))

    def tffn(t):
        return torch.tanh(torch.einsum("ecm,emn->ecn", t,
                                       torch.from_numpy(w)))
    return jffn, tffn


def test_sort_dispatch_drops_past_capacity():
    """Capacity 6 for 32 tokens x top-2 over 4 experts: most second
    choices (and some first) are dropped.  Forward and the gradients
    w.r.t. x and the gate values."""
    rng = np.random.default_rng(2)
    s, m, e, k, cap = 32, 16, 4, 2, 6
    x = rng.standard_normal((s, m)).astype(np.float32)
    logits = rng.standard_normal((s, e)).astype(np.float32)
    ct = rng.standard_normal((s, m)).astype(np.float32)
    jffn, tffn = _ffn_pair(rng, e, m)
    idx_j, gv_j, _ = JM._topk_choices(jnp.asarray(logits), k, False, None)
    idx = torch.from_numpy(np.asarray(idx_j).astype(np.int64))

    def jloss(x, gv):
        y = JM.sort_dispatch_combine(x, idx_j, gv, e, cap, jffn)
        return jnp.sum(y * ct), y

    (_, yj), gj = jax.jit(jax.value_and_grad(jloss, argnums=(0, 1),
                                             has_aux=True))(
        jnp.asarray(x), gv_j)
    xt = torch.from_numpy(x).requires_grad_()
    gvt = torch.from_numpy(np.array(gv_j)).requires_grad_()
    yt = TM.sort_dispatch_combine(xt, idx, gvt, e, cap, tffn)
    gt = torch.autograd.grad((yt * torch.from_numpy(ct)).sum(), (xt, gvt))
    _, _, _, _, pos, _ = TM._count_rank(idx, gvt, e, xt.dtype)
    assert int((pos >= cap).sum()) > 10          # the run drops entries
    np.testing.assert_allclose(_np(yt), _np(yj), **TOL)
    for g, w in zip(gt, gj):
        np.testing.assert_allclose(_np(g), _np(w), **TOL)


def test_reference_errors():
    x = torch.zeros(8, 4)
    args = (x, torch.zeros(4, 2), torch.zeros(2, 4, 8), torch.zeros(2, 8),
            torch.zeros(2, 8, 4), torch.zeros(2, 4))
    with pytest.raises(NotImplementedError, match="silu"):
        TM.moe_dispatch_combine(*args, dispatch_mode="grouped")
    with pytest.raises(ValueError, match="dispatch_mode"):
        TM.moe_dispatch_combine(*args, dispatch_mode="ring")
    with pytest.raises(NotImplementedError, match="single-device"):
        TM.moe_dispatch_combine(*args, activation=F.silu,
                                dispatch_mode="grouped",
                                mesh={"dp": 1, "ep": 1})
    # a mesh of more than one rank is a ProcessMesh of processes
    # (test_torch_moe_ep.py runs it); a mapping serves one device
    with pytest.raises(ValueError, match="ProcessMesh"):
        TM.moe_dispatch_combine(*args, mesh={"dp": 1, "ep": 2})
