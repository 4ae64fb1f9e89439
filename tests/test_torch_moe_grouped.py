"""paddle_tpu_torch's dropless grouped MoE dispatch
(``distributed.moe.grouped_dispatch_ffn``) against the JAX package's, on
the CPU, from seeded numpy inputs in float32, with ``use_kernel=True``
on the JAX side: the reference's K9 in Pallas interpret mode.  The port
runs with ``use_kernel=True`` (its K9 wrapper's plain versions on CPU
tensors) and ``None`` (the plain ``grouped_ffn_xla`` under autograd).

Tolerance: float32 1e-5 relative + 1e-5 absolute (f32 sums in another
order; a gradient entry sums O(S) terms that can cancel).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from paddle_tpu.distributed import moe as JM
from paddle_tpu.ops.pallas import grouped_ffn as G
from paddle_tpu_torch.distributed import moe as TM

TOL = dict(rtol=1e-5, atol=1e-5)


def _np(t):
    if isinstance(t, torch.Tensor):
        return t.detach().numpy()
    return np.asarray(t)


@pytest.mark.parametrize("routing,k", [("spread", 2), ("two_experts", 2),
                                       ("one_expert", 1)])
def test_grouped_dispatch_matches_interpret_kernel(routing, k):
    """use_kernel=True on both sides: the reference's K9 in interpret
    mode, the port's plain K9 versions.  "two_experts" sends every
    token's choices to experts 1 and 2, "one_expert" (top-1) every token
    to expert 1."""
    rng = np.random.default_rng(3)
    s, m, f, e = 40, 32, 48, 4
    x = rng.standard_normal((s, m)).astype(np.float32)
    logits = rng.standard_normal((s, e)).astype(np.float32)
    if routing == "two_experts":
        logits[:, 1:3] += 20.0
    elif routing == "one_expert":
        logits[:, 1] += 20.0
    w = [rng.standard_normal(sh).astype(np.float32) * 0.2
         for sh in ((e, m, f), (e, f), (e, f, m), (e, m))]
    ct = rng.standard_normal((s, m)).astype(np.float32)
    idx_j, gv_j, _ = JM._topk_choices(jnp.asarray(logits), k, False, None)
    idx = torch.from_numpy(np.asarray(idx_j).astype(np.int64))
    G._INTERPRET = True
    try:
        def jloss(x, gv, *ws):
            y = JM.grouped_dispatch_ffn(x, idx_j, gv, e, *ws,
                                        use_kernel=True)
            return jnp.sum(y * ct), y

        (_, yj), gj = jax.jit(jax.value_and_grad(
            jloss, argnums=tuple(range(6)), has_aux=True))(
                jnp.asarray(x), gv_j, *map(jnp.asarray, w))
    finally:
        G._INTERPRET = False
    for use_kernel in (True, None):
        leaves = [torch.from_numpy(a).requires_grad_()
                  for a in (x, np.array(gv_j), *w)]
        yt = TM.grouped_dispatch_ffn(leaves[0], idx, leaves[1], e,
                                     *leaves[2:], use_kernel=use_kernel)
        gt = torch.autograd.grad((yt * torch.from_numpy(ct)).sum(), leaves)
        np.testing.assert_allclose(_np(yt), _np(yj), **TOL)
        for g, wj in zip(gt, gj):
            np.testing.assert_allclose(_np(g), _np(wj), **TOL)
