"""paddle_tpu_torch's ``distributed.moe.moe_dispatch_combine`` against
the JAX package's, in all three dispatch modes ("sort", "grouped",
"dense"; silu, and jax.nn.gelu's tanh form), on the CPU from seeded
numpy inputs in float32: the output, the aux loss and the grads w.r.t.
x, gate_w, w1, b1, w2 and b2 against ``jax.grad``.

Tolerance: float32 1e-5 relative + 1e-5 absolute (f32 sums in another
order; a gradient entry sums O(S) terms that can cancel; the seeded
logits are far from ties, so routing is identical).
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


@pytest.mark.parametrize("mode,act", [("sort", "silu"), ("sort", "gelu"),
                                      ("grouped", "silu"), ("dense", "silu"),
                                      ("dense", "gelu")])
def test_moe_dispatch_combine_matches_jax_grad(mode, act):
    rng = np.random.default_rng(4)
    s, m, f, e = 48, 32, 40, 4
    arrs = [rng.standard_normal(sh).astype(np.float32) * sc
            for sh, sc in (((s, m), 1.0), ((m, e), 1.0), ((e, m, f), 0.2),
                           ((e, f), 0.1), ((e, f, m), 0.2), ((e, m), 0.1))]
    ct = rng.standard_normal((s, m)).astype(np.float32)
    jact = {"silu": jax.nn.silu, "gelu": jax.nn.gelu}[act]
    tact = {"silu": F.silu, "gelu": TM.gelu}[act]
    kw = dict(top_k=2, capacity_factor=1.0)

    def jloss(*p):
        y, aux = JM.moe_dispatch_combine(*p, activation=jact,
                                         dispatch_mode=mode, **kw)
        return jnp.sum(y * ct) + aux, (y, aux)

    (_, (yj, auxj)), gj = jax.jit(jax.value_and_grad(
        jloss, argnums=tuple(range(6)), has_aux=True))(
            *map(jnp.asarray, arrs))
    leaves = [torch.from_numpy(a).requires_grad_() for a in arrs]
    yt, auxt = TM.moe_dispatch_combine(*leaves, activation=tact,
                                       dispatch_mode=mode, **kw)
    gt = torch.autograd.grad((yt * torch.from_numpy(ct)).sum() + auxt,
                             leaves)
    assert auxt.dtype == torch.float32
    np.testing.assert_allclose(_np(yt), _np(yj), **TOL)
    np.testing.assert_allclose(float(auxt.detach()), float(auxj), **TOL)
    for name, g, w in zip(("x", "gate_w", "w1", "b1", "w2", "b2"), gt, gj):
        np.testing.assert_allclose(_np(g), _np(w), err_msg=name, **TOL)
