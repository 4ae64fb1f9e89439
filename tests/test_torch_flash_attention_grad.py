"""paddle_tpu_torch flash attention backward (K2 port) through its
autograd Function, against the JAX package's ``custom_vjp``.

The same numpy inputs and cotangent (from a seed) go through the JAX
``_pallas_sdpa`` in Pallas interpret mode (K1 forward + K2 dq and dk/dv
kernels, dk/dv summed per GQA group) under ``jax.vjp``, and through the
port's ``_pallas_sdpa`` on CPU tensors under ``torch.autograd`` (the
plain versions ``_flash_fwd_xla`` / ``_flash_bwd_xla`` inside
``flash_mha``'s autograd Function).  Compared: dq, dk, dv.  float32;
tolerance 1e-5 absolute plus 1e-5 relative — summation order only
(measured gaps <= 2.4e-6 on gradients up to ~20).  Rows with no visible
key (sq > sk, causal) must get a zero dq in both.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from paddle_tpu.ops.pallas import flash_attention as JFA
from paddle_tpu_torch.ops.pallas import flash_attention as TFA

TOL = 1e-5

# (sq, sk, causal, kv heads, D) at H = 4: GQA dk/dv at hk 2 and 1
CASES = [(256, 256, True, 4, 64), (200, 200, False, 4, 64),
         (150, 300, True, 2, 64), (300, 150, True, 2, 64),
         (192, 160, True, 1, 128)]
IDS = [f"sq{c[0]}-sk{c[1]}-{'causal' if c[2] else 'full'}-hk{c[3]}-d{c[4]}"
       for c in CASES]


@pytest.fixture
def interpret():
    JFA._INTERPRET, saved = True, JFA._INTERPRET
    yield
    JFA._INTERPRET = saved


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_grads_match_jax_kernels(interpret, case):
    sq, sk, causal, hk, d = case
    rng = np.random.default_rng(sq * sk + hk)
    q = rng.standard_normal((1, sq, 4, d)).astype(np.float32)
    k = rng.standard_normal((1, sk, hk, d)).astype(np.float32)
    v = rng.standard_normal((1, sk, hk, d)).astype(np.float32)
    g = rng.standard_normal((1, sq, 4, d)).astype(np.float32)

    _, vjp = jax.vjp(lambda q, k, v: JFA._pallas_sdpa(q, k, v, causal),
                     *(jnp.asarray(x) for x in (q, k, v)))
    j_grads = [np.asarray(x) for x in vjp(jnp.asarray(g))]

    t = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    before = (TFA.flash_mha.fwd_launches, TFA.flash_mha.dq_launches,
              TFA.flash_mha.dkv_launches)
    TFA._pallas_sdpa(*t, causal).backward(torch.from_numpy(g))
    assert (TFA.flash_mha.fwd_launches, TFA.flash_mha.dq_launches,
            TFA.flash_mha.dkv_launches) == before   # CPU: plain versions
    for name, tx, jx in zip(("dq", "dk", "dv"), t, j_grads):
        assert tx.grad.shape == jx.shape, name
        np.testing.assert_allclose(tx.grad.numpy(), jx, atol=TOL, rtol=TOL,
                                   err_msg=name)
    if sq > sk and causal:
        np.testing.assert_array_equal(t[0].grad[:, :sq - sk].numpy(), 0.0)
        np.testing.assert_array_equal(j_grads[0][:, :sq - sk], 0.0)


def test_backward_entry_points_agree():
    """``_flash_bwd_xla`` is its dq and dk/dv halves, and the autograd
    Function hands the saved (q, k, v, out, lse) to it."""
    rng = np.random.default_rng(9)
    q, dout = (torch.from_numpy(rng.standard_normal((2, 4, 40, 32))
                                .astype(np.float32)) for _ in range(2))
    k, v = (torch.from_numpy(rng.standard_normal((2, 2, 50, 32))
                             .astype(np.float32)) for _ in range(2))
    out, lse = TFA._flash_fwd_xla(q, k, v, True, 0.2)
    dq, dk, dv = TFA._flash_bwd_xla(q, k, v, out, lse, dout, True, 0.2)
    torch.testing.assert_close(
        dq, TFA._flash_bwd_dq_xla(q, k, v, out, lse, dout, True, 0.2))
    tq, tk, tv = (x.clone().requires_grad_() for x in (q, k, v))
    TFA.flash_mha(tq, tk, tv, True, 0.2).backward(dout)
    for got, want in ((tq.grad, dq), (tk.grad, dk), (tv.grad, dv)):
        torch.testing.assert_close(got, want, rtol=0, atol=0)
