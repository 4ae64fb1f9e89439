"""paddle_tpu_torch K8 backward with a bias gradient against the JAX
package's ``_masked_bwd`` (its ``_bwd_dq_kernel``, ``_bwd_dkv_kernel``
and ``_bwd_dbias_kernel``, Pallas in interpret mode), called directly on
the same out and lse, on the CPU.

Two broadcasts that the bf16 dbias kernel (``csrc/flash_sm90.cuh``)
sums in its own ways: a [1, 1, S, S] bias summed over both batch and
head (the f32 output is its own running sum), and a bf16 [1, H, S, S]
bias summed over the batch (the running sum in an f32 scratch, the
output rounded once).  The port's plain versions run here; the kernel is
held to them on the card (``tests/test_torch_cuda_kernels.py``).
Tolerances are the JAX package's (``tests/test_flash_mask.py``): 5e-4
absolute on the f32 gradients; a bf16 dbias within one bf16 rounding of
the reference's (both round the same f32 sum once).
"""
import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from paddle_tpu.ops.pallas import flash_mask as JFM
from paddle_tpu_torch.ops.pallas import flash_mask as TFM
from test_torch_flash_mask_grad import D, GRAD_ATOL

B, H, S = 2, 2, 256

CASES = [  # name, bias shape, bias dtype, causal
    ("bias_11_f32", (1, 1), torch.float32, True),
    ("bias_1H_bf16", (1, H), torch.bfloat16, False),
]


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_dbias_matches_jax_masked_bwd(case):
    name, (bb, hb), bdt, causal = case
    rng = np.random.RandomState(len(name))
    q, k, v = ((rng.randn(B, H, S, D) * 0.3).astype(np.float32)
               for _ in range(3))
    g = rng.randn(B, H, S, D).astype(np.float32)
    bias_t = torch.from_numpy((rng.randn(bb, hb, S, S) * 0.5)
                              .astype(np.float32)).to(bdt)
    tq, tk, tv, tg = (torch.from_numpy(a) for a in (q, k, v, g))
    scale = 1.0 / math.sqrt(D)
    out, lse = TFM._masked_fwd_xla(tq, tk, tv, None, bias_t, causal, scale)
    got = TFM._masked_bwd(tq, tk, tv, out, lse, tg, None, bias_t, causal,
                          scale, need_dbias=True)
    jbias = jnp.asarray(bias_t.float().numpy()).astype(
        jnp.bfloat16 if bdt == torch.bfloat16 else jnp.float32)
    want = JFM._masked_bwd(
        *(jnp.asarray(a) for a in (q, k, v, out.numpy(), lse.numpy(), g)),
        None, jbias, causal, scale, 128, 128, S, S, True, interpret=True)
    for what, x, y in zip(("dq", "dk", "dv"), got[:3], want[:3]):
        np.testing.assert_allclose(x.numpy(), np.asarray(y), atol=GRAD_ATOL,
                                   rtol=0, err_msg=what)
    dbias, ref = got[3], np.asarray(want[3].astype(jnp.float32))
    assert dbias.shape == (bb, hb, S, S) and dbias.dtype == bdt
    if bdt == torch.float32:
        np.testing.assert_allclose(dbias.numpy(), ref, atol=GRAD_ATOL,
                                   rtol=0)
    else:
        np.testing.assert_allclose(dbias.float().numpy(), ref,
                                   rtol=2 ** -7, atol=2 ** -12)
    # the broadcast sum: zero above the causal diagonal, some mass below
    assert np.abs(ref).max() > 1e-3
    if causal:
        assert not np.triu(dbias.float().numpy()[0, 0], 1).any()
