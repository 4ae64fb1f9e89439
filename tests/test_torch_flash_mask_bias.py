"""paddle_tpu_torch biased flash attention (K8 with a dense bias) against
the JAX package's Pallas kernels: out, dq, dk, dv and dbias.

The same numpy inputs (from a seed) go through the JAX
``_pallas_sdpa_biased`` — its ``flash_mha_biased`` custom_vjp, the
Pallas kernels in interpret mode: the resident kernels here, the
streamed long-sequence variants (whose dbias kernel reduces the
broadcast dims in-kernel) in ``test_torch_flash_mask_bias_stream.py`` —
and through the port's ``sdpa`` with the float ``attn_mask`` on CPU
tensors (the plain versions of the K8 kernels).  Tolerances are the JAX
package's own (``tests/test_flash_mask.py``): forward 3e-5 absolute,
gradients 5e-4 absolute, float32 throughout.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from paddle_tpu.ops.pallas import flash_attention as JFA
from paddle_tpu_torch.ops.pallas import flash_attention as TFA
from paddle_tpu_torch.ops.pallas import flash_mask as TFM
from test_torch_flash_mask_grad import (FWD_ATOL, GRAD_ATOL, _inputs,
                                        _jax_grads, _torch_grads,
                                        interpret_mode)

B, H, S = 2, 2, 256

# (name, bias batch, bias heads, q heads, kv heads, causal, bias grad)
CASES = [
    ("bias_1H", 1, H, H, H, True, True),
    ("bias_B1", B, 1, H, H, True, True),
    ("bias_11", 1, 1, H, H, True, True),
    ("bias_BH", B, H, H, H, False, True),
    ("no_bias_grad", 1, H, H, H, True, False),
    # a bias per kv head under GQA: repeated to q heads, its gradient
    # summed back through the repeat
    ("gqa_kv_heads", 1, 2, 4, 2, True, True),
    # query row 7 of every head has an all -inf bias row: zero output,
    # zero gradients (the XLA path would give NaN there)
    ("inf_row", 1, 1, H, H, False, True),
]


def check_bias_case(case, monkeypatch):
    name, bb, hb, h, kvh, causal, bias_grad = case
    q, k, v, g = _inputs(sum(map(ord, name)), B, S, S, h, kvh)
    bias = (np.random.RandomState(len(name)).randn(bb, hb, S, S)
            * 0.5).astype(np.float32)
    if name == "inf_row":
        bias[:, :, 7] = -np.inf
    dbias_calls = []
    real = TFM._masked_bwd_dbias_xla

    def spy(*args):
        dbias_calls.append(1)
        return real(*args)

    monkeypatch.setattr(TFM, "_masked_bwd_dbias_xla", spy)
    if bias_grad:
        arrays = (q, k, v, bias)
        j_fn = lambda q, k, v, b: JFA._pallas_sdpa_biased(  # noqa: E731
            q, k, v, b, causal)
        t_fn = lambda q, k, v, b: TFA.sdpa(  # noqa: E731
            q, k, v, attn_mask=b, is_causal=causal)
    else:
        arrays = (q, k, v)
        tb = torch.from_numpy(bias)
        j_fn = lambda q, k, v: JFA._pallas_sdpa_biased(  # noqa: E731
            q, k, v, jnp.asarray(bias), causal)
        t_fn = lambda q, k, v: TFA.sdpa(  # noqa: E731
            q, k, v, attn_mask=tb, is_causal=causal)
    j_out, j_grads = _jax_grads(j_fn, arrays, g)
    t_out, t_grads = _torch_grads(t_fn, arrays, g)
    np.testing.assert_allclose(t_out, j_out, atol=FWD_ATOL, rtol=0)
    for got, want, what in zip(t_grads, j_grads, ("dq", "dk", "dv",
                                                  "dbias")):
        assert got.shape == want.shape, what
        np.testing.assert_allclose(got, want, atol=GRAD_ATOL, rtol=0,
                                   err_msg=what)
    assert len(dbias_calls) == int(bias_grad)
    if name == "inf_row":
        assert np.all(t_out[:, 7] == 0) and np.all(t_grads[0][:, 7] == 0)
        assert np.all(t_grads[3][:, :, 7] == 0)


@pytest.fixture
def resident():
    with interpret_mode(stream=False):
        yield


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_biased_grads_match_jax_kernels(resident, case, monkeypatch):
    check_bias_case(case, monkeypatch)
