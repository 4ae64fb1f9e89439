"""paddle_tpu_torch masked flash attention (K8) gradients against the JAX
package's streamed long-sequence kernels (``_masked_fwd_stream``,
``_masked_bwd_stream``), forced on at S 256 with
``flash_attention._FORCE_STREAM``: the cases of
``test_torch_flash_mask_grad.py``, which holds the resident kernels, at
the same tolerances.  On the card one K8 kernel of each kind takes every
length, so both reference variants are held to the same port.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from paddle_tpu.ops.pallas import flash_attention as JFA
from paddle_tpu_torch.ops.pallas import flash_attention as TFA
from test_torch_flash_mask_grad import (CASES, GRAD_ATOL, _inputs,
                                        _jax_grads, _torch_grads, _vecs,
                                        check_masked_case, interpret_mode)


@pytest.fixture
def streamed():
    with interpret_mode(stream=True):
        yield


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_masked_grads_match_jax_stream_kernels(streamed, case):
    check_masked_case(case)


def test_key_padding_mask_is_differentiable(streamed):
    """The bool key-padding ``attn_mask`` route (the one serving's
    prefill takes) is the same Function: gradients as for its
    intervals."""
    q, k, v, g = _inputs(5, 2, 256, 256, 4, 2)
    keep = np.arange(256)[None] < np.array([[256], [120]])
    vecs = _vecs("pad", 2, 256, 256, (256, 120))
    _, j_grads = _jax_grads(
        lambda q, k, v: JFA._pallas_sdpa_masked(q, k, v, jnp.asarray(vecs),
                                                True), (q, k, v), g)
    mask = torch.from_numpy(keep)[:, None, None]
    _, t_grads = _torch_grads(
        lambda q, k, v: TFA.sdpa(q, k, v, attn_mask=mask, is_causal=True),
        (q, k, v), g)
    for got, want in zip(t_grads, j_grads):
        np.testing.assert_allclose(got, want, atol=GRAD_ATOL, rtol=0)
